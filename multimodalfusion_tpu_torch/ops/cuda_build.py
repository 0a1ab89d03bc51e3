"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc into shared
libraries with a plain C interface, and load them with ctypes.

Each source is compiled at its first use for ``sm_90a`` into
``<checkout>/build/kernels/<name>-<hash>.so``, where the hash covers the
source, the headers of ``csrc/`` and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time, "ptxas": its resource report};
# empty for a library that was found already built
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: the "
        "CUDA kernels of multimodalfusion_tpu_torch cannot be built")


def _digest(src: str) -> str:
    """Hash of the flags, the source and every header (``*.cuh``) beside
    it, which the sources include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    folder = os.path.dirname(src)
    headers = sorted(f for f in os.listdir(folder) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(folder, f) for f in headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def build(name: str) -> str:
    """Path of the built ``csrc/<name>.cu`` library, compiling it first
    when no build of these exact sources and headers exists."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"{name}-{_digest(src)}.so")
    if os.path.exists(so):
        return so
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": proc.stderr}
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
