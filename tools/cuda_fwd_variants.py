"""Where the bf16 forward kernel of the CUDA port spends its time.

Builds variants of ``multimodalfusion_tpu_torch/csrc/mil_pool_fwd.cu``,
each the tree's source with one part of the bf16 partial kernel's work
taken out by a text substitution (the tensor-core products, the SFU's
tanh, the bytes its copies read, the pooling) or one of its choices
undone (tanhf, an integer division), checks each against the plain
version and times them in turns on one card (B=32, N=4096, D=Da=256,
gated, 90% valid rows; CUDA events over 50 launches, four turns, then
torch.profiler's device time of the partial kernel).

    python3 tools/cuda_fwd_variants.py [VARIANT,...] [--parent FILE]

VARIANT is any of the names in ``VARIANTS`` (default: all); ``--parent``
adds another version of the source (for example ``git show
HEAD~1:multimodalfusion_tpu_torch/csrc/mil_pool_fwd.cu``) with its bf16
tile height given as ``FILE:ROWS``.  A variant that takes work out gives
wrong results by design: its error is printed, not checked.  Needs a card
and nvcc; the libraries go to ``build/variants/``.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("mil_pool_fwd.cu", "mma_core.cuh", "sgemm_core.cuh")

# name -> {file: [(old, new), ...]}; "tree" is the source as it is
VARIANTS = {
    "tree": {},
    "no_products": {"mma_core.cuh": [(
        "mma_chunk<true, true>(A + a_k(c), buf, acc, lda);", "(void)buf;")]},
    "no_tanh": {"mil_pool_fwd.cu": [(
        'asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")]},
    "no_weight_bytes": {"mil_pool_fwd.cu": [(
        "        const bool in = col < Da;\n",
        "        const bool in = false;\n")]},
    "no_h_bytes": {"mil_pool_fwd.cu": [(
        "      return i < rows ? ht + (size_t)i * D : nullptr;",
        "      return nullptr;")]},
    "no_pooling": {"mil_pool_fwd.cu": [(
        "for (int r = gi; r < rows; r += G) {",
        "for (int r = gi; r < 0; r += G) {")]},
    # two of the design's choices undone: the accurate tanhf for
    # tanh.approx, and an integer division for the chunk counters' multiply
    "tanhf": {"mil_pool_fwd.cu": [(
        'asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "y = tanhf(x);")]},
    "int_division": {"mil_pool_fwd.cu": [(
        "return (int)((c * kd_magic) >> 20);", "return c / kd;")]},
}
VARIANTS["no_products_no_bytes"] = {
    "mma_core.cuh": VARIANTS["no_products"]["mma_core.cuh"],
    "mil_pool_fwd.cu": (VARIANTS["no_weight_bytes"]["mil_pool_fwd.cu"]
                        + VARIANTS["no_h_bytes"]["mil_pool_fwd.cu"])}


def build(name, sources, out_dir, flags, nvcc):
    """nvcc of one variant's source tree; prints the bf16 partial
    kernel's registers and spills.  Returns the library's path."""
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for f, text in sources.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    so = os.path.join(d, "lib.so")
    p = subprocess.run([nvcc, *flags, "-o", so,
                        os.path.join(d, "mil_pool_fwd.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{p.stderr}")
    lines = p.stderr.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"pool_partial_bf16_kernelILb(\d)ELb(\d)", line)
        if m and "Compiling" in line:
            print(f"[variants] {name} gated={m[1]} dropout={m[2]}: "
                  + " | ".join(x.strip() for x in lines[i + 2:i + 4]),
                  flush=True)
    return so


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="?", default=",".join(VARIANTS))
    ap.add_argument("--parent", help="FILE:ROWS, another mil_pool_fwd.cu "
                                     "and its bf16 tile rows")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cuda_fwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from multimodalfusion_tpu_torch.ops import cuda_build
    from multimodalfusion_tpu_torch.ops import mil_attention as mil

    tree = {}
    for f in FILES:
        with open(os.path.join(cuda_build.CSRC_DIR, f)) as fh:
            tree[f] = fh.read()
    plans, rows = {}, {}
    for name in args.variants.split(","):
        sources = dict(tree)
        for f, subs in VARIANTS[name].items():
            for old, new in subs:
                if old not in sources[f]:
                    raise ValueError(f"variant {name}: {old!r} is not in {f}")
                sources[f] = sources[f].replace(old, new)
        plans[name], rows[name] = sources, mil._TILE_ROWS[torch.bfloat16]
    if args.parent:
        path, tile = args.parent.rsplit(":", 1)
        with open(path) as fh:
            plans["parent"] = dict(tree, **{"mil_pool_fwd.cu": fh.read()})
        rows["parent"] = int(tile)
    out_dir = os.path.join(REPO, "build", "variants")
    nvcc = cuda_build.nvcc_path()
    with ThreadPoolExecutor(len(plans)) as ex:
        libs = dict(zip(plans, ex.map(
            lambda kv: build(kv[0], kv[1], out_dir, cuda_build.NVCC_FLAGS,
                             nvcc), plans.items())))

    def use(name):
        lib = ctypes.CDLL(libs[name])
        lib.mil_pool_fwd.argtypes = ([ctypes.c_void_p] * 14
                                     + [ctypes.c_float] + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
        lib.mil_pool_fwd.restype = ctypes.c_int
        lib.mil_pool_fwd_ctas_per_sm.argtypes = [ctypes.c_int] * 4
        mil._fwd_lib = lambda: lib
        mil._fwd_ctas_per_sm.cache_clear()
        mil._TILE_ROWS[torch.bfloat16] = rows[name]

    B, N, D, Da = 32, 4096, 256, 256
    h, mask, params = cs.make_pool_case(B, N, D, Da, "bfloat16", seed=123)
    gen = torch.Generator(device="cuda").manual_seed(5)
    masks = mil.make_dropout_masks(gen, (B, N, Da), True)
    arms = {False: (None, None), True: masks}
    names = list(plans)
    times = {n: {d: [] for d in arms} for n in names}
    with torch.no_grad():
        ref = {d: mil._pool_plain(h, mask, params, True, *m)
               for d, m in arms.items()}
        for name in names:
            use(name)
            for drop, (da, db) in arms.items():
                out, ml = mil._fused_pool_cuda(h, mask, params, True, da, db)
                torch.cuda.synchronize()
                err = max(cs.rel_err(out, ref[drop][0]),
                          cs.rel_err(ml[:, 1], ref[drop][1][:, 1]))
                print(f"[variants] {name} dropout={drop}: rel err "
                      f"{err:.2e}", flush=True)
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                use(name)
                for drop, (da, db) in arms.items():
                    times[name][drop].append(cs._time_ms(
                        lambda: mil._fused_pool_cuda(h, mask, params, True,
                                                     da, db), iters=50))
        for name in names:
            use(name)
            us = {}
            for drop, (da, db) in arms.items():
                per_kernel, _ = cs._device_time(
                    lambda: mil._fused_pool_cuda(h, mask, params, True, da,
                                                 db), reps=10)
                us[drop] = per_kernel.get("pool_partial_bf16_kernel", -1.0)
            print(f"[variants] {name}: ms " + " ".join(
                f"{t:.4f}" for t in times[name][False]) + " | dropout "
                + " ".join(f"{t:.4f}" for t in times[name][True])
                + f" | partial kernel {us[False]:.1f} / {us[True]:.1f} us",
                flush=True)
    print(f"[variants] card: {cs._card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
