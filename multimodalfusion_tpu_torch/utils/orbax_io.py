"""Resume bundles for ``--ckpt_format orbax`` on
``torch.distributed.checkpoint`` (DCP), in place of the JAX package's
orbax (multimodalfusion_tpu/utils/orbax_io.py; the machine with the card
has no orbax).  The flag keeps its name, so JAX command lines run
unchanged; the bundle is a DCP directory, ``s_{k}_resume.dcp``.

A bundle is a flat dict of tensors (``engine/train.resume_state``).
``save_tree`` is called by every rank of the process group: DCP's planner
gives each tensor to one rank, which writes it into its own file, so
nothing is gathered on one host.  The directory is written beside its
target (``{path}.tmp``) and swapped in once complete, so a kill during a
write leaves the previous bundle (``{path}.old`` for the instant of the
swap).  ``restore_tree`` reads it on the host, the tensors' shapes and
types taken from the directory's own metadata.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from multimodalfusion_tpu_torch.parallel import mesh as par


def _complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, ".metadata"))


def _latest(path: str) -> Optional[str]:
    """The bundle to read: ``path``, or the ``.old`` one a kill during
    the swap left behind."""
    for p in (path, path + ".old"):
        if _complete(p):
            return p
    return None


def exists(path: str) -> bool:
    """True when ``path`` (or its ``.old`` twin) holds a complete DCP
    directory; one left half-written reads as absent."""
    return _latest(path) is not None


def save_tree(path: str, tree: Dict[str, torch.Tensor]) -> None:
    """Write the flat dict ``tree`` as a DCP directory at ``path``.  Under
    torch.distributed every rank calls it with the same keys.  DCP's own
    collectives order the ranks, so no barrier is added: no rank writes
    before rank 0 has planned the save, and the save returns on every rank
    once all files and the metadata are written.  Files of a write killed
    half-way are overwritten in place."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    tmp = path + ".tmp"
    dcp.save(tree, checkpoint_id=tmp, no_dist=not dist.is_initialized())
    if par.rank() == 0:
        old = path + ".old"
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)


def restore_tree(path: str) -> Dict[str, torch.Tensor]:
    """The flat dict saved by ``save_tree``, as tensors on the CPU."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    src = _latest(path)
    if src is None:
        raise FileNotFoundError(f"no complete DCP bundle at {path}")
    meta = dcp.FileSystemReader(src).read_metadata().state_dict_metadata
    tree = {k: torch.empty(m.size, dtype=m.properties.dtype)
            for k, m in meta.items()}
    dcp.load(tree, checkpoint_id=src, no_dist=not dist.is_initialized())
    return tree
