"""Process groups and per-rank batch rows for data-parallel and
bag-sharded training and extraction (port of
multimodalfusion_tpu/parallel/mesh.py).

The JAX package runs one process over every device: a ``jax.sharding.Mesh``
names the axes, and ``device_put`` with a ``PartitionSpec`` places each
array's blocks on the devices.  The port runs one process per GPU, started
by ``torchrun``, and each process holds only its own block:

- a ``Mesh`` is this rank's place in the layout: the size of each axis
  ("data", "bag"), its index along each, and the process group of the
  ranks that share its other coordinates;
- the loader (``data/loaders.py``) loads and collates only this rank's
  rows of each global batch, as ``P("data")``, ``P(None, "bag")`` and
  ``P("data", "bag")`` split it (JAX ``shard_batch``,
  ``shard_batch_bags``, ``shard_batch_dp_bags`` and
  ``pad_batch_to_devices``: ``block`` here), and records where they sit
  in the global batch (``rows``, ``{kind}_rows``; a ``Shard`` in the
  step);
- ``draw`` draws only this rank's block of a random draw of the global
  batch, with the bits of the one-process draw, so dropout does not
  depend on the layout, as JAX's one key for the global batch;
- ``gather_rows`` and ``all_reduce_sum`` are the collectives with their
  backward that a loss of the global batch and statistics over it need.

Data parallelism reduces the gradients by hand (``sum_gradients``), once a
step: each rank backpropagates the global loss through its own rows only,
so the sum over the data group is the gradient of the global step.

``init_distributed`` reads torchrun's environment: NCCL with rank r on
``cuda:LOCAL_RANK``, gloo for ``--device cpu``.  Ranks never share a GPU.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BAG_AXIS = "bag"


# ---------------------------------------------------------------------------
# start-up
# ---------------------------------------------------------------------------

def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def launch_world_size() -> int:
    """The world size of this launch, before the process group exists:
    torchrun's ``WORLD_SIZE`` (1 without torchrun)."""
    if is_distributed():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: str) -> Tuple[str, bool]:
    """Join the process group that torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``) describes: NCCL for a ``cuda`` device,
    with rank r on ``cuda:LOCAL_RANK``, gloo for the CPU.  A group that the
    caller already made is kept.  Without torchrun's environment the run is
    one process: on a machine with more than one visible GPU that raises
    and says how to launch; otherwise it runs at world size 1.

    Returns (the device this rank runs on, whether this call made the
    group)."""
    dev = torch.device(device)
    env = os.environ
    if "WORLD_SIZE" not in env and not is_distributed():
        n = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n > 1:
            raise RuntimeError(
                f"{n} GPUs are visible but this is one process: launch one "
                f"process per GPU with torchrun, e.g. torchrun "
                f"--nproc_per_node={n} -m multimodalfusion_tpu_torch.cli."
                f"main --data_parallel ...")
        return device, False
    local = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device cpu to run the ranks "
                "on the CPU over gloo")
        if dev.index is not None and launch_world_size() > 1:
            raise ValueError(
                f"--device {device}: under torchrun rank r runs on "
                f"cuda:LOCAL_RANK; pass --device cuda")
        n = torch.cuda.device_count()
        local_world = int(env.get("LOCAL_WORLD_SIZE",
                                  env.get("WORLD_SIZE", "1")))
        if max(local, local_world - 1) >= n:
            raise RuntimeError(
                f"{local_world} ranks on this node but {n} visible GPU(s): "
                f"ranks never share a GPU; start at most {n} with "
                f"torchrun --nproc_per_node={n}")
        device = f"cuda:{local}"
        torch.cuda.set_device(local)
    if is_distributed():
        return device, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method="env://", rank=int(env["RANK"]),
        world_size=int(env["WORLD_SIZE"]))
    # one collective, so a group that cannot communicate fails here
    dist.barrier(device_ids=[local] if backend == "nccl" else None)
    if dist.get_rank() == 0:
        print(f"torch.distributed: {dist.get_world_size()} rank(s) over "
              f"{backend}, rank 0 on {device}")
    return device, True


@contextlib.contextmanager
def distributed(device: str, enabled: bool = True):
    """``init_distributed`` for the length of a run, the group destroyed
    after it when the run made it.  Yields this rank's device (``device``
    itself when not ``enabled``)."""
    if not enabled:
        yield device
        return
    device, made = init_distributed(device)
    try:
        yield device
    finally:
        if made:
            dist.destroy_process_group()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def quiet_unless_rank0():
    """A context in which ranks other than 0 print nothing to stdout."""
    if rank() == 0:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


# ---------------------------------------------------------------------------
# meshes: this rank's place in a 1-D or 2-D layout of the ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a layout of all ranks: per axis its size, this
    rank's index along it and the process group of the ranks that differ
    from this one only along it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Any, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The group along ``axis``; None when the mesh has no such axis
        or it holds one rank."""
        if axis not in self.axis_names or self.shape[axis] < 2:
            return None
        return self.groups[self.axis_names.index(axis)]


def _line(axis: str) -> Mesh:
    n = world_size()
    return Mesh((axis,), (n,), (rank(),),
                (dist.group.WORLD if n > 1 else None,))


def make_mesh() -> Mesh:
    """1-D "data" mesh over every rank (JAX ``make_mesh``)."""
    return _line(DATA_AXIS)


def make_bag_mesh() -> Mesh:
    """1-D mesh over the bag (instance) axis for the sharded attention
    pooling (ops/sharded_pool.py; cfg.bag_shard)."""
    return _line(BAG_AXIS)


def make_dp_bag_mesh(bag_devices: int) -> Mesh:
    """2-D ("data", "bag") mesh: ranks laid out as
    ``arange(n).reshape(n // bag_devices, bag_devices)``, the batch split
    over the rows and bag instances over the columns.  Every rank makes
    every group, in one order, as ``new_group`` requires."""
    n = world_size()
    if n % bag_devices:
        raise ValueError(f"{n} devices not divisible by bag_devices="
                         f"{bag_devices}")
    rows, r = n // bag_devices, rank()
    bag_group = data_group = None
    for d in range(rows):
        g = dist.new_group([d * bag_devices + j for j in range(bag_devices)])
        if r // bag_devices == d:
            bag_group = g
    for j in range(bag_devices):
        g = dist.new_group([d * bag_devices + j for d in range(rows)])
        if r % bag_devices == j:
            data_group = g
    return Mesh((DATA_AXIS, BAG_AXIS), (rows, bag_devices),
                (r // bag_devices, r % bag_devices), (data_group, bag_group))


# ---------------------------------------------------------------------------
# this rank's rows of a batch
# ---------------------------------------------------------------------------

def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block ``index`` when ``n`` rows, padded up to a
    multiple of ``parts``, are split into ``parts`` contiguous blocks (the
    loader's cut of a batch, ``data/loaders.py``)."""
    size = -(-n // parts)
    return index * size, (index + 1) * size


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a global batch: rows [b0, b1) of ``batch``
    (the loader's batch size; rows past it are padding), per bag kind the
    instance rows [i0, i1) of a bag axis of N instances, and the group of
    the ranks that hold the batch's other rows (None when one does)."""
    rows: Tuple[int, int, int]
    bags: Dict[str, Tuple[int, int, int]]
    data_group: Any = None


_SHARD: contextvars.ContextVar = contextvars.ContextVar("shard",
                                                        default=None)
_KIND: contextvars.ContextVar = contextvars.ContextVar("bag_kind",
                                                       default=None)


@contextlib.contextmanager
def _setting(var: contextvars.ContextVar, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def local_rows(shard: Optional[Shard]):
    """While the context lasts, ``draw`` and ``MaskedBatchNorm`` see
    ``shard`` (nothing changes when it is None)."""
    return _setting(_SHARD, shard)


def bag_axis(kind: str):
    """While the context lasts, draws of [rows, n, ...] (or of the
    flattened [rows * n, ...]) are over the instances of the ``kind``
    bags."""
    return _setting(_KIND, kind)


def active_data_group():
    """The data group of the shard being run, or None."""
    shard = _SHARD.get()
    return None if shard is None else shard.data_group


# ---------------------------------------------------------------------------
# random draws of the global batch
# ---------------------------------------------------------------------------

# rows of a draw's [rows, ...] layout that one key covers: a rank draws
# the slabs that hold its rows, so it holds one slab beyond its block
DRAW_SLAB = 8192
_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer, to 63 bits (a seed for a slab's
    generator)."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


def _key(generator: Optional[torch.Generator]) -> int:
    """A key read from ``generator`` on the host, advancing it: a draw
    from a CPU generator (the default one when None); for a CUDA
    generator its Philox (seed, offset), the offset then stepped past (no
    launch, no wait for the card)."""
    if generator is not None and generator.device.type != "cpu":
        seed, offset = generator.initial_seed(), generator.get_offset()
        generator.set_offset(offset + 4)
        return _mix(seed * 0x9E3779B97F4A7C15 + offset)
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


def draw(fn: Callable[[tuple, torch.Generator], Any], shape: Sequence[int],
         generator: Optional[torch.Generator], device):
    """A draw of ``shape`` by ``fn(shape, g)`` (a tensor or a tuple of
    tensors drawn with the generator ``g`` on ``device``) whose bits do
    not depend on the layout, as JAX's one key for the global batch.

    The global draw is laid out as [rows, ...]: a row is a sample, or,
    inside ``bag_axis(kind)``, an instance (b, i) of the kind's bags at
    row b * N + i, the draw being [B, N, ...] or the flattened [B * N,
    ...].  A global draw of at most ``DRAW_SLAB`` rows is one draw with
    ``generator`` itself; a larger one is drawn in slabs, slab s (rows
    [s, s + 1) * ``DRAW_SLAB``) with its own generator, seeded from one
    key of ``generator`` and s.  Inside ``local_rows`` the result is this
    rank's block of the global draw (rows past the global batch or bag
    zeros) and only the slabs that hold its rows are drawn, one at a
    time."""
    shape = tuple(int(s) for s in shape)
    kind = _KIND.get()
    lead = 2 if kind is not None and len(shape) >= 3 else 1
    rest = shape[lead:]
    shard = _SHARD.get()
    if shard is None:
        total = math.prod(shape[:lead])
        spans = [(0, total, 0)]
    else:
        b0, b1, B = shard.rows
        nb = b1 - b0
        if kind is None:
            if shape[0] != nb:
                raise ValueError(f"a draw of shape {shape} does not have "
                                 f"this shard's {nb} rows")
            total = B
            spans = [(b0, min(b1, B), 0)] if b0 < B else []
        else:
            if kind not in shard.bags:
                raise ValueError(f"no instance rows of the {kind} bags in "
                                 f"this shard: {sorted(shard.bags)}")
            i0, i1, N = shard.bags[kind]
            n = i1 - i0
            if shape[:lead] not in ((nb, n), (nb * n,)):
                raise ValueError(f"a draw of shape {shape} over the {kind} "
                                 f"bags is neither [{nb}, {n}, ...] nor "
                                 f"[{nb * n}, ...]")
            total = B * N
            spans = [(b * N + i0, b * N + min(i1, N), (b - b0) * n)
                     for b in range(b0, min(b1, B)) if i0 < N]
    key = _key(generator) if total > DRAW_SLAB else None

    def slab(s: int, slab_shape):
        g = generator
        if key is not None:
            g = torch.Generator(device=device)
            g.manual_seed(_mix(key ^ (s * 0x9E3779B97F4A7C15)))
        got = fn(slab_shape, g)
        return got if isinstance(got, tuple) else (got,)

    if shard is None and total <= DRAW_SLAB:
        got = slab(0, shape)
        return got if len(got) > 1 else got[0]
    outs, drawn, cur = None, -1, None
    if key is None:
        # one draw on the generator itself, made even by a rank of padding
        # rows only, so that every rank's generator advances alike
        cur, drawn = slab(0, (total,) + rest), 0
        outs = [t.new_zeros((math.prod(shape[:lead]),) + rest)
                for t in cur]
    for lo, hi, dst in spans:
        pos = lo
        while pos < hi:
            s = pos // DRAW_SLAB
            start = s * DRAW_SLAB
            if s != drawn:
                cur = slab(s, (min(start + DRAW_SLAB, total) - start,)
                           + rest)
                drawn = s
            if outs is None:
                outs = [t.new_zeros((math.prod(shape[:lead]),) + rest)
                        for t in cur]
            take = min(hi, start + DRAW_SLAB) - pos
            at = dst + pos - lo
            for o, t in zip(outs, cur):
                o[at:at + take] = t[pos - start:pos - start + take]
            pos += take
    if outs is None:  # this rank holds padding rows only
        outs = [t.new_zeros((math.prod(shape[:lead]),) + rest)
                for t in slab(0, (0,) + rest)]
    outs = tuple(o.reshape(shape) for o in outs)
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# collectives with their backward
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """Concatenation of every rank's rows, in rank order.  Every rank
    computes the same global loss from the result, and its backward
    keeps this rank's rows of that one gradient: no sum, so the gradient
    is not scaled by the group's size, as a backward that sums would
    scale it (``torch.distributed.nn.functional.all_gather``'s)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.lo = dist.get_rank(group) * x.shape[0]
        ctx.n = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of x along the first axis, in rank order
    (differentiable, see ``_GatherRows``)."""
    return _GatherRows.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group.  The global loss depends on the sum through
    every rank's rows, and each rank backpropagates through its own: the
    gradient of the sum is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_reduce_max(values: Sequence[int], group, device) -> list:
    """Element-wise maximum of a list of ints over the group."""
    t = torch.tensor(list(values), dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.tolist()]


def sum_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over the group, in one collective
    (a missing gradient is the same on every rank: the ranks run one
    graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
