"""The ranks of the port's multi-process tests (tests/test_torch_dist*.py).

``spawn`` starts k processes that join one gloo group through a file in
the test's directory (no ports) and each run a function of this module.
``mp.spawn``-style pickling sends a function by its import path, so this
module imports neither JAX nor any test module: a child imports it and
the port alone.  Inputs come from files the test wrote (``.npz`` for
arrays, ``torch.save`` for state_dicts and batches, JSON for cases) and
results go back the same way.  Each rank runs on one thread, the group
and the join have timeouts, and a failed rank's traceback is written to
``error_{rank}.txt`` and raised by ``spawn``.
"""
from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from multimodalfusion_tpu_torch.data.loaders import iter_batches
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.models.modules import Dropout
from multimodalfusion_tpu_torch.ops import mil_attention as mil
from multimodalfusion_tpu_torch.parallel import mesh as par

ATTN_FIELDS = ("Wa", "ba", "Wb", "bb", "wc", "cc")


def _entry(fn_name, rank, world, work, env):
    torch.set_num_threads(1)
    os.environ.update(env)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        globals()[fn_name](rank, world, work)
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn_name: str, world: int, work: str, timeout: float = 180.0,
          torchrun_env: bool = False) -> None:
    """Run ``fn_name(rank, world, work)`` of this module in ``world``
    processes over gloo; raise if a rank fails or the join times out.
    ``torchrun_env``: each rank also gets torchrun's RANK, WORLD_SIZE and
    LOCAL_RANK."""
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(world):
        env = ({"RANK": str(r), "WORLD_SIZE": str(world),
                "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world)}
               if torchrun_env else {})
        procs.append(ctx.Process(target=_entry,
                                 args=(fn_name, r, world, work, env)))
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(work, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise RuntimeError(f"{fn_name} on {world} ranks: hung {hung}, exit "
                           f"codes {codes}\n" + "\n".join(errors))


# ---------------------------------------------------------------------------
# the sharded pooling
# ---------------------------------------------------------------------------

def _instances(v: np.ndarray, lo: int, hi: int) -> torch.Tensor:
    """Instances [lo, hi) of a bag array's second axis, zeros (masked
    rows) past its end."""
    out = np.zeros(v.shape[:1] + (hi - lo,) + v.shape[2:], v.dtype)
    stop = min(hi, v.shape[1])
    out[:, :max(0, stop - lo)] = v[:, lo:stop]
    return torch.from_numpy(out)


def pool_cases(rank, world, work):
    """Each case of ``pool_cases.json``: this rank's block of the bag
    pooled over the world group by ``attention_pool`` (or
    ``attention_pool_dropout``) and backpropagated from the case's
    cotangent; writes out, the block's dh and the parameter gradients."""
    with open(os.path.join(work, "pool_cases.json")) as f:
        cases = json.load(f)
    for name, gated, dropout in cases:
        x = np.load(os.path.join(work, f"{name}.npz"))
        lo, hi = par.block(x["h"].shape[1], world, rank)
        h = _instances(x["h"], lo, hi).requires_grad_()
        mask = _instances(x["mask"], lo, hi)
        params = mil.AttnParams(*(torch.from_numpy(x[k]).requires_grad_()
                                  for k in ATTN_FIELDS))
        group = dist.group.WORLD
        if dropout:
            da, db = (_instances(x[k], lo, hi) for k in ("da", "db"))
            out = mil.attention_pool_dropout(h, mask, da, db, params, gated,
                                             group=group)
        else:
            out = mil.attention_pool(h, mask, params, gated, group=group)
        out.backward(torch.from_numpy(x["g"]))
        grads = {f"d{k}": (np.zeros_like(x[k]) if p.grad is None
                           else p.grad.numpy())
                 for k, p in zip(ATTN_FIELDS, params)}
        np.savez(os.path.join(work, f"{name}_rank{rank}.npz"),
                 out=out.detach().numpy(), dh=h.grad.numpy(), lo=lo, hi=hi,
                 **grads)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

class MemoryView:
    """A cohort held in memory, as the loader reads a ``SurvivalDataset``
    or a ``Split``: ``Sample``s in order, every modality present."""

    def __init__(self, mode: str, samples, modalities=(),
                 pretrained: bool = False, genomic_cols=()):
        self.mode, self.samples = mode, list(samples)
        self.modalities, self.pretrained = tuple(modalities), pretrained
        self.genomic_cols = list(genomic_cols)

    def __len__(self):
        return len(self.samples)

    def probe_present(self, i):
        return self.samples[i].present

    def get_sample(self, i):
        return self.samples[i]


def _layout(kind: str, bag_devices: int):
    if kind == "bag":
        return par.make_bag_mesh()
    if kind == "data":
        return par.make_mesh()
    return par.make_dp_bag_mesh(bag_devices)


def run_steps(case: dict, view, init, mesh=None, kind=None) -> tuple:
    """The case's train steps from ``init`` on this rank, one per batch of
    the loader over ``view`` (in order, this rank's rows when ``mesh`` is
    given), dropout drawn from a CPU generator seeded with
    ``case["seed"]``; without ``case["dropout"]`` every dropout rate is 0.
    Returns (losses, state_dict, the gradients that each step applied)."""
    cfg = ttrain.TrainConfig(device="cpu", **case["cfg"])
    model = ttrain.build_model(cfg, None,
                               mesh if kind in ("bag", "2d") else None)
    model.load_state_dict(init)
    if not case["dropout"]:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    opt = ttrain.make_optimizer(cfg, model.parameters())
    step, _ = ttrain.make_steps(cfg, model, opt, torch.device("cpu"),
                                mesh=mesh)
    gen = torch.Generator().manual_seed(case["seed"])
    losses, grads = [], []
    for b in iter_batches(view, batch_size=cfg.batch_size, mesh=mesh):
        losses.append(float(step(b, gen)["loss"]))
        grads.append({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
    return losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()}, grads


def train_cases(rank, world, work):
    """Each case of ``train_cases.json`` (its view and init in
    ``{name}.pt``) run on its layout; every rank writes its losses,
    state_dict and gradients."""
    with open(os.path.join(work, "train_cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        data = torch.load(os.path.join(work, f"{case['name']}.pt"),
                          weights_only=False)
        mesh = _layout(case["layout"], case.get("bag_devices", world))
        losses, state, grads = run_steps(case, data["view"], data["init"],
                                         mesh, case["layout"])
        torch.save({"losses": losses, "state": state, "grads": grads},
                   os.path.join(work, f"{case['name']}_rank{rank}.pt"))


# ---------------------------------------------------------------------------
# the CLIs under a torchrun-like environment
# ---------------------------------------------------------------------------

def cli_runs(rank, world, work):
    """Each argv of ``cli_runs.json`` through its CLI's ``main``; writes
    the return codes."""
    from multimodalfusion_tpu_torch.cli import (extract_features_fp,
                                                feature_extraction, main,
                                                main_pretrained)
    mains = {"main": main.main, "main_pretrained": main_pretrained.main,
             "feature_extraction": feature_extraction.main,
             "extract_features_fp": extract_features_fp.main}
    with open(os.path.join(work, "cli_runs.json")) as f:
        runs = json.load(f)
    rcs = [mains[cli](argv) for cli, argv in runs]
    with open(os.path.join(work, f"rcs_rank{rank}.json"), "w") as f:
        json.dump(rcs, f)
