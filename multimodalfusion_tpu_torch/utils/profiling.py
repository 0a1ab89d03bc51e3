"""Tracing and stage timing (port of multimodalfusion_tpu/utils/profiling.py;
the reference has none).

``trace(dir, name)`` wraps a block in ``torch.profiler`` (CPU activity,
and CUDA's where a card is present) and writes its Chrome trace to
``{dir}/{name}.pt.trace.json``, which Perfetto and chrome://tracing open;
JAX writes an xplane trace for TensorBoard instead.  ``StageTimer``
collects named wall-clock stages and dumps them as JSON with the JAX
package's keys.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace"):
    """A ``torch.profiler`` trace of the block into ``log_dir``; no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


class StageTimer:
    """Named wall-clock stage timing with JSON export."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "calls": self.counts[k],
                    "mean_s": round(v / self.counts[k], 4)}
                for k, v in self.totals.items()}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
        return path


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every visible card, by device name
    (``cuda:0``, ...); empty without a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
