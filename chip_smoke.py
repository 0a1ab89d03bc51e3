"""GPU smoke test of the PyTorch port (multimodalfusion_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- nvcc-build every CUDA kernel of the serving path from
                multimodalfusion_tpu_torch/csrc, in parallel.
  2. kernels -- hold each kernel against its plain PyTorch version on the
                card: gated/ungated x f32/bf16, ragged masks with a fully
                masked bag and a padding row, both published PathAMIL
                widths, and one N=32,768 bag.  f32 at rel 1e-4, bf16 at
                rel 2e-2 (pooled and ml).
  3. slice   -- write a synthetic stage-2 pathology experiment at full
                PathAMIL width and serve it through cli.infer on the card,
                with every kernel launch counter reset just before and
                read just after; the risks must match the same model run
                through the plain pooling on the card.
  4. timing  -- kernel vs plain version at the serving shapes, beside the
                bound (bytes or operations over the card's peak).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL = {
    "name": "mil_pool_fwd",
    "route": "cuda",
    "source": "multimodalfusion_tpu_torch/csrc/mil_pool_fwd.cu",
    "replaces": "multimodalfusion_tpu/ops/mil_attention.py:171",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    import torch
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def make_pool_case(B, N, D, Da, dtype, seed, lens=None):
    """Random bags [B, N, D] (on the card), a ragged mask and AttnParams."""
    import torch
    from multimodalfusion_tpu_torch.ops.mil_attention import AttnParams
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    h = torch.randn(B, N, D, generator=g, device=dev)
    if lens is None:
        mask = (torch.rand(B, N, generator=g, device=dev) < 0.9).float()
    else:
        mask = (torch.arange(N, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None]).float()
    p = [torch.randn(*s, generator=g, device=dev) * 0.1
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,))]
    return h.to(getattr(torch, dtype)), mask, AttnParams(*p)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from multimodalfusion_tpu_torch.ops import cuda_build
    names = sorted(os.path.splitext(f)[0]
                   for f in os.listdir(cuda_build.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:  # one nvcc per source
        for name, so in zip(names, ex.map(cuda_build.build, names)):
            info = cuda_build.build_info.get(name, {})
            log(f"[build] {name} -> {os.path.relpath(so, REPO)} "
                f"({info.get('seconds', 0.0):.1f} s)")
            for line in info.get("ptxas", "").splitlines():
                if any(k in line for k in ("entry function", "registers",
                                           "spill")):
                    log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    cases = []
    for dtype in ("float32", "bfloat16"):
        for gated in (True, False):
            # ragged lengths: a fully masked bag (0), a padding row (zero
            # bag, zero mask), one bag ending mid-tile, one full
            cases.append(("ragged", 6, 1000, 256, 256, dtype, gated,
                          [1000, 0, 517, 33, 999, 0]))
            cases.append(("big", 4, 700, 512, 384, dtype, gated, None))
        cases.append(("serving", 32, 4096, 256, 256, dtype, True, None))
        cases.append(("bigbag", 2, 32768, 256, 256, dtype, True,
                      [32768, 20001]))
    worst = 0.0
    for i, (tag, B, N, D, Da, dtype, gated, lens) in enumerate(cases):
        h, mask, params = make_pool_case(B, N, D, Da, dtype, seed=i,
                                         lens=lens)
        if tag == "ragged":
            h[5] = 0  # the padding row of a partial batch
        with torch.no_grad():
            out, ml = mil._fused_pool_cuda(h, mask, params, gated)
            ref, ref_ml = mil._pool_plain(h, mask, params, gated)
        torch.cuda.synchronize()
        e_out = rel_err(out, ref)
        live = ref_ml[:, 1] > 0
        e_m = rel_err(ml[live, 0], ref_ml[live, 0]) if live.any() else 0.0
        e_l = rel_err(ml[:, 1], ref_ml[:, 1])
        ok = (torch.isfinite(out).all().item() and
              max(e_out, e_m, e_l) <= TOL[dtype])
        if lens is not None:
            empty = torch.tensor([n == 0 for n in lens], device="cuda")
            ok = ok and bool((out[empty] == 0).all()) and \
                bool((ml[empty, 1] == 0).all())
        worst = max(worst, float((out - ref).abs().max()))
        log(f"[kernels] {tag:8s} B={B} N={N} D={D} Da={Da} {dtype:8s} "
            f"gated={gated!s:5s} rel(pooled)={e_out:.2e} rel(m)={e_m:.2e} "
            f"rel(l)={e_l:.2e} tol={TOL[dtype]:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"on case {tag} {dtype} gated={gated}")
    return worst


def _write_experiment(root, n_subjects=34, seed=0):
    """Synthetic stage-2 path experiment at full PathAMIL width: bags of
    1,000-2,048 instances x 1024, one subject with two 2,048-instance
    slides (so the first batch's bucket is 4096), one with no bag; a
    settings txt and a seeded PathAMIL 'small' gated checkpoint.  Returns the experiment dir
    and the scoreable subjects."""
    import torch
    from multimodalfusion_tpu_torch.data.io import save_pt
    from multimodalfusion_tpu_torch.models.amil import PathAMIL
    rng = np.random.default_rng(seed)
    data = os.path.join(root, "features")
    os.makedirs(os.path.join(data, "path_pt_files"))
    rows, scoreable = [], []
    for i in range(n_subjects):
        sid = f"SUBJ{i:03d}"
        slides = [f"{sid}-A.svs"] + ([f"{sid}-B.svs"] if i == 1 else [])
        for s in slides:
            rows.append(f"{sid},{s}")
            if i == n_subjects - 1:
                continue  # listed in the cohort, no bag on disk
            n = 2048 if i == 1 else int(rng.integers(1000, 2049))
            bag = rng.standard_normal((n, 1024), dtype=np.float32) * 0.5
            save_pt(os.path.join(data, "path_pt_files",
                                 s.replace(".svs", ".pt")), bag)
        if i != n_subjects - 1:
            scoreable.append(sid)
    csv_path = os.path.join(root, "cohort.csv")
    with open(csv_path, "w") as f:
        f.write("subject_id,slide_id\n" + "\n".join(rows) + "\n")
    exp = os.path.join(root, "results", "PATH_amil_smoke")
    os.makedirs(exp)
    settings = {"data_root_dir": data, "csv_path": csv_path,
                "split_dir": root, "mode": "path", "n_classes": 4,
                "bag_loss": "nll_surv", "seed": 1,
                "model_type": "path_attention_mil", "model_size_wsi": "small",
                "use_drop_out": False, "gate_path": True,
                "radio_modality": ["T1", "T2", "T1Gd", "FLAIR"],
                "batch_size": 1}
    with open(os.path.join(exp, "experiment_PATH_amil_smoke.txt"), "w") as f:
        print(settings, file=f)
    model = PathAMIL("small", gate=True,
                     generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(),
               os.path.join(exp, "s_0_minloss_checkpoint.pt"))
    return exp, data, scoreable


def phase_slice(launch_counters):
    import csv

    import torch
    from multimodalfusion_tpu_torch.cli import infer
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.engine.train import (build_model,
                                                         load_checkpoint,
                                                         model_inputs)
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, read_settings)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        exp, data, scoreable = _write_experiment(td)
        log(f"[slice] wrote {len(scoreable) + 1}-subject experiment in "
            f"{time.perf_counter() - t0:.1f} s")
        out_csv = os.path.join(td, "risks.csv")
        argv = ["--model_path", exp, "--which_k", "0", "--out", out_csv,
                "--batch_size", "32", "--device", "cuda"]
        for c in launch_counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = infer.main(argv)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in launch_counters}
        log(f"[slice] cli.infer rc={rc} in {time.perf_counter() - t0:.1f} s;"
            f" kernel launches {launches}")
        if rc != 0 or not all(launches.values()):
            raise AssertionError(f"serving failed or a kernel of the path "
                                 f"was never launched: rc={rc} {launches}")
        with open(out_csv, newline="") as f:
            got = {r["subject_id"]: r for r in csv.DictReader(f)}
        if sorted(got) != sorted(scoreable):
            raise AssertionError("risks.csv rows differ from the scoreable "
                                 "subjects")
        risk = np.array([float(got[s]["risk"]) for s in scoreable])
        if not np.isfinite(risk).all():
            raise AssertionError("non-finite risk")

        # the same model, pooling through the plain version on the card;
        # the kernel path is timed stage by stage on the way
        settings = read_settings(os.path.join(
            exp, "experiment_PATH_amil_smoke.txt"))
        cfg = config_from_settings(settings, batch_size=32)
        model = build_model(cfg).cuda().eval()
        load_checkpoint(model, os.path.join(exp, "s_0_minloss_checkpoint.pt"))
        ds = SurvivalDataset(settings["csv_path"], "path", data)
        want, buckets = {}, []
        spent = dict.fromkeys(("load+collate", "copy", "fc", "pool", "head"),
                              0.0)
        batches = iter_batches(ds, batch_size=32)
        with torch.no_grad():
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                spent["load+collate"] += (time.perf_counter() - t0) * 1e3
                if batch is None:
                    break
                buckets.append(batch["path_bags"].shape[1])
                t0 = time.perf_counter()
                kw = model_inputs(cfg, batch, torch.device("cuda"))
                torch.cuda.synchronize()
                spent["copy"] += (time.perf_counter() - t0) * 1e3
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                h = model.embed(kw["bags"])
                ev[1].record()
                M = model.pool(h, kw["mask"]).float()
                ev[2].record()
                model.head(M)
                ev[3].record()
                torch.cuda.synchronize()
                for i, k in enumerate(("fc", "pool", "head")):
                    spent[k] += ev[i].elapsed_time(ev[i + 1])
                M, _ = mil._pool_plain(h, kw["mask"],
                                       model.pool.attn_params(), True)
                r = model.head(M)["risk"].cpu().numpy()
                for sid, v, ok in zip(batch["subject_ids"], r,
                                      batch["valid"]):
                    if ok:
                        want[sid] = float(v)
        log(f"[slice] serving breakdown over {len(buckets)} batches (host "
            f"clock for load+collate and copy, CUDA events for the rest): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spent.items()))
        ref = np.array([want[s] for s in scoreable])
        err = float(np.max(np.abs(risk - ref) / np.abs(ref)))
        log(f"[slice] {len(risk)} risks, max rel err vs plain pooling "
            f"{err:.2e} (tol 1e-4); batch buckets {buckets}")
        if err > 1e-4:
            raise AssertionError(f"served risks differ from the plain "
                                 f"path: rel {err:.2e}")
        return launches


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _bound(h, mask, Da, gated):
    """Least time (ms) for the function on these inputs: bytes each input
    read once and each output written once, over HBM rate; and the
    matrix-product operations the valid rows need, over the peak for the
    bag's type.  Returns (ms, 'bytes' | 'operations')."""
    B, N, D = h.shape
    n_valid = float(mask.sum())
    item = h.element_size()
    nbytes = (n_valid * D * item + B * N * 4           # bag rows, mask
              + (2 if gated else 1) * D * Da * item    # Wa, Wb
              + (3 * Da + 1) * 4 + B * (D + 2) * 4)    # vectors, outputs
    flops = 2 * n_valid * D * Da * (2 if gated else 1) + 2 * n_valid * D
    dtype = str(h.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_timing(B=32, N=4096, D=256, Da=256):
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    res = {}
    for dtype in ("float32", "bfloat16"):
        h, mask, params = make_pool_case(B, N, D, Da, dtype, seed=123)
        with torch.no_grad():
            out, _ = mil._fused_pool_cuda(h, mask, params, True)
            ref, _ = mil._pool_plain(h, mask, params, True)
            err = float((out - ref).abs().max())
            plain1 = _time_ms(lambda: mil._pool_plain(h, mask, params, True))
            ms = _time_ms(lambda: mil._fused_pool_cuda(h, mask, params, True))
            plain2 = _time_ms(lambda: mil._pool_plain(h, mask, params, True))
        bound_ms, bound_by = _bound(h, mask, Da, True)
        res[dtype] = {"shape": f"B={B} N={N} D={D} Da={Da} {dtype} gated",
                      "ms": ms, "plain_ms": min(plain1, plain2),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": err}
        log(f"[timing] {res[dtype]['shape']}: kernel {ms:.3f} ms, plain "
            f"{plain1:.3f}/{plain2:.3f} ms, bound {bound_ms * 1e3:.1f} us "
            f"({bound_by}), kernel/bound {ms / bound_ms:.1f}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 oracle
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    phase_build()
    t = time.perf_counter()
    phase_kernels()
    log(f"[kernels] done in {time.perf_counter() - t:.1f} s")
    launches = phase_slice([mil._fused_pool_cuda])
    t = time.perf_counter()
    timing = phase_timing()
    log(f"[timing] done in {time.perf_counter() - t:.1f} s")
    main_shape, serving = timing["float32"], timing["bfloat16"]
    entry = dict(KERNEL, launches=launches["_fused_pool_cuda"],
                 max_abs_err=main_shape["max_abs_err"], ms=main_shape["ms"],
                 plain_ms=main_shape["plain_ms"],
                 bound_ms=main_shape["bound_ms"],
                 bound_by=main_shape["bound_by"], library_ms=None,
                 shape=main_shape["shape"], serving_bf16=serving)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(f"nvidia-smi: {smi.stdout.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
