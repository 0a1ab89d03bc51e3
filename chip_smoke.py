"""GPU smoke test of the PyTorch port (multimodalfusion_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- nvcc-build every CUDA kernel from
                multimodalfusion_tpu_torch/csrc, one nvcc per source, in
                parallel with g++ on the host collation library
                (csrc/bagio.cpp).
  2. kernels -- hold each kernel against its plain PyTorch version on the
                card: gated/ungated x f32/bf16 x dropout on/off (the same
                keep masks on both sides), ragged masks with a fully
                masked bag and a padding row, both published PathAMIL
                widths, a narrow D=Da=64 case whose row count ends the
                backward's last dW split mid-chunk, one N=32,768 bag, the
                radiology shapes (B=8 bags of 140-155 slices padded to
                256 at D, Da = 256, 256 / 256, 384 / 512, 384) and two
                widths that are not the kernels' multiples (200, 72 and
                96, 40), which the wrappers zero-pad.  f32 at rel 1e-4, bf16 at
                rel 2e-2 (pooled, ml, dh and the parameter gradients);
                dcc == 0, dh == 0 on masked rows, and two launches of
                either kernel on the same inputs agree bit for bit.
  3. slice   -- write a synthetic stage-2 pathology experiment at full
                PathAMIL width and serve it through cli.infer on the card,
                with every kernel launch counter reset just before and
                read just after; the risks must match the same model run
                through the plain pooling on the card.  Serving is timed
                stage by stage (load+collate into page-locked buffers,
                copy, fc, pool, head).
  4. train   -- write a synthetic labelled stage-2 experiment at full
                PathAMIL width and train one fold for two epochs through
                cli.main on the card (--gate_path --drop_out nll_surv
                Adam), with the counters reset just before and read just
                after: both kernels must launch, every logged loss must be
                finite, and cli.infer must serve the trained checkpoint.
                Then three train steps through the kernels and three
                through the plain versions, from one init and the same
                generator seeds, must agree.  Their batches are loaded
                once and collated twice, by the native library into
                page-locked buffers and by pad_bags_plain, each timed.
  4a. native -- the host library's float32 -> bfloat16 cast on a batch
                shaped like [train]'s (8 x 4096 x 1024 f32, 134 MB,
                seeded, NaNs of every payload, ties and overflow planted):
                bit for bit equal to native.f32_to_bf16_plain, timed
                beside torch's CPU .to(torch.bfloat16), which the port
                never calls; then native.read_files over [train]'s bag
                files, byte for byte equal to Python's reads and timed
                against them (the files warm in the page cache).  No
                kernel launch (counters reset around both).  Alone:
                --phases native (writes its own 32-bag cohort).
  4b. omic   -- write a synthetic labelled cohort with 80 genomic columns
                and train one fold for two epochs each of
                mm_attention_mil --mode path_omic (tensor fusion,
                --gate_path --drop_out) and max_net --mode omic
                (cox_surv) through cli.main, counters reset around each:
                the path+omic fold launches the forward once per train
                step and evaluated batch and the backward once per train
                step, max_net neither.  Serve both through cli.infer; the
                path+omic risks must match the plain pooling at rel
                1e-4.  Three path+omic train steps through the kernels
                must agree with three through the plain versions.
  4c. pretrained -- stages 3 and 4 chained on the card.  Stage 3
                (cli.pre_trained_feature) extracts the 256-d embeddings of
                the path AMIL experiment of [train] (24 of its 32
                subjects) and of the max_net experiment of [omic],
                counters reset just before each: the path run launches the
                forward once per batch and the backward never, its
                embeddings match the plain pooling on the card at rel
                1e-4; the omic run launches neither.  Stage 4
                (cli.main_pretrained, mm_attention_mil path_omic, two
                epochs at B=16) trains a Kronecker nll_surv head and a
                multimodal-dropout cox_surv head on the cohort of [omic],
                8 of whose subjects lack a path embedding: finite losses,
                no kernel launch.  cli.eval_pretrained writes a finite
                c-index for both and an IBS for the nll one; cli.infer
                serves the Kronecker experiment on the card and on the
                CPU, risks agreeing at rel 1e-5.  Alone (--phases
                pretrained) it first trains its own stage-2 experiments,
                one epoch each.
  4d. radio  -- radiology on the card: a synthetic 32-subject glioma
                cohort (4 MRI sequences x 140-155 common slices x 1024 f32
                through the port's h5 writer, 80 genomic columns, small
                slides).  cli.main trains RadioAMIL small (concat,
                --gate_radio --drop_out, B=8: [8, 256, 4096] bag batches)
                for two epochs, one forward per train step and evaluated
                batch, one backward per train step; three kernel train
                steps agree with three plain ones; cli.infer serves it and
                cli.pre_trained_feature extracts its embeddings, both
                against the plain pooling at rel 1e-4;
                mm_attention_mil radio_path_omic (tensor fusion) trains
                two epochs, two forwards and two backwards per train step;
                a stage-4 early-fcnn head trains on the port's own radio,
                path and omic embeddings (no launch); the full-width
                Kronecker fusion of the sequences trains one epoch and is
                served; a 2-sequence Kronecker fusion trains one epoch and
                is served from its checkpoint and again from the same
                weights in the JAX export's layout (the 4-sequence
                placeholder in the .pt, the trained fusion in the flax
                msgpack beside it), risks equal.  Counters reset just
                before each run.
  4e. interpret -- stage 5 on the [radio] experiments, each check against
                the CPU in the same call: the attention read-out
                (attention_only) of the radio model on a served batch and
                of a PathAMIL on one 32,768 x 1024 bag, the card's raw
                scores against a float64 reference (a .double() copy of
                the CPU model) at rel 1e-5 with no launch, the CPU's own
                f32 error and card vs CPU beside it, and each stage's (the
                fused sequences, h, the gates a and b, s) error on both
                devices; masked_softmax_pool of the scores
                against the pooled features of mil_pool_fwd (one launch)
                at rel 1e-5; MMAttentionMIL return_attention's A_raw at
                rel 1e-5; cli.create_attributions on the stage-4 head
                (attr.csv at rel 1e-4, the IG completeness gap printed);
                cli.create_heatmaps radio (scores.csv: the same groups,
                attention at rel 1e-5) and omic (ig and
                expected_gradients with the same draws, rel 1e-4).  No CLI
                launches a kernel.  One wall-seconds line with the card's
                name and power limit.  Alone (--phases interpret) it runs
                [radio] first for its experiments.
  4f. j2k    -- the committed JPEG 2000 fixtures of
                multimodalfusion_tpu_torch/testdata/j2k (made by PIL's
                openjpeg and by the port's encoder: 9/7 in layers, RPCL
                precincts, tiles with offsets, RGB with the ICT, signed
                12-bit, every code-block style bit, PPT tile-parts and
                POC) decoded by the C++ and the plain versions, both to
                the manifest's SHA-256 of PIL's pixels; no launch.
  4g. jpeg   -- the committed JPEG fixtures of
                multimodalfusion_tpu_torch/testdata/jpeg (made by PIL's
                libjpeg-turbo, tools/jpeg_writer.py and
                tools/jpeg_arith.py: progressive at 4:4:4, 4:2:2, 4:2:0
                and gray, successive approximation from Al = 3, EOB runs
                with restarts in every scan type, three early-stopped
                scripts that libjpeg-turbo smooths, CMYK with and without
                an Adobe marker and YCCK, baseline and progressive;
                arithmetic-coded SOF9 and SOF10, lossless SOF3) decoded
                by the C++ and the plain versions, both to the manifest's
                SHA-256 of PIL's pixels; no launch.
  4h. zstd   -- the committed Zstandard fixtures of
                multimodalfusion_tpu_torch/testdata/zstd (written by
                libzstd at levels 1 to 22: checksums, no content size,
                far and long-distance matches, skippable and concatenated
                frames, RLE and raw blocks, every literal and table mode)
                decoded by the C++ and the plain versions, both to the
                manifest's SHA-256 of libzstd's output; no launch.
  4i. h5     -- the committed HDF5 fixtures of
                multimodalfusion_tpu_torch/testdata/h5 (written by h5py
                with libver v108 and latest, track_order and lzf:
                superblocks 2 and 3, version-2 object headers, dense links
                and attributes, single-chunk, implicit, fixed-array
                (paged), extensible-array (super blocks) and B-tree v2
                chunk indexes) read by the port's reader with the C++ and
                the plain lzf decoders, both to the manifest's SHA-256s
                of h5py's arrays and its attributes; the lzf chunks
                decoded by both (MB/s), each file's read timed (host ms
                per MB); cli.infer serves the fixtures' 2-subject glioma
                cohort with [radio]'s RadioAMIL: one forward launch, no
                backward, risks against the plain pooling at rel 1e-4 and
                equal bit for bit to the same cohort rewritten by the
                port's writer (superblock 0).  Alone: --phases h5 (runs
                [radio] first).
  5. timing  -- each kernel vs its plain version at B=32 N=4096, beside
                the bound (bytes or operations over the card's peak) and,
                for the f32 forward, cuBLAS's f32 product h [Wa | Wb] of
                the same shape as a yardstick, for the bf16 backward
                cuBLAS's bf16 products of its three shapes, each alone;
                device time per sub-kernel under torch.profiler; a
                training step's breakdown with
                CUDA events: load, collate and the copy from page-locked
                buffers on the host clock, beside the yardstick of
                pad_bags_plain and a pageable copy of the same batch;
                both kernels at the radiology shape (B=8, N=256, D=Da=256)
                with the CTAs of the plan each launch ran (log line only),
                and the host time per call of each wrapper against the
                launch it wraps.
  5b. bf16step -- the JAX package's benchmark step (bench.py) through the
                port's engine: gated PathAMIL small, nll_surv, Adam, B=48
                bags of 4096 x 1024 f32 with 90% valid rows drawn on the
                card, bag_dtype bfloat16, without and with --drop_out.
                Per arm three kernel steps against three plain ones (one
                forward and one backward launch per kernel step, none in
                the plain ones; losses at rel 2e-2, parameters to 2e-2 of
                their movement, at most 1e-4 of the elements over one
                step), the step split with CUDA events as [timing]'s
                f32 step, and its torch.profiler kernel time and busy
                share.  Alone: --phases bf16step.
  6. extract  -- radiology stage 1 on the card: a glioma cohort (8
                subjects x 4 sequences of 155 x 240 x 240 int16 NIfTI) and
                a lung cohort (3 DICOM series of 60 x 512 x 512 int16, one
                JPEG Lossless SV1, one JPEG 2000 Lossless twin of the
                uncompressed one) written by the port's writers and run
                through cli.feature_extraction in bf16 with seeded
                --weights: no pooling launch, the C++ JPEG and JPEG 2000
                decoders used, every h5 finite, the JPEG series' host
                preprocessing timed step by step; the J2K series reads
                back to its volume and its features equal its twin's, its
                decode ms per megapixel (C++, plain) printed, and the two
                served (one forward launch, equal risks); the card's
                slice inputs equal the host
                path bit for bit; f32 on the card against the CPU at rel
                1e-3, bf16 against f32 at 2e-2; embed_images and trunk
                images per second (bf16, f32) beside the bound of 6.556
                GFLOP per image; the short last chunk padded or not;
                cli.infer serves the glioma features with [radio]'s
                RadioAMIL, one forward launch per batch, risks against the
                plain pooling at rel 1e-4.  Alone (--phases extract) it
                runs [radio] first for its experiment.  It runs after
                every earlier phase.
  7. gradcam  -- stage 5's radiology images on [extract]'s glioma cohort
                and [radio]'s RadioAMIL: cli.create_heatmaps radio with a
                scan_list (4 subjects, T1 and FLAIR displayed; no launch;
                every slice PNG read back equal to its preprocessed
                slice); cli.gradcam cohort, top slices, aug-smooth, 4
                subjects x 4 sequences (6 forward and 6 backward launches
                a scan); one scan's CamRunner through the kernels against
                the plain pooling on the card (CAMs at atol 1e-4, the
                AMIL's risk at rel 1e-5); --all_slices on one subject's
                T1 (its volume finite, in [0, 1]); single-scan lung on a DICOM series (the CAM
                inside the lung mask over twice the CAM outside); an
                8-slice glioma scan at 96 x 96 on the card against the CPU
                (cam_volume at atol 1e-4); card time per CAM image against
                the f32 trunk's bound and the pooling kernels' share of a
                CAM pass.  Alone (--phases gradcam) it runs [radio] and
                [extract] first.  It runs last.
  8. dist     -- multi-GPU on the one card: two ranks on cuda:0 over
                gloo (NCCL refuses two ranks on one GPU) run the
                bag-sharded pooling at B=8 N=4096 D=Da=256 f32 gated, with
                and without dropout (each rank its 2048-row block, one
                forward and one backward launch), against the unsharded
                kernels at rel 1e-5 (pooled, dh, parameter gradients), and
                two bag-sharded and two data-parallel PathAMIL small
                training steps (B=8, N=2048, --drop_out; batches from the
                loader, each rank collating its rows into page-locked
                buffers; one launch of each kernel per rank per step)
                against two one-process kernel steps (losses at rel 1e-4,
                the first step's summed gradients at 1e-4 of their norm,
                parameters to 1e-3 of their movement), and the peak
                device memory of one bag-sharded step at B=1 N=32768
                against one process's (at most 0.75 of it).  Then
                torchrun --nproc_per_node=1 runs
                cli.main --data_parallel --bag_shard over NCCL: the JAX
                package's unsharded lines.  Alone: --phases dist.
  9. ops      -- operations on [train]'s 32 bags (PathAMIL small, gated,
                --drop_out, nll_surv, B=8, f32; 4 MRI columns blank and no
                censored subject in the cohort CSV, so --split pre_trained
                leaves 28 train and 4 validation subjects in fold 0):
                cli.main --split pre_trained --k 2 --tb --profile_dir for
                two epochs then --resume to four; the same fold in a
                subprocess killed with SIGKILL after its second epoch's
                record, then resumed; a straight 4-epoch fold; two epochs
                with --ckpt_format orbax (the same .pt bundle) resumed to
                four.  Each
                resumed fold against the straight one, bit for bit or
                within the step check's tolerances (both reported); each
                run's launches as expected (one forward per train step and
                evaluated batch, one backward per train step).  The
                bundle's write time and size; an epoch with and without
                the profiler; the pooling sub-kernels in the trace against
                the launch counters; cli.export_model --platforms cuda
                --check (2 forward launches), --platforms cpu --check
                and --platforms cuda cpu --check (none: exported and
                checked on the CPU); the cuda artifact serves B=8, N=512
                through one forward launch, equal to the eager model,
                timed against it; cli.doctor --full holds both kernels
                against their plain versions.  Alone: --phases ops
                (writes its own bags).
  10. report  -- the reporting stage over the work tree: cli.main trains
                a 3-fold RadioAMIL small on [radio]'s cohort at its full
                width (B=8, [8, 256, 4096] f32 batches, two epochs; one
                forward per train step and evaluated or summary batch, one
                backward per train step; three kernel train steps against
                three plain ones); cli.summarize with --km, quartile
                strata, --hazard_hist, --cohort_csv, --bootstrap 1000,
                --pivot and --emit_heatmap_yamls over every experiment of
                the earlier phases and this one (no launch; one
                cv_summary.csv row per summary.csv; the new experiment's
                pooled c-index equal to its pkls', finite IPCW metrics
                and CI; one YAML per fold of each PATH, RADIO and OMICS
                experiment, then one per experiment at its best fold);
                cli.create_heatmaps on an emitted RADIO and OMICS config
                (no launch).  Alone: --phases report (runs [radio]
                first).
  11. wsi    -- WSI stages 0 and 1 on the card, last: four synthetic
                slides of 8192 x 6144 and one of 24576 x 18432 (3 levels, 3
                blobs; the port's TIFF writer; the large one read under a
                4 GiB MMF_TPU_WSI_MAX_BYTES) through cli.create_patches
                (256-px patches, --stitch, --a_t 0.5 --a_h 0.05; the pixel
                filters on the card) and cli.extract_features_fp (bf16,
                batch 128, random weights, 256 -> 224 on the card): no
                kernel launch in either; patches per slide, host seconds
                of each stage-0 step, patches per second of the reads and
                the embedding, the resize of a batch on the host and on
                the card, the trunk's time per patch; every bag as many
                rows as its coordinates, finite, the attributes read back;
                then cli.infer serves the bags with [train]'s PathAMIL
                (one forward launch per batch of 8, risks against the
                plain pooling at rel 1e-4).  The four 8192 x 6144
                slides are written again as 256 x 256 tiled pyramids:
                JPEG (YCbCr 4:2:0, quality 95, utils/jpeg.encode_jpeg's
                tiles), JPEG with its tables in JPEGTables, Deflate, LZW
                with Predictor 2 (chip_smoke's own writers and LZW
                encoder).  They are read through the port's C++
                decoders (Deflate and LZW equal to the source pixels,
                JPEG within 1 dB of the encoder's round trip), the
                smallest page of each again through the plain decoders
                (bit for bit), the decode ms per megapixel of each route
                printed, then patched (Deflate and LZW coordinates equal
                to their uncompressed twins'), extracted and served (one
                forward launch, risks against the plain pooling at rel
                1e-4).  Level 0 of the first is written again as a
                lossless RCT .jp2 by the port's JPEG 2000 encoder and as a
                one-page TIFF twin: the .jp2 decodes to the source, both
                give the same coordinates and features, and their bags are
                served (one forward launch, equal risks).  The same level
                as a baseline .jpg (utils/jpeg.encode_jpeg) and, from its
                coefficients, a progressive one in libjpeg's default
                script (tools/jpeg_writer.py): PILSlide reads them equal
                bit for bit (decode ms per megapixel of each), a 1024 x
                768 crop decodes equal by plain and C++, both give the
                same coordinates and features, and their bags are served
                (one forward launch, equal risks).  A 2048 x 1536 crop
                of that level as a baseline .jpg and, from its
                coefficients, arithmetic-coded SOF9 (restarts) and SOF10
                .jpg slides (tools/jpeg_arith.py) and a Huffman
                progressive one, with an uncompressed TIFF twin and a
                planar LZW RGBA TIFF: PILSlide reads them equal bit for
                bit (C++ decode ms per megapixel; the plain decode of a
                512 x 512 crop equal), the same coordinates and
                features, and their six bags are served (one forward
                launch, equal risks).  The same crop as ZSTD TIFFs
                (tools/zstd_writer.py: tiles with Predictor 2, strips
                with checksums, planar RGBA) beside an uncompressed twin:
                PILSlide reads them equal to the crop bit for bit (C++
                decode ms per megapixel; the plain decode of a 512 x 512
                square equal), the twin's coordinates and features bit
                for bit, and their four bags are served (one forward
                launch, the twin's risks).  The four tiled pyramids
                again as little-endian BigTIFF (tools/bigtiff.py, every
                tile's bytes kept; the JPEG one as a .btf whose level-0
                tiles sit past 4 GiB in a sparse file), and the Deflate
                one as a big-endian BigTIFF: PILSlide reads each of the
                four equal to its classic twin bit for bit (read_pages ms,
                decode ms per megapixel of both) and refuses the
                big-endian one with BigEndianBigTIFFError; the .btf slide
                is patched, extracted (--slide_ext .btf) and served (one
                forward launch) to the classic twin's coordinates,
                features and risk bit for bit.  Last, an Aperio .svs of
                16,320 x 12,240 (tools/svs_writer.py: 240 x 240 JPEG tiles
                of utils/jpeg.encode_jpeg, levels at downsample 4 and 16,
                thumbnail, label, macro) beside a plain tiled TIFF of the
                same tile bytes: open_slide reads it tile by tile with no
                decode budget (PILSlide refuses the twin under its
                default), every level equal to the twin's, plain = C++ on
                level 2 and 64 level-0 tiles, stages 0 and 1 in a child
                process (tiles touched and decoded, the tile cache's
                peak, peak RSS; the twin's coordinates and, inside the
                level, its bag bit for bit), its bags served (one
                forward launch).  The slides are deleted.  Alone: --phases
                wsi (runs [train] first), or --phases svs for the Aperio
                sub-phase alone (after [train]).
  digest     -- only when asked for (--phases digest): SHA-256 of both
                kernels' outputs on seeded cases, to compare two
                checkouts' kernels bit for bit on one card.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import os
import shutil
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
# parameter gradients sum over every valid row of every bag, in another
# order than the plain version: f32 holds at rel 1e-4 of the largest entry;
# bf16 rounds dpa/dpb to bf16 before the products on both sides, and a
# last-bit difference in f32 can round one element the other way, so bf16
# holds at 2e-2 like its dh
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernel train steps against plain ones (_steps_agree), by bag dtype: the
# losses' relative error, each tensor's |difference| over |movement|, and
# the share of elements allowed to differ by more than one Adam step (lr).
# f32 differs in the order of f32 sums only.  bf16 casts dh and
# [dpa | dpb] to bf16 on both sides after f32 sums in another order, so an
# element can round one bf16 ulp (2^-8) the other way; it holds at the
# kernels' own bf16 tolerance, and where a parameter's gradient is near 0
# Adam turns such a difference into a step of the other sign (up to 2 lr;
# 1-2 of the 400k elements of a B=8 bf16 PathAMIL in 3 steps on the CPU),
# so a share of 1e-4 of the elements may differ by more than lr.
STEP_TOL = {"float32": (1e-4, 1e-3, 0.0), "bfloat16": (2e-2, 2e-2, 1e-4)}
# the radiology bags of a B=8 batch: 140-155 common slices, padded to 256
RADIO_LENS = [155, 140, 151, 147, 143, 155, 149, 152]
# (D, Da) of the radiology attention nets: RadioAMIL and mm_attention_mil
# small (256, 256), mm_attention_mil big (256, 384), RadioAMIL big
# (512, 384); and widths that are not the kernels' multiples, which the
# wrappers zero-pad (D to 32 forward and 64 backward, Da to 8 and 64)
RADIO_WIDTHS = [(256, 256), (256, 384), (512, 384)]
ODD_WIDTHS = [(200, 72), (96, 40)]
KERNELS = {
    "mil_pool_fwd": {
        "name": "mil_pool_fwd",
        "route": "cuda",
        "source": "multimodalfusion_tpu_torch/csrc/mil_pool_fwd.cu",
        "replaces": "multimodalfusion_tpu/ops/mil_attention.py:171",
    },
    "mil_pool_bwd": {
        "name": "mil_pool_bwd",
        "route": "cuda",
        "source": "multimodalfusion_tpu_torch/csrc/mil_pool_bwd.cu",
        "replaces": "multimodalfusion_tpu/ops/mil_attention.py:376",
    },
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
    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.ops import cuda_build
    names = sorted(os.path.splitext(f)[0]
                   for f in os.listdir(cuda_build.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    # one nvcc per source and g++ for each host library, all at once
    with ThreadPoolExecutor(len(names) + 3) as ex:
        host = ex.submit(native.build)
        hosts = {src: ex.submit(native.build, src)
                 for src in (native.CODEC_SRC, native.J2K_SRC)}
        for name, so in zip(names, ex.map(cuda_build.build, names)):
            info = cuda_build.build_info.get(name, {})
            log(f"[build] {name} -> {os.path.relpath(so, REPO)} "
                f"({info.get('seconds', 0.0):.1f} s)")
            for line in info.get("ptxas", "").splitlines():
                if any(k in line for k in ("entry function", "registers",
                                           "spill")):
                    log(f"[build]   {line.strip()}")
        log(f"[build] host library csrc/bagio.cpp -> "
            f"{os.path.relpath(host.result(), REPO)}")
        for src, so in hosts.items():
            log(f"[build] host library csrc/{os.path.basename(src)} -> "
                f"{os.path.relpath(so.result(), REPO)}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    """The forward kernel's no-dropout variants, as in slice 1."""
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
    # the radiology shapes: short bags of 140-155 slices padded to 256 (a
    # whole 128-row tile and a partly valid one), at RadioAMIL small,
    # mm_attention_mil big (Da=384) and RadioAMIL big (D=512, Da=384); then
    # the odd widths the wrapper pads
    for D, Da in RADIO_WIDTHS + ODD_WIDTHS:
        for dtype in ("float32", "bfloat16"):
            for gated in (True, False):
                cases.append(("radio", 8, 256, D, Da, dtype, gated,
                              RADIO_LENS))
    worst = 0.0
    for i, (tag, B, N, D, Da, dtype, gated, lens) in enumerate(cases):
        h, mask, params = make_pool_case(B, N, D, Da, dtype, seed=i,
                                         lens=lens)
        if tag == "ragged":
            h[5] = 0  # the padding row of a partial batch
        with torch.no_grad():
            out, ml = mil._fused_pool_cuda(h, mask, params, gated)
            out2, ml2 = mil._fused_pool_cuda(h, mask, params, gated)
            ref, ref_ml = mil._pool_plain(h, mask, params, gated)
        torch.cuda.synchronize()
        repeat = torch.equal(out, out2) and torch.equal(ml, ml2)
        e_out = rel_err(out, ref)
        live = ref_ml[:, 1] > 0
        e_m = rel_err(ml[live, 0], ref_ml[live, 0]) if live.any() else 0.0
        e_l = rel_err(ml[:, 1], ref_ml[:, 1])
        ok = (repeat and torch.isfinite(out).all().item() and
              max(e_out, e_m, e_l) <= TOL[dtype])
        if lens is not None:
            empty = torch.tensor([n == 0 for n in lens], device="cuda")
            ok = ok and bool((out[empty] == 0).all()) and \
                bool((ml[empty, 1] == 0).all())
        worst = max(worst, float((out - ref).abs().max()))
        log(f"[kernels] {tag:8s} B={B} N={N} D={D} Da={Da} {dtype:8s} "
            f"gated={gated!s:5s} rel(pooled)={e_out:.2e} rel(m)={e_m:.2e} "
            f"rel(l)={e_l:.2e} tol={TOL[dtype]:.0e} "
            f"repeat={'bitwise' if repeat else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"on case {tag} {dtype} gated={gated}")
    return worst


def phase_kernels_train():
    """The forward kernel's dropout variants and the backward kernel
    against their plain versions, on the same masks; each kernel twice on
    the same inputs must agree bit for bit."""
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    cases = []
    for dtype in ("float32", "bfloat16"):
        for gated in (True, False):
            for dropout in (False, True):
                cases.append(("ragged", 6, 1000, 256, 256, dtype, gated,
                              dropout, [1000, 0, 517, 33, 999, 0]))
                cases.append(("big", 4, 700, 512, 384, dtype, gated,
                              dropout, [700, 0, 350, 1]))
                # half of a 128-wide SGEMM tile; 900 rows end the dW
                # partial kernel's last split mid-chunk
                cases.append(("narrow", 3, 300, 64, 64, dtype, gated,
                              dropout, [300, 0, 129]))
        cases.append(("bigbag", 2, 32768, 256, 256, dtype, True, True,
                      [32768, 20001]))
    for D, Da in RADIO_WIDTHS:
        for dtype in ("float32", "bfloat16"):
            for dropout in (False, True):
                cases.append(("radio", 8, 256, D, Da, dtype, True, dropout,
                              RADIO_LENS))
    for D, Da in ODD_WIDTHS:
        for dtype in ("float32", "bfloat16"):
            for gated in (True, False):
                for dropout in (False, True):
                    cases.append(("odd", 3, 300, D, Da, dtype, gated,
                                  dropout, [300, 0, 129]))
    worst = {"mil_pool_fwd": 0.0, "mil_pool_bwd": 0.0}
    for i, (tag, B, N, D, Da, dtype, gated, dropout, lens) in enumerate(
            cases):
        h, mask, params = make_pool_case(B, N, D, Da, dtype, seed=100 + i,
                                         lens=lens)
        if tag == "ragged":
            h[5] = 0  # the padding row of a partial batch
        gen = torch.Generator(device="cuda").manual_seed(i)
        da = db = None
        if dropout:
            da, db = mil.make_dropout_masks(gen, (B, N, Da), gated)
        g = torch.randn(B, D, generator=gen, device="cuda")
        with torch.no_grad():
            out, ml = mil._fused_pool_cuda(h, mask, params, gated, da, db)
            out2, ml2 = mil._fused_pool_cuda(h, mask, params, gated, da, db)
            ref, ref_ml = mil._pool_plain(h, mask, params, gated, da, db)
            dh, grads = mil._fused_pool_bwd_cuda(h, mask, params, ref,
                                                 ref_ml, g, gated, da, db)
            dh2, grads2 = mil._fused_pool_bwd_cuda(h, mask, params, ref,
                                                   ref_ml, g, gated, da, db)
            want_dh, want = mil._pool_bwd_plain(h, mask, params, ref,
                                                ref_ml, g, gated, da, db)
        torch.cuda.synchronize()
        live = ref_ml[:, 1] > 0
        e_fwd = max(rel_err(out, ref), rel_err(ml[:, 1], ref_ml[:, 1]),
                    rel_err(ml[live, 0], ref_ml[live, 0]))
        e_dh = rel_err(dh.float(), want_dh.float())
        names = mil.AttnParams._fields[:5] if gated else ("Wa", "ba", "wc")
        e_grad = {k: rel_err(getattr(grads, k), getattr(want, k))
                  for k in names}
        masked = mask == 0
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (out, ml[:, 1], dh.float(), *grads))
        repeat = (torch.equal(out, out2) and torch.equal(ml, ml2)
                  and torch.equal(dh, dh2) and all(
                      torch.equal(x, y) for x, y in zip(grads, grads2)))
        ok = (finite and repeat and e_fwd <= TOL[dtype]
              and e_dh <= TOL[dtype]
              and max(e_grad.values()) <= GRAD_TOL[dtype]
              and bool((grads.cc == 0).all())
              and bool((dh[masked] == 0).all()))
        worst["mil_pool_fwd"] = max(worst["mil_pool_fwd"],
                                    float((out - ref).abs().max()))
        worst["mil_pool_bwd"] = max(worst["mil_pool_bwd"], float(
            (dh.float() - want_dh.float()).abs().max()))
        log(f"[kernels] {tag:6s} B={B} N={N} D={D} Da={Da} {dtype:8s} "
            f"gated={gated!s:5s} dropout={dropout!s:5s} rel(fwd)="
            f"{e_fwd:.2e} rel(dh)={e_dh:.2e} rel(grads)="
            f"{max(e_grad.values()):.2e} dcc=0 masked dh=0 "
            f"repeat={'bitwise' if repeat else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(
                f"training kernels disagree with their plain versions on "
                f"case {tag} {dtype} gated={gated} dropout={dropout}: "
                f"finite={finite} repeat={repeat} grads={e_grad}")
    return worst


def phase_digest():
    """SHA-256 of the kernels' outputs on seeded cases: per case one
    [digest] line for the backward (dh and each parameter gradient) and one
    [digest-fwd] line for the forward (out and ml).  Run this script with
    ``--phases digest`` from two checkouts on one card to see whether their
    kernels agree bit for bit."""
    import hashlib

    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil

    def sha(names, tensors):
        sums = []
        for k, t in zip(names, tensors):
            raw = t.contiguous().view(torch.uint8).cpu()
            digest = hashlib.sha256(raw.numpy().tobytes())
            sums.append(f"{k}={digest.hexdigest()[:12]}")
        return " ".join(sums)
    shapes = ((6, 1000, 256, 256, [1000, 0, 517, 33, 999, 0]),
              (4, 700, 512, 384, [700, 0, 350, 1]),
              (32, 4096, 256, 256, None))
    for i, (B, N, D, Da, lens) in enumerate(shapes):
        for dtype in ("float32", "bfloat16"):
            for gated in (True, False):
                for dropout in (False, True):
                    h, mask, params = make_pool_case(B, N, D, Da, dtype,
                                                     seed=200 + i, lens=lens)
                    gen = torch.Generator(device="cuda").manual_seed(i)
                    da = db = None
                    if dropout:
                        da, db = mil.make_dropout_masks(gen, (B, N, Da),
                                                        gated)
                    g = torch.randn(B, D, generator=gen, device="cuda")
                    with torch.no_grad():
                        out, ml = mil._pool_plain(h, mask, params, gated, da,
                                                  db)
                        dh, grads = mil._fused_pool_bwd_cuda(
                            h, mask, params, out, ml, g, gated, da, db)
                        k_out, k_ml = mil._fused_pool_cuda(
                            h, mask, params, gated, da, db)
                    case = (f"B={B} N={N} D={D} Da={Da} {dtype} "
                            f"gated={gated} dropout={dropout} ")
                    log("[digest] " + case + sha(
                        ("dh",) + mil.AttnParams._fields, (dh, *grads)))
                    log("[digest-fwd] " + case + sha(("out", "ml"),
                                                     (k_out, k_ml)))


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
    from multimodalfusion_tpu_torch.data.bags import PinnedPool
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
        # the kernel path is timed stage by stage on the way, fed as
        # cli.infer feeds it (page-locked buffers, new at each bucket)
        settings = read_settings(os.path.join(
            exp, "experiment_PATH_amil_smoke.txt"))
        cfg = config_from_settings(settings, batch_size=32)
        model = build_model(cfg).cuda().eval()
        load_checkpoint(model, os.path.join(exp, "s_0_minloss_checkpoint.pt"))
        ds = SurvivalDataset(settings["csv_path"], "path", data)
        want, buckets = {}, []
        spent = dict.fromkeys(("load+collate", "copy", "fc", "pool", "head"),
                              0.0)
        pool = PinnedPool()
        batches = iter_batches(ds, batch_size=32, pool=pool)
        with torch.no_grad():
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                spent["load+collate"] += (time.perf_counter() - t0) * 1e3
                if batch is None:
                    break
                buckets.append(batch["path_bags"].shape[1])
                t0 = time.perf_counter()
                kw = model_inputs(cfg, batch, torch.device("cuda"), pool)
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


RADIO_SEQS = ("T1", "T2", "T1Gd", "FLAIR")


def _write_train_experiment(root, n_subjects=32, n_val=8, seed=1,
                            n_genes=0, bag_range=(1000, 4097),
                            radio_slices=0):
    """Synthetic labelled stage-2 cohort in the training CLI's layout:
    one slide per subject, bags of ``bag_range`` instances x 1024 (one of
    the largest size, so a batch pads to its bucket), survival times and
    censorship from ``seed``, ``n_genes`` genomic columns G0.. (normal),
    and a splits_0.csv with ``n_val`` validation subjects.  With
    ``radio_slices``, a glioma cohort: each subject's four MRI sequences
    (T1, T2, T1Gd, FLAIR) of a ``radio_slices``-slice volume x 1024 f32,
    written through the port's h5 writer, each sequence missing 0-3
    slices and storing the rest shuffled, so that ``intersect_slices``
    aligns them (from a generator of its own, so the other draws do not
    move).  Returns the CLI's data arguments."""
    from multimodalfusion_tpu_torch.data.io import save_hdf5, save_pt
    rng = np.random.default_rng(seed)
    radio_rng = np.random.default_rng(seed + 1000)
    feat = os.path.join(root, "features", "brain", "path_pt_files")
    cohort = os.path.join(root, "dataset_csv", "brain")
    splits = os.path.join(root, "splits", "brain", "smoke")
    seqs = RADIO_SEQS if radio_slices else ()
    for d in (feat, cohort, splits) + tuple(
            os.path.join(root, "features", "brain", "radio_h5_files", m)
            for m in seqs):
        os.makedirs(d)
    sids = [f"SUBJ{i:03d}" for i in range(n_subjects)]
    rows = []
    for i, sid in enumerate(sids):
        n = bag_range[1] - 1 if i == 0 else int(rng.integers(*bag_range))
        bag = rng.standard_normal((n, 1024), dtype=np.float32) * 0.5
        save_pt(os.path.join(feat, f"{sid}-A.pt"), bag)
        for m in seqs:
            drop = int(radio_rng.integers(0, 4))
            ids = radio_rng.permutation(radio_slices)[drop:]
            save_hdf5(os.path.join(root, "features", "brain",
                                   "radio_h5_files", m, f"{sid}.h5"),
                      {"features": radio_rng.standard_normal(
                          (len(ids), 1024), dtype=np.float32) * 0.5,
                       "slice_index": ids.astype(np.int64)})
        months = float(rng.uniform(1.0, 120.0))
        censored = float(rng.uniform() < 0.3)
        genes = ("".join(f",{g:.4f}" for g in rng.standard_normal(n_genes))
                 if n_genes else "")
        cells = "".join(f",{m}_file" for m in seqs)
        rows.append(f"{sid},{sid}-A.svs{cells},{months:.1f},{censored},1"
                    f"{genes}")
    with open(os.path.join(cohort, "survival.csv"), "w") as f:
        f.write("subject_id,slide_id" + "".join(f",{m}" for m in seqs)
                + ",survival_months,censorship,train"
                + "".join(f",G{g}" for g in range(n_genes)) + "\n"
                + "\n".join(rows) + "\n")
    order = rng.permutation(n_subjects)
    train = [sids[i] for i in order[n_val:]]
    val = [sids[i] for i in order[:n_val]]
    with open(os.path.join(splits, "splits_0.csv"), "w") as f:
        f.write("train,val\n")
        for i, t in enumerate(train):
            f.write(f"{t},{val[i] if i < len(val) else ''}\n")
    return ["--cancer_type", "brain", "--which_splits", "smoke",
            "--data_root_dir", os.path.join(root, "features"),
            "--dataset_root", os.path.join(root, "dataset_csv"),
            "--splits_root", os.path.join(root, "splits")]


def _collect_batches(view, batch_size, seed, n, pool):
    """The first ``n`` batches of ``view`` in ``iter_batches``' shuffled
    order for ``seed``, each loaded once and collated twice: by the port's
    host path (the native library into ``pool``'s page-locked buffers)
    and by the plain yardstick (``pad_bags_plain``), whose copy to the
    card is then timed from pageable memory, as the pinned batch's copy
    is from page-locked memory.  The two collations run in turns.  An
    untimed batch first warms ``pool`` (its page-locking allocations), so
    the timed batches reuse its buffers as training does.  Returns (plain
    batches, host milliseconds per stage: lists of ``n``)."""
    import torch
    from multimodalfusion_tpu_torch.data.bags import pad_bags_plain
    from multimodalfusion_tpu_torch.data.loaders import (
        _batch_from_samples, usable_indices)
    order = list(usable_indices(view))
    np.random.default_rng(seed).shuffle(order)
    chunks = [order[i * batch_size:(i + 1) * batch_size] for i in range(n)]
    plain_batches = []
    ms = {k: [] for k in ("load", "collate", "copy",
                          "collate (pad_bags_plain)",
                          "copy (pageable, pad_bags_plain's batch)")}
    for i, chunk in enumerate(chunks[:1] + chunks):
        t0 = time.perf_counter()
        samples = [view.get_sample(j) for j in chunk]
        spent = {"load": time.perf_counter() - t0}
        for way in (("pinned", "plain") if i % 2 else ("plain", "pinned")):
            t0 = time.perf_counter()
            if way == "pinned":
                pinned = _batch_from_samples(
                    samples + [None] * (batch_size - len(samples)),
                    view.mode, pool)
                spent["collate"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                for k in ("path_bags", "path_mask"):
                    torch.from_numpy(pinned[k]).to("cuda", non_blocking=True)
                pool.release([pinned["path_bags"], pinned["path_mask"]])
                torch.cuda.synchronize()
                spent["copy"] = time.perf_counter() - t0
                continue
            bags = pad_bags_plain([s.path for s in samples] + [None] * (
                batch_size - len(samples)), 1024)
            spent["collate (pad_bags_plain)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for x in bags:
                torch.from_numpy(x).to("cuda")
            torch.cuda.synchronize()
            spent["copy (pageable, pad_bags_plain's batch)"] = (
                time.perf_counter() - t0)
        pinned.pop("subject_ids")
        if i == 0:
            log(f"[host] warm-up batch (untimed): collate into newly "
                f"page-locked buffers {spent['collate'] * 1e3:.3f} ms")
            continue
        for k, v in spent.items():
            ms[k].append(v * 1e3)
        plain_batches.append(dict(pinned, path_bags=bags[0],
                                  path_mask=bags[1]))
    return plain_batches, ms


def _plain_pooling():
    """The pooling forward and backward through their plain versions on
    the card instead of the kernels, while the context lasts."""
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    return mil.pooling_route("plain")


def _run_steps(cfg, batches, plain=False):
    """Train steps on ``batches`` from the seeded init, with the dropout
    bits from a seeded card generator.  ``plain``: the pooling forward and
    backward go through their plain versions on the card instead of the
    kernels.  Returns (losses, init state, final state)."""
    import torch
    from multimodalfusion_tpu_torch.engine import train as ttrain
    model = ttrain.build_model(cfg, torch.Generator().manual_seed(0)).cuda()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = ttrain.make_optimizer(cfg, model.parameters())
    step, _ = ttrain.make_steps(cfg, model, opt, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    with _plain_pooling() if plain else contextlib.nullcontext():
        losses = [float(step(b, gen)["loss"]) for b in batches]
    return losses, init, {k: v.detach().clone()
                          for k, v in model.state_dict().items()}


def _steps_agree(tag, cfg, batches, launch_counters, arm=""):
    """Three train steps through the kernels against three through the
    plain versions on the card, from one init and the same generator
    seeds: each kernel launches once per kernel step and never in the
    plain steps; the losses and parameters agree within ``STEP_TOL`` of
    the bag dtype (f32: losses at rel 1e-4, parameters to 1e-3 of their
    movement, each element to one step, lr).  ``arm`` names the run in
    the log line."""
    before = {c.__name__: c.launches for c in launch_counters}
    k_loss, init, k_state = _run_steps(cfg, batches)
    mid = {c.__name__: c.launches for c in launch_counters}
    p_loss, _, p_state = _run_steps(cfg, batches, plain=True)
    after = {c.__name__: c.launches for c in launch_counters}
    if any(mid[k] - before[k] != 3 or after[k] != mid[k]
           for k in before):
        raise AssertionError(f"the kernel steps must launch each kernel "
                             f"3 times and the plain steps none: "
                             f"{before} {mid} {after}")
    e_loss = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    # Adam divides by sqrt(v): an element whose gradient is near 0
    # turns a last-bit difference of the summation order into a
    # visible part of one step.  So each tensor's difference is held
    # against how far it moved (in norm) and each element to one step
    # (lr), all but the share STEP_TOL allows.
    tol_loss, tol_state, tol_share = STEP_TOL[cfg.bag_dtype]
    e_state, e_elem, n_over, n_all = 0.0, 0.0, 0, 0
    for k in init:
        moved = float((p_state[k] - init[k]).norm())
        delta = (k_state[k] - p_state[k]).abs()
        e_state = max(e_state, float(delta.norm()) / max(moved, 1e-30))
        e_elem = max(e_elem, float(delta.max()))
        n_over += int((delta > cfg.lr).sum())
        n_all += delta.numel()
    log(f"[{tag}] {arm}3 steps kernel vs plain on the card: losses "
        f"{', '.join(f'{v:.6f}' for v in k_loss)} vs "
        f"{', '.join(f'{v:.6f}' for v in p_loss)}; max rel err "
        f"{e_loss:.2e} (tol {tol_loss:g}); parameters: max |diff| / "
        f"|moved| {e_state:.2e} (tol {tol_state:g}), max element "
        f"{e_elem:.2e}, {n_over} of {n_all} elements over lr = "
        f"{cfg.lr:g} (tol {tol_share:g} of them)")
    if (e_loss > tol_loss or e_state > tol_state
            or n_over > tol_share * n_all):
        raise AssertionError("kernel and plain train steps disagree")
    return {"loss_rel": e_loss, "moved_rel": e_state, "max_element": e_elem,
            "elements_over_lr": n_over}


@contextlib.contextmanager
def _workdir(root, name):
    """``root/name``, kept for a later phase, when ``root`` is given; else a
    temporary directory."""
    if root is None:
        with tempfile.TemporaryDirectory() as td:
            yield td
    else:
        path = os.path.join(root, name)
        os.makedirs(path)
        yield path


def phase_train(launch_counters, root=None):
    """Two epochs of cli.main on the card, the trained checkpoint served by
    cli.infer, and kernel vs plain train steps from one init.  Returns the
    launch counts, the steps' config and batches, the host times and the
    trained experiment's directory (kept under ``root``)."""
    import csv
    import pickle

    import torch
    from multimodalfusion_tpu_torch.cli import infer, main as cli_main
    from multimodalfusion_tpu_torch.data.bags import PinnedPool
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.engine import train as ttrain
    with _workdir(root, "train") as td:
        t0 = time.perf_counter()
        data_args = _write_train_experiment(td)
        log(f"[train] wrote a 32-subject labelled cohort in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = data_args + [
            "--k", "1", "--max_epochs", "2", "--model_type",
            "path_attention_mil", "--mode", "path", "--gate_path",
            "--drop_out", "--bag_loss", "nll_surv", "--batch_size", "8",
            "--results_dir", os.path.join(td, "results"), "--device", "cuda"]
        for c in launch_counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = cli_main.main(argv)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in launch_counters}
        log(f"[train] cli.main rc={rc} in {time.perf_counter() - t0:.1f} s; "
            f"kernel launches {launches}")
        if rc != 0 or not all(launches.values()):
            raise AssertionError(f"training failed or a kernel of the path "
                                 f"was never launched: rc={rc} {launches}")
        root = os.path.join(td, "results", "brain", "smoke")
        exp = os.path.join(root, os.listdir(root)[0])
        with open(os.path.join(exp, "0", "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        losses = [r[k] for r in recs for k in ("train_loss", "val_loss")]
        log(f"[train] {len(recs)} epochs, losses (train, val) "
            + ", ".join(f"{v:.4f}" for v in losses))
        if len(recs) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"expected 2 epochs of finite losses: "
                                 f"{recs}")
        for name in ("s_0_checkpoint.pt", "s_0_minloss_checkpoint.pt",
                     "summary.csv", "split_train_val_0_results.pkl"):
            if not os.path.exists(os.path.join(exp, name)):
                raise AssertionError(f"cli.main wrote no {name}")

        # serve the trained minloss checkpoint; its validation subjects'
        # risks must match the fold's own evaluation
        out_csv = os.path.join(td, "risks.csv")
        rc = infer.main(["--model_path", exp, "--which_k", "0", "--out",
                         out_csv, "--batch_size", "8", "--device", "cuda"])
        with open(out_csv, newline="") as f:
            served = {r["subject_id"]: float(r["risk"])
                      for r in csv.DictReader(f)}
        with open(os.path.join(exp, "split_train_val_0_results.pkl"),
                  "rb") as f:
            res = pickle.load(f)
        want = np.asarray(res["risk"], np.float64)
        got = np.array([served[s] for s in res["subject_id"]])
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        log(f"[train] cli.infer rc={rc} served {len(served)} subjects from "
            f"the trained checkpoint; validation risks vs the fold's "
            f"evaluation: max rel err {err:.2e} (tol 1e-4)")
        if rc != 0 or len(served) != 32 or not np.isfinite(
                list(served.values())).all() or err > 1e-4:
            raise AssertionError("serving the trained checkpoint failed")

        # kernel vs plain train steps, from one init and the same seeds
        cohort = os.path.join(td, "dataset_csv", "brain", "survival.csv")
        ds = SurvivalDataset(cohort, "path", os.path.join(
            td, "features", "brain"), n_bins=4)
        train_split, _ = ds.load_splits(os.path.join(
            td, "splits", "brain", "smoke", "splits_0.csv"))
        batches, host_ms = _collect_batches(train_split, 8, 3, 3,
                                            PinnedPool())
        cfg = ttrain.TrainConfig(model_type="path_attention_mil",
                                 mode="path", gate_path=True, drop_out=True,
                                 bag_loss="nll_surv", batch_size=8,
                                 device="cuda")
        _steps_agree("train", cfg, batches, launch_counters)
        return launches, cfg, batches, host_ms, exp


# bit patterns planted in [native]'s batch: NaNs of either sign with and
# without payload (the rounding add would carry 0x7F800001 into Inf and
# 0xFFFFFFFF into 0), infinities, exact ties (0x3F808000 rounds down to
# even, 0x3F818000 up), the largest float32 (rounds to Inf), subnormals
NATIVE_PLANTED = (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                  0x7FFFFFFF, 0xFF800001, 0x7F800000, 0xFF800000,
                  0x3F808000, 0x3F818000, 0xBF808000, 0x7F7FFFFF,
                  0xFF7FFFFF, 0x00000001, 0x80008000, 0x007FFFFF)


def _host_ms(fn, reps):
    """(result of the last call, host milliseconds of each of ``reps``
    calls)."""
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def phase_native(launch_counters, train_dir=None, shape=(8, 4096, 1024),
                 reps=5):
    """The host library's f32 -> bf16 cast and parallel reads against their
    plain versions, on a batch shaped like [train]'s and on the bag files
    of [train]'s cohort under ``train_dir`` (written here when None).  No
    kernel may launch.  Returns the host milliseconds of each timing."""
    import torch
    from multimodalfusion_tpu_torch import native
    for c in launch_counters:
        c.launches = 0
    rng = np.random.default_rng(20)
    x = rng.standard_normal(shape, dtype=np.float32)
    bits = x.reshape(-1).view(np.uint32)
    where = rng.choice(bits.size, size=(len(NATIVE_PLANTED), 64),
                       replace=False)
    for pattern, idx in zip(NATIVE_PLANTED, where):
        bits[idx] = pattern
    native.f32_to_bf16(x)  # untimed: the library's load, first page faults
    got, cast_ms = _host_ms(lambda: native.f32_to_bf16(x), reps)
    theirs, torch_ms = _host_ms(
        lambda: torch.from_numpy(x).to(torch.bfloat16), reps)
    plain, plain_ms = _host_ms(lambda: native.f32_to_bf16_plain(x), 1)
    got_bits, plain_bits = got.view(torch.int16), plain.view(torch.int16)
    differ = int((got_bits != plain_bits).sum())
    off = got_bits != theirs.view(torch.int16)
    torch_differ = int(off.sum())
    torch_differ_nan = int((off & torch.from_numpy(np.isnan(x))).sum())
    mb = x.nbytes / 1e6
    times = {"f32_to_bf16": cast_ms, "torch_cast": torch_ms,
             "f32_to_bf16_plain": plain_ms}
    log(f"[native] f32_to_bf16 of {list(shape)} f32 ({mb:.1f} MB, "
        f"{len(NATIVE_PLANTED) * 64} planted NaNs, Infs, ties, maxima and "
        f"subnormals; {os.cpu_count()} host CPUs) vs the plain version: "
        f"{differ} bf16 elements differ (0 allowed); ms over {reps} calls "
        f"(host clock) {', '.join(f'{v:.3f}' for v in cast_ms)}; torch's "
        f"CPU .to(torch.bfloat16) (yardstick, never called by the port) "
        f"{', '.join(f'{v:.3f}' for v in torch_ms)}, which differs on "
        f"{torch_differ} elements, {torch_differ_nan} of them NaNs; plain "
        f"{plain_ms[0]:.3f} ms ({_card()})")
    if differ or got.shape != tuple(shape) or got.dtype != torch.bfloat16:
        raise AssertionError("[native] f32_to_bf16 disagrees with its "
                             "plain version")
    with contextlib.ExitStack() as stack:
        if train_dir is None:
            train_dir = stack.enter_context(tempfile.TemporaryDirectory())
            _write_train_experiment(train_dir)
        bag_dir = os.path.join(train_dir, "features", "brain",
                               "path_pt_files")
        paths = sorted(os.path.join(bag_dir, f) for f in os.listdir(bag_dir))
        sizes = [os.path.getsize(p) for p in paths]
        ms = {native.read_files: [], native.read_files_plain: []}
        out = {}
        for i in range(2 * reps):  # in turns: native, plain, plain, native
            fn = (native.read_files if i % 4 in (0, 3)
                  else native.read_files_plain)
            out[fn], t = _host_ms(lambda: fn(paths, sizes), 1)
            ms[fn] += t
        bufs, want = out[native.read_files], out[native.read_files_plain]
        read_ms, seq_ms = ms[native.read_files], ms[native.read_files_plain]
        same = bufs is not None and want is not None and len(bufs) == len(
            want) and all(b.tobytes() == w.tobytes()
                          for b, w in zip(bufs, want))
    times.update(read_files=read_ms, read_files_plain=seq_ms)
    launches = {c.__name__: c.launches for c in launch_counters}
    log(f"[native] read_files of [train]'s {len(paths)} bag files "
        f"({sum(sizes) / 1e6:.1f} MB, warm in the page cache) vs Python's "
        f"sequential reads: bytes equal {same}; ms (host clock) "
        f"{', '.join(f'{v:.3f}' for v in read_ms)} against "
        f"{', '.join(f'{v:.3f}' for v in seq_ms)}; kernel launches "
        f"{launches} ({_card()})")
    if not same:
        raise AssertionError("[native] read_files disagrees with Python's "
                             "reads")
    if any(launches.values()):
        raise AssertionError(f"[native] launched a kernel: {launches}")
    return times


OMIC_FLAGS = {
    # the published path+omic recipe at the CLI's defaults: tensor fusion,
    # gated pathology attention, attention-branch dropout
    "path_omic": ["--model_type", "mm_attention_mil", "--mode",
                  "path_omic", "--fusion", "tensor", "--gate_path",
                  "--drop_out", "--bag_loss", "nll_surv"],
    "omic": ["--model_type", "max_net", "--mode", "omic", "--bag_loss",
             "cox_surv"],
}


def phase_omic(launch_counters, n_genes=80, root=None):
    """[omic] Stage-2 genomic and path+omic on the card.  A synthetic
    32-subject cohort (bags of 1,000-4,096 instances x 1024, ``n_genes``
    genomic columns as JAX's MMAttentionMIL defaults, small widths) is
    trained one fold for two epochs through cli.main per model, with the
    launch counters reset just before each fold and read just after: the
    path+omic fold launches the forward once per train step and per
    evaluated batch and the backward once per train step; max_net
    launches neither.  The path+omic experiment is served through
    cli.infer (counters reset) and its risks held against the same model
    with the plain pooling at rel 1e-4; max_net's is served too.  Three
    path+omic train steps through the kernels are held against three
    through the plain versions.  Returns ({path: launch counts}, the
    experiments' directories by model, the cohort's CLI arguments), kept
    under ``root``."""
    import csv
    import math

    import torch
    from multimodalfusion_tpu_torch.cli import infer, main as cli_main
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.engine import train as ttrain
    B, epochs, n_subjects, n_val = 8, 2, 32, 8
    with _workdir(root, "omic") as td:
        t0 = time.perf_counter()
        data_args = _write_train_experiment(td, n_subjects, n_val, seed=2,
                                            n_genes=n_genes)
        log(f"[omic] wrote a {n_subjects}-subject labelled cohort with "
            f"{n_genes} genomic columns in {time.perf_counter() - t0:.1f} s")

        def count():
            return {c.__name__: c.launches for c in launch_counters}

        def reset():
            for c in launch_counters:
                c.launches = 0

        launches, exps = {}, {}
        for model, flags in OMIC_FLAGS.items():
            results = os.path.join(td, "results", model)
            reset()
            t0 = time.perf_counter()
            rc = cli_main.main(data_args + flags + [
                "--k", "1", "--max_epochs", str(epochs), "--batch_size",
                str(B), "--results_dir", results, "--device", "cuda"])
            torch.cuda.synchronize()
            launches[f"{model}_train"] = count()
            root = os.path.join(results, "brain", "smoke")
            exps[model] = exp = os.path.join(root, os.listdir(root)[0])
            with open(os.path.join(exp, "0", "metrics.jsonl")) as f:
                recs = [json.loads(x) for x in f]
            losses = [r[k] for r in recs for k in ("train_loss", "val_loss")]
            log(f"[omic] cli.main {' '.join(flags)}: rc={rc} in "
                f"{time.perf_counter() - t0:.1f} s; kernel launches "
                f"{launches[f'{model}_train']}; losses (train, val) "
                + ", ".join(f"{v:.4f}" for v in losses))
            if rc != 0 or len(recs) != epochs or not np.isfinite(
                    losses).all():
                raise AssertionError(f"{model}: training failed: rc={rc} "
                                     f"{recs}")
        steps = -(-(n_subjects - n_val) // B)
        evals = -(-n_val // B)
        want = {"path_omic_train": {
                    "_fused_pool_cuda": epochs * (steps + evals) + 2 * evals,
                    "_fused_pool_bwd_cuda": epochs * steps},
                "omic_train": {c.__name__: 0 for c in launch_counters}}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want} (one forward per train step and "
                                 f"evaluated batch, one backward per train "
                                 f"step; none for max_net)")

        # serve both experiments; the path+omic risks against the same
        # model with the plain pooling on the card
        served = {}
        for model, exp in exps.items():
            out_csv = os.path.join(td, f"risks_{model}.csv")
            reset()
            t0 = time.perf_counter()
            rc = infer.main(["--model_path", exp, "--which_k", "0", "--out",
                             out_csv, "--batch_size", str(B), "--device",
                             "cuda"])
            torch.cuda.synchronize()
            launches[f"{model}_serving"] = count()
            with open(out_csv, newline="") as f:
                served[model] = {r["subject_id"]: float(r["risk"])
                                 for r in csv.DictReader(f)}
            log(f"[omic] cli.infer {model}: rc={rc} in "
                f"{time.perf_counter() - t0:.1f} s, {len(served[model])} "
                f"subjects; kernel launches {launches[f'{model}_serving']}")
            if rc != 0 or len(served[model]) != n_subjects or not all(
                    math.isfinite(v) for v in served[model].values()):
                raise AssertionError(f"serving {model} failed")
        if launches["path_omic_serving"] != {
                "_fused_pool_cuda": -(-n_subjects // B),
                "_fused_pool_bwd_cuda": 0}:
            raise AssertionError(f"serving launches "
                                 f"{launches['path_omic_serving']}")
        plain = _plain_outputs(exps["path_omic"], B)
        got = np.array([served["path_omic"][k] for k in sorted(plain)])
        ref = np.array([float(plain[k]) for k in sorted(plain)])
        err = float(np.max(np.abs(got - ref) / np.abs(ref)))
        log(f"[omic] served path+omic risks vs the plain pooling: max rel "
            f"err {err:.2e} (tol 1e-4)")
        if sorted(plain) != sorted(served["path_omic"]) or err > 1e-4:
            raise AssertionError("served path+omic risks differ from the "
                                 "plain pooling")

        # kernel vs plain train steps of path+omic
        ds = SurvivalDataset(os.path.join(td, "dataset_csv", "brain",
                                          "survival.csv"), "path_omic",
                             os.path.join(td, "features", "brain"),
                             n_bins=4)
        train_split, _ = ds.load_splits(os.path.join(
            td, "splits", "brain", "smoke", "splits_0.csv"))
        batches = []
        for b in iter_batches(train_split, batch_size=B, shuffle=True,
                              seed=3):
            b.pop("subject_ids")
            batches.append(b)
        cfg = ttrain.TrainConfig(
            model_type="mm_attention_mil", mode="path_omic",
            fusion="tensor", gate_path=True, drop_out=True,
            bag_loss="nll_surv", batch_size=B, omic_input_dim=n_genes,
            device="cuda")
        _steps_agree("omic", cfg, batches[:3], launch_counters)
    return launches, exps, data_args


PRETRAINED_FLAGS = {
    # the two stage-4 recipes the phase trains: the Kronecker fusion with
    # the discrete-hazard loss, and the freeze of a missing branch with Cox
    "kronecker": ["--train_type", "kronecker", "--bag_loss", "nll_surv"],
    "multimodal_dropout": ["--train_type", "multimodal-dropout",
                           "--bag_loss", "cox_surv"],
}


def _stage2_for_pretrained(root, n_genes=80):
    """When [pretrained] runs without [train] and [omic]: one epoch each of
    the path AMIL recipe of [train] and the max_net of [omic] on one
    synthetic cohort.  Returns (path experiment, omic experiment, the
    cohort's CLI arguments)."""
    from multimodalfusion_tpu_torch.cli import main as cli_main
    data_args = _write_train_experiment(root, seed=2, n_genes=n_genes)
    exps = {}
    for model, flags in (("path", ["--model_type", "path_attention_mil",
                                   "--mode", "path", "--gate_path",
                                   "--drop_out", "--bag_loss", "nll_surv"]),
                         ("omic", OMIC_FLAGS["omic"])):
        results = os.path.join(root, "results", model)
        rc = cli_main.main(data_args + flags + [
            "--k", "1", "--max_epochs", "1", "--batch_size", "8",
            "--results_dir", results, "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"stage-2 {model} training failed: rc={rc}")
        sub = os.path.join(results, "brain", "smoke")
        exps[model] = os.path.join(sub, os.listdir(sub)[0])
    return exps["path"], exps["omic"], data_args


def phase_pretrained(launch_counters, path_exp=None, omic_exp=None,
                     data_args=None, root=None):
    """[pretrained] Stages 3 and 4 on the card, chained.  Stage 3
    (cli.pre_trained_feature) extracts the 256-d embeddings of the path
    AMIL experiment (from [train]) for 24 of its 32 subjects
    (--extraction_csv_path) and of the max_net experiment (from [omic]),
    counters reset just before each: the path run launches the forward
    once per batch and the backward never, and every embedding matches
    the same model through the plain pooling on the card at rel 1e-4; the
    omic run launches neither.  Stage 4 (cli.main_pretrained,
    mm_attention_mil path_omic, two epochs at B=16) trains a Kronecker nll
    head and a multimodal-dropout cox head on the labelled cohort of
    [omic], where 8 subjects lack a path embedding: every logged loss is
    finite and no kernel launches.  cli.eval_pretrained writes a finite
    c-index for each and an IBS for the nll one; cli.infer serves the
    Kronecker experiment on the card and on the CPU, whose risks agree at
    rel 1e-5.  Returns the launch counts by stage."""
    import csv
    import math

    import torch
    from multimodalfusion_tpu_torch.cli import (eval_pretrained, infer,
                                                main_pretrained,
                                                pre_trained_feature)
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.data.loaders import usable_indices
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.utils.experiment import read_experiment
    B3, B4, n_keep = 8, 16, 24
    wall, launches = {}, {}

    def count():
        return {c.__name__: c.launches for c in launch_counters}

    def reset():
        for c in launch_counters:
            c.launches = 0

    def timed(stage, fn, *args):
        t0 = time.perf_counter()
        rc = fn(*args)
        torch.cuda.synchronize()
        wall[stage] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[pretrained] {stage}: rc={rc}")

    with _workdir(root, "pretrained") as td:
        if path_exp is None:
            t0 = time.perf_counter()
            path_exp, omic_exp, data_args = _stage2_for_pretrained(
                os.path.join(td, "stage2"))
            log(f"[pretrained] trained its own stage-2 path and omic "
                f"experiments in {time.perf_counter() - t0:.1f} s")
        out = os.path.join(td, "pretrained_feature")
        settings = read_experiment(path_exp)
        subjects = SurvivalDataset(settings["csv_path"], "path").patients
        keep = os.path.join(td, "keep.csv")
        with open(keep, "w") as f:
            f.write("subject_id\n" + "".join(
                f"{s}\n" for s in subjects[:n_keep]))

        # stage 3, path: one forward launch per batch, no backward
        reset()
        timed("stage3_path", pre_trained_feature.main, [
            "--checkpoint_path", path_exp, "--which_k", "0", "--output_dir",
            out, "--batch_size", str(B3), "--extraction_csv_path", keep,
            "--device", "cuda"])
        launches["stage3_path"] = count()
        ds = SurvivalDataset(settings["csv_path"], "path",
                             settings["data_root_dir"])
        view = ds.whole_split(os.path.join(settings["split_dir"],
                                           "splits_0.csv"))
        idx = usable_indices(view)
        want = {"_fused_pool_cuda": -(-len(idx) // B3),
                "_fused_pool_bwd_cuda": 0}
        if launches["stage3_path"] != want:
            raise AssertionError(f"stage 3 (path) launched "
                                 f"{launches['stage3_path']}, expected "
                                 f"{want}: one forward per batch")
        path_dir = os.path.join(out, "brain", "path_pt_files")
        written = sorted(os.listdir(path_dir))
        if written != sorted(f"{s}.pt" for s in subjects[:n_keep]):
            raise AssertionError(f"stage 3 (path) wrote {written}")
        plain = _plain_outputs(path_exp, B3, features=True)
        err = max(float(np.abs(load_pt(os.path.join(path_dir, f"{k}.pt"))
                               .reshape(-1) - plain[k]).max()
                        / np.abs(plain[k]).max())
                  for k in subjects[:n_keep])
        log(f"[pretrained] stage 3 (path): {len(written)} embeddings in "
            f"{wall['stage3_path']:.2f} s, launches "
            f"{launches['stage3_path']}; max rel err vs the plain pooling "
            f"{err:.2e} (tol 1e-4)")
        if err > 1e-4:
            raise AssertionError("stage-3 embeddings differ from the plain "
                                 "pooling")

        # stage 3, omic: no kernel
        reset()
        timed("stage3_omic", pre_trained_feature.main, [
            "--checkpoint_path", omic_exp, "--which_k", "0", "--output_dir",
            out, "--batch_size", str(B3), "--device", "cuda"])
        launches["stage3_omic"] = count()
        n_omic = len(os.listdir(os.path.join(out, "brain", "omic_pt_files")))
        log(f"[pretrained] stage 3 (omic): {n_omic} embeddings in "
            f"{wall['stage3_omic']:.2f} s, launches "
            f"{launches['stage3_omic']}")
        if any(launches["stage3_omic"].values()) or n_omic != len(subjects):
            raise AssertionError("stage 3 (omic) failed")

        # stage 4: train, evaluate, serve
        args = list(data_args)
        args[args.index("--data_root_dir") + 1] = out
        exps = {}
        reset()
        for name, flags in PRETRAINED_FLAGS.items():
            results = os.path.join(td, "s4", name)
            timed(f"stage4_train_{name}", main_pretrained.main, args + flags
                  + ["--model_type", "mm_attention_mil", "--mode",
                     "path_omic", "--k", "1", "--max_epochs", "2",
                     "--batch_size", str(B4), "--results_dir", results,
                     "--device", "cuda"])
            sub = os.path.join(results, "brain", "smoke")
            exps[name] = exp = os.path.join(sub, os.listdir(sub)[0])
            with open(os.path.join(exp, "0", "metrics.jsonl")) as f:
                recs = [json.loads(x) for x in f]
            losses = [r[k] for r in recs for k in ("train_loss", "val_loss")]
            log(f"[pretrained] stage 4 {name}: 2 epochs in "
                f"{wall[f'stage4_train_{name}']:.2f} s; losses (train, val) "
                + ", ".join(f"{v:.4f}" for v in losses))
            if len(recs) != 2 or not np.isfinite(losses).all():
                raise AssertionError(f"stage 4 {name}: {recs}")
            timed(f"stage4_eval_{name}", eval_pretrained.main, [
                "--model_path", exp, "--device", "cuda"])
            with open(os.path.join(exp, "eval_summary.csv")) as f:
                row = next(csv.DictReader(f))
            log(f"[pretrained] eval_pretrained {name}: {row} in "
                f"{wall[f'stage4_eval_{name}']:.2f} s")
            if not math.isfinite(float(row["val_cindex"])) or (
                    name == "kronecker"
                    and not math.isfinite(float(row["val_ibs"]))):
                raise AssertionError(f"stage-4 evaluation of {name}: {row}")
        served = {}
        for where in ("cuda", "cpu"):
            out_csv = os.path.join(td, f"risks_{where}.csv")
            timed(f"stage4_serve_{where}", infer.main, [
                "--model_path", exps["kronecker"], "--which_k", "0", "--out",
                out_csv, "--device", where])
            with open(out_csv, newline="") as f:
                served[where] = {r["subject_id"]: float(r["risk"])
                                 for r in csv.DictReader(f)}
        launches["stage4"] = count()
        got = np.array([served["cuda"][k] for k in sorted(served["cpu"])])
        ref = np.array([served["cpu"][k] for k in sorted(served["cpu"])])
        err = float(np.max(np.abs(got - ref) / np.abs(ref)))
        log(f"[pretrained] cli.infer kronecker: {len(got)} subjects, card vs "
            f"CPU max rel err {err:.2e} (tol 1e-5); stage-4 kernel launches "
            f"{launches['stage4']}")
        if sorted(served["cuda"]) != sorted(served["cpu"]) or err > 1e-5 \
                or any(launches["stage4"].values()):
            raise AssertionError("stage-4 serving failed, or stage 4 "
                                 "launched a kernel")
    log("[pretrained] wall s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items())
        + f"; mil_pool_fwd launches in stage 3 (path) "
        f"{launches['stage3_path']['_fused_pool_cuda']}")
    return launches


RADIO_FLAGS = {
    # RadioAMIL small on the 4 glioma sequences, concatenated and reduced
    # (4096 -> 1024), gated attention, attention-branch dropout
    "radio": ["--model_type", "radio_attention_mil", "--mode", "radio",
              "--radio_fusion", "concat", "--gate_radio", "--drop_out",
              "--bag_loss", "nll_surv"],
    # the paper's trimodal model: two attention branches, Kronecker fusion
    "radio_path_omic": ["--model_type", "mm_attention_mil", "--mode",
                        "radio_path_omic", "--fusion", "tensor",
                        "--gate_path", "--gate_radio", "--drop_out",
                        "--bag_loss", "nll_surv"],
    # the sequences fused per slice by a Kronecker product (17^4 = 83,521
    # wide, encoder1 85.5 M parameters)
    "radio_tensor": ["--model_type", "radio_attention_mil", "--mode",
                     "radio", "--radio_fusion", "tensor", "--gate_radio",
                     "--drop_out", "--bag_loss", "nll_surv"],
    # 2 of the sequences fused by a Kronecker product (17^2 = 289 wide),
    # from a copy of the cohort CSV without the other two sequences'
    # columns; its checkpoint is then rewritten as the JAX package writes
    # one (the 4-sequence placeholder in the .pt, the trained fusion in
    # the flax msgpack beside it) and served again
    "radio_tensor_2seq": ["--task", "survival_2seq", "--modality", "T1,T2",
                          "--model_type", "radio_attention_mil", "--mode",
                          "radio", "--radio_fusion", "tensor",
                          "--gate_radio", "--drop_out", "--bag_loss",
                          "nll_surv"],
    # the unimodal path and omic experiments whose embeddings stage 4
    # fuses with the radio ones
    "path": ["--model_type", "path_attention_mil", "--mode", "path",
             "--gate_path", "--drop_out", "--bag_loss", "nll_surv"],
    "omic": ["--model_type", "max_net", "--mode", "omic", "--bag_loss",
             "cox_surv"],
}


def _run_stage(launch_counters, tag, stage, fn, argv, wall, launches,
               want=None, capture=False):
    """``fn(argv)`` (a CLI's main) as stage ``stage`` of phase ``tag``,
    every launch count set to 0 just before it: its seconds (host clock,
    after a device sync) go into ``wall``, its launch counts into
    ``launches``.  Raises on a non-zero rc, or on launch counts other than
    ``want`` where given.  Returns its standard output with ``capture``
    (else it prints), '' otherwise."""
    import torch
    for c in launch_counters:
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    if capture:
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
    else:
        rc = fn(argv)
    torch.cuda.synchronize()
    wall[stage] = time.perf_counter() - t0
    launches[stage] = {c.__name__: c.launches for c in launch_counters}
    if rc != 0 or (want is not None and launches[stage] != want):
        raise AssertionError(f"[{tag}] {stage}: rc={rc}, launches "
                             f"{launches[stage]} (expected {want})\n"
                             f"{buf.getvalue()}")
    return buf.getvalue()


def _serve_and_check(launch_counters, tag, stage, what, exp, csv_path,
                     data_dir, td, want, wall, launches):
    """cli.infer of experiment ``exp`` (fold 0, batches of 8, on the card)
    on ``csv_path``'s subjects with the bags under ``data_dir``, as
    ``_run_stage`` ``stage`` held to the launch counts ``want``; every
    subject served, every risk finite and within rel 1e-4 of the plain
    pooling's on the card (``_plain_outputs``).  Returns ({subject:
    risk}, max rel err)."""
    from multimodalfusion_tpu_torch.cli import infer
    risks = os.path.join(td, f"risks_{stage}.csv")
    _run_stage(launch_counters, tag, stage, infer.main, [
        "--model_path", exp, "--which_k", "0", "--csv", csv_path,
        "--data_root_dir", data_dir, "--out", risks, "--batch_size", "8",
        "--device", "cuda"], wall, launches, want)
    served = {r["subject_id"]: float(r["risk"]) for r in _csv_rows(risks)}
    plain = _plain_outputs(exp, 8, csv_path=csv_path, data_dir=data_dir)
    subjects = sorted(r["subject_id"] for r in _csv_rows(csv_path))
    err = max(abs(served[k] - float(v)) / abs(float(v))
              for k, v in plain.items())
    log(f"[{tag}] cli.infer {what}: {len(served)} subjects in "
        f"{wall[stage]:.2f} s, launches {launches[stage]} (expected "
        f"{want}); risks vs the plain pooling on the card: max rel err "
        f"{err:.2e} (tol 1e-4)")
    if sorted(served) != subjects or sorted(plain) != subjects \
            or not np.isfinite(list(served.values())).all() or err > 1e-4:
        raise AssertionError(f"[{tag}] {stage}: serving {what} failed")
    return served, err


def _plain_outputs(exp, B, features=False, csv_path=None, data_dir=None):
    """The experiment's model (its minloss checkpoint) on every scoreable
    subject of its cohort (or of ``csv_path``'s, with the bags of
    ``data_dir``), pooling through the plain versions on the card:
    {subject: risk}, or {subject: 256-d embedding} with ``features``."""
    import torch
    from multimodalfusion_tpu_torch.cli import infer
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.engine import train as ttrain
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, read_experiment)
    from multimodalfusion_tpu_torch.utils.params import spec_from_config
    dev = torch.device("cuda")
    settings = read_experiment(exp)
    view = infer._scored_split(settings, settings["csv_path"],
                               settings["data_root_dir"], 0)
    cfg = config_from_settings(settings, batch_size=B, omic_input_dim=(
        view.genomic_features.shape[1]))
    if csv_path is not None:
        view = infer._scored_split(settings, csv_path, data_dir, 0)
    model = ttrain.build_model(cfg).to(dev).eval()
    ttrain.load_checkpoint(model, os.path.join(
        exp, "s_0_minloss_checkpoint.pt"), spec_from_config(cfg))
    out = {}
    with torch.no_grad(), _plain_pooling():
        for batch in iter_batches(view, batch_size=B):
            kw = ttrain.model_inputs(cfg, batch, dev)
            if features:
                got = model(**kw, return_features=True).cpu().numpy()
            else:
                got = model(**kw)["risk"].cpu().numpy()
            for sid, v, ok in zip(batch["subject_ids"], got, batch["valid"]):
                if ok:
                    out[sid] = v
    return out


def _two_sequence_task(root):
    """dataset_csv/brain/survival_2seq.csv: the radio cohort's CSV without
    the T1Gd and FLAIR columns (in a cohort read for T1 and T2 they would
    count as genomic columns)."""
    import csv
    src = os.path.join(root, "dataset_csv", "brain", "survival.csv")
    with open(src, newline="") as f:
        rows = list(csv.reader(f))
    keep = [i for i, c in enumerate(rows[0]) if c not in ("T1Gd", "FLAIR")]
    with open(src.replace("survival.csv", "survival_2seq.csv"), "w",
              newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(
            [r[i] for i in keep] for r in rows)


def _as_jax_export(exp):
    """Rewrite the experiment's s_0_minloss_checkpoint.pt as the JAX
    package writes a 2- or 3-sequence tensor-fusion radio model's (JAX
    engine/train.py:420-440, utils/torch_interop.py:80-92): the .pt with
    the reference's 4-sequence radio_xfusion placeholder, and every
    trained parameter, in flax's layout ([in, out] kernels under
    params/...), in the msgpack beside it."""
    import torch
    from multimodalfusion_tpu_torch.utils import msgpack_io
    from multimodalfusion_tpu_torch.utils import params as pm
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, read_experiment)
    settings = read_experiment(exp)
    spec = pm.spec_from_config(config_from_settings(settings))
    pt = os.path.join(exp, "s_0_minloss_checkpoint.pt")
    sd = torch.load(pt, weights_only=True)
    tree = {}
    for entry in spec:
        kind, prefix = entry[0], entry[1]
        pairs = ([(prefix, "kernel", "bias")] if kind == "linear" else
                 pm._attn_pairs(prefix, entry[3], entry[4]))
        node = tree
        for key in entry[2]:
            node = node.setdefault(key, {})
        for tp, w, b in pairs:
            node[w] = sd[f"{tp}.weight"].numpy().T.copy()
            node[b] = sd[f"{tp}.bias"].numpy().copy()
    jspec = [e for e in spec if not e[1].startswith("radio_xfusion.")]
    jsd = pm.reference_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("radio_xfusion.")},
        jspec + [pm.RADIO_XFUSION_PLACEHOLDER])
    torch.save(jsd, pt)
    with open(pt.replace(".pt", ".msgpack"), "wb") as f:
        f.write(msgpack_io.packb({"params": tree}))
    return tuple(jsd["radio_xfusion.encoder1.0.weight"].shape)


def phase_radio(launch_counters, root=None):
    """[radio] Radiology on the card.  A synthetic 32-subject glioma
    cohort (4 MRI sequences x 140-155 common slices x 1024 f32 through the
    port's h5 writer, 80 genomic columns, slides of 500-1,000 instances;
    24 train / 8 validation) and, with the launch counters reset just
    before each run and read just after:
      - cli.main trains RadioAMIL small (concat, gated, dropout, B=8: bag
        batches [8, 256, 4096]) for two epochs: the forward launches once
        per train step and evaluated batch, the backward once per train
        step, every loss finite; three kernel train steps agree with three
        plain ones;
      - cli.infer serves it (one forward per batch), risks against the
        plain pooling on the card at rel 1e-4;
      - cli.pre_trained_feature extracts its radio embeddings (one forward
        per batch), against the plain pooling at rel 1e-4;
      - mm_attention_mil radio_path_omic (tensor fusion, both attention
        nets gated, dropout) trains two epochs: two forwards and two
        backwards per train step;
      - path AMIL and max_net train one epoch each, stage 3 extracts their
        embeddings, and a stage-4 early-fcnn head trains two epochs on the
        port's radio, path and omic embeddings: finite losses, no launch;
      - the Kronecker radiology fusion at full width trains one epoch and
        is served;
      - a 2-sequence Kronecker fusion trains one epoch and is served; its
        checkpoint, rewritten as the JAX package writes it (the
        4-sequence placeholder in the .pt, the trained fusion in the flax
        msgpack beside it), is served again with the same risks.
    Returns (the launch counts by run, the wall seconds by stage, the
    experiments by name: radio, radio_path_omic, omic, stage4)."""
    import csv
    import math

    import torch
    from multimodalfusion_tpu_torch.cli import (infer, main as cli_main,
                                                main_pretrained,
                                                pre_trained_feature)
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.engine import train as ttrain
    B, epochs, n_subjects, n_val = 8, 2, 32, 8
    steps, evals = -(-(n_subjects - n_val) // B), -(-n_val // B)
    wall, launches = {}, {}

    def run(stage, fn, argv):
        _run_stage(launch_counters, "radio", stage, fn, argv, wall, launches)

    def fold(name, flags, n_epochs):
        results = os.path.join(td, "results", name)
        run(f"train_{name}", cli_main.main, data_args + flags + [
            "--k", "1", "--max_epochs", str(n_epochs), "--batch_size",
            str(B), "--results_dir", results, "--device", "cuda"])
        sub = os.path.join(results, "brain", "smoke")
        exp = os.path.join(sub, os.listdir(sub)[0])
        with open(os.path.join(exp, "0", "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        losses = [r[k] for r in recs for k in ("train_loss", "val_loss")]
        log(f"[radio] cli.main {' '.join(flags)}: {n_epochs} epochs in "
            f"{wall[f'train_{name}']:.2f} s; kernel launches "
            f"{launches[f'train_{name}']}; losses (train, val) "
            + ", ".join(f"{v:.4f}" for v in losses))
        if len(recs) != n_epochs or not np.isfinite(losses).all():
            raise AssertionError(f"[radio] {name}: {recs}")
        return exp

    def expect(stage, fwd, bwd):
        want = {"_fused_pool_cuda": fwd, "_fused_pool_bwd_cuda": bwd}
        if launches[stage] != want:
            raise AssertionError(f"[radio] {stage} launched "
                                 f"{launches[stage]}, expected {want}")

    def train_launches(n_epochs, branches=1):
        fwd = n_epochs * (steps + evals) + 2 * evals
        return branches * fwd, branches * n_epochs * steps

    def served_vs_plain(stage, exp):
        out_csv = os.path.join(td, f"risks_{stage}.csv")
        run(stage, infer.main, ["--model_path", exp, "--which_k", "0",
                                "--out", out_csv, "--batch_size", str(B),
                                "--device", "cuda"])
        with open(out_csv, newline="") as f:
            served = {r["subject_id"]: float(r["risk"])
                      for r in csv.DictReader(f)}
        plain = _plain_outputs(exp, B)
        err = max(abs(served[k] - float(v)) / abs(float(v))
                  for k, v in plain.items())
        log(f"[radio] cli.infer {stage}: {len(served)} subjects in "
            f"{wall[stage]:.2f} s, kernel launches {launches[stage]}; risks "
            f"vs the plain pooling on the card: max rel err {err:.2e} "
            f"(tol 1e-4)")
        if sorted(served) != sorted(plain) or len(served) != n_subjects \
                or not all(math.isfinite(v) for v in served.values()) \
                or err > 1e-4:
            raise AssertionError(f"[radio] serving {stage} failed")

    with _workdir(root, "radio") as td:
        t0 = time.perf_counter()
        data_args = _write_train_experiment(
            td, n_subjects, n_val, seed=4, n_genes=80, bag_range=(500, 1001),
            radio_slices=155)
        wall["write_cohort"] = time.perf_counter() - t0
        ds = SurvivalDataset(os.path.join(td, "dataset_csv", "brain",
                                          "survival.csv"), "radio",
                             os.path.join(td, "features", "brain"), n_bins=4)
        common = [ds.get_sample(i).radio.shape[0] for i in range(len(ds))]
        log(f"[radio] wrote a {n_subjects}-subject glioma cohort (4 "
            f"sequences, {min(common)}-{max(common)} common slices, 80 "
            f"genomic columns) in {wall['write_cohort']:.2f} s")
        if min(common) < 140 or max(common) > 155:
            raise AssertionError(f"common slices {common}")

        # RadioAMIL, concat: train, kernel vs plain steps, serve, stage 3
        exp = fold("radio", RADIO_FLAGS["radio"], epochs)
        expect("train_radio", *train_launches(epochs))
        train_split, _ = ds.load_splits(os.path.join(
            td, "splits", "brain", "smoke", "splits_0.csv"))
        batches = []
        for b in iter_batches(train_split, batch_size=B, shuffle=True,
                              seed=3):
            b.pop("subject_ids")
            batches.append(b)
        if batches[0]["radio_bags"].shape != (B, 256, 4096):
            raise AssertionError(f"radio batch "
                                 f"{batches[0]['radio_bags'].shape}")
        cfg = ttrain.TrainConfig(model_type="radio_attention_mil",
                                 mode="radio", radio_fusion="concat",
                                 gate_radio=True, drop_out=True,
                                 bag_loss="nll_surv", batch_size=B,
                                 device="cuda")
        _steps_agree("radio", cfg, batches[:3], launch_counters)
        served_vs_plain("serve_radio", exp)
        expect("serve_radio", -(-n_subjects // B), 0)
        out = os.path.join(td, "pretrained_feature")
        run("stage3_radio", pre_trained_feature.main, [
            "--checkpoint_path", exp, "--which_k", "0", "--output_dir", out,
            "--batch_size", str(B), "--device", "cuda"])
        expect("stage3_radio", -(-n_subjects // B), 0)
        radio_dir = os.path.join(out, "brain", "radio_pt_files")
        plain = _plain_outputs(exp, B, features=True)
        err = max(float(np.abs(load_pt(os.path.join(radio_dir, f"{k}.pt"))
                               .reshape(-1) - v).max() / np.abs(v).max())
                  for k, v in plain.items())
        log(f"[radio] stage 3 (radio): {len(os.listdir(radio_dir))} "
            f"embeddings in {wall['stage3_radio']:.2f} s, launches "
            f"{launches['stage3_radio']}; max rel err vs the plain pooling "
            f"{err:.2e} (tol 1e-4)")
        if len(os.listdir(radio_dir)) != n_subjects or err > 1e-4:
            raise AssertionError("stage-3 radio embeddings differ from the "
                                 "plain pooling")

        # the trimodal fusion: two attention branches per step
        rpo = fold("radio_path_omic", RADIO_FLAGS["radio_path_omic"], epochs)
        expect("train_radio_path_omic", *train_launches(epochs, 2))

        exps = {"radio": exp}
        # stage 4 on the port's own radio, path and omic embeddings
        for m in ("path", "omic"):
            exps[m] = sub_exp = fold(m, RADIO_FLAGS[m], 1)
            run(f"stage3_{m}", pre_trained_feature.main, [
                "--checkpoint_path", sub_exp, "--which_k", "0",
                "--output_dir", out, "--batch_size", str(B), "--device",
                "cuda"])
        args = list(data_args)
        args[args.index("--data_root_dir") + 1] = out
        results = os.path.join(td, "s4")
        run("stage4_early_fcnn", main_pretrained.main, args + [
            "--model_type", "mm_attention_mil", "--mode", "radio_path_omic",
            "--train_type", "early-fcnn", "--bag_loss", "nll_surv", "--k",
            "1", "--max_epochs", "2", "--batch_size", "16", "--results_dir",
            results, "--device", "cuda"])
        sub = os.path.join(results, "brain", "smoke")
        exps.update(radio_path_omic=rpo,
                    stage4=os.path.join(sub, os.listdir(sub)[0]))
        with open(os.path.join(exps["stage4"], "0", "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        losses = [r[k] for r in recs for k in ("train_loss", "val_loss")]
        log(f"[radio] stage 4 early-fcnn radio_path_omic on the port's "
            f"embeddings: 2 epochs in {wall['stage4_early_fcnn']:.2f} s, "
            f"launches {launches['stage4_early_fcnn']}; losses (train, val) "
            + ", ".join(f"{v:.4f}" for v in losses))
        expect("stage4_early_fcnn", 0, 0)
        if len(recs) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"[radio] stage 4: {recs}")

        # the Kronecker fusion of the 4 sequences at full width
        torch.cuda.reset_peak_memory_stats()
        exp = fold("radio_tensor", RADIO_FLAGS["radio_tensor"], 1)
        expect("train_radio_tensor", *train_launches(1))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        served_vs_plain("serve_radio_tensor", exp)
        expect("serve_radio_tensor", -(-n_subjects // B), 0)
        log(f"[radio] tensor fusion: peak device memory {peak:.2f} GiB in "
            f"its training epoch")

        # 2 sequences, tensor fusion: the port's checkpoint, then the JAX
        # export's layout of the same weights
        _two_sequence_task(td)
        exp = fold("radio_tensor_2seq", RADIO_FLAGS["radio_tensor_2seq"], 1)
        expect("train_radio_tensor_2seq", *train_launches(1))
        served_vs_plain("serve_radio_tensor_2seq", exp)
        expect("serve_radio_tensor_2seq", -(-n_subjects // B), 0)
        placeholder = _as_jax_export(exp)
        out_csv = os.path.join(td, "risks_jax_layout.csv")
        run("serve_radio_tensor_2seq_jax_layout", infer.main, [
            "--model_path", exp, "--which_k", "0", "--out", out_csv,
            "--batch_size", str(B), "--device", "cuda"])
        expect("serve_radio_tensor_2seq_jax_layout", -(-n_subjects // B), 0)
        served = {}
        for name in ("risks_serve_radio_tensor_2seq.csv",
                     "risks_jax_layout.csv"):
            with open(os.path.join(td, name), newline="") as f:
                served[name] = {r["subject_id"]: float(r["risk"])
                                for r in csv.DictReader(f)}
        own, jax_layout = served.values()
        err = max(abs(jax_layout[k] - v) / abs(v) for k, v in own.items())
        log(f"[radio] 2-sequence tensor fusion in the JAX export's layout "
            f"(.pt radio_xfusion.encoder1 {placeholder}, the trained fusion "
            f"from the msgpack): {len(jax_layout)} subjects served in "
            f"{wall['serve_radio_tensor_2seq_jax_layout']:.2f} s, launches "
            f"{launches['serve_radio_tensor_2seq_jax_layout']}; risks vs the "
            f"port's own checkpoint: max rel err {err:.2e} (tol 1e-6)")
        if sorted(jax_layout) != sorted(own) or err > 1e-6:
            raise AssertionError("[radio] the JAX layout of the 2-sequence "
                                 "tensor experiment serves other risks")
    log("[radio] wall s: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in wall.items()))
    return launches, wall, exps


# the glioma cohort of [extract]: the SRI24 grid of TCGA-GBM/LGG and BraTS
# volumes (155 x 240 x 240 at 1 mm), in cli.feature_extraction's sequence
# order; and a lung CT series (60 slices of 512 x 512, 2.5 mm x 0.7 mm)
GLIOMA_SEQS = ("FLAIR", "T1", "T1Gd", "T2")
GLIOMA_GRID = (155, 240, 240)
LUNG_SERIES = (60, 512, 512)
LUNG_SPACING = (2.5, 0.7, 0.7)


def _seeded_resnet(seed):
    """A torchvision-layout ResNet50 trunk state_dict from a CPU
    torch.Generator: normal convs at the scale of torch's default init
    (std 1 / sqrt(3 fan_in)), BatchNorm weights in [0.8, 1.2], biases and
    running means near 0, running variances in [0.5, 1.5]."""
    import math

    import torch
    from multimodalfusion_tpu_torch.models.resnet import ResNet50Trunc
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNet50Trunc().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 4:
            w = torch.randn(v.shape, generator=g) / math.sqrt(
                3 * v[0].numel())
        elif k.endswith("running_var"):
            w = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("weight"):
            w = torch.rand(v.shape, generator=g) * 0.4 + 0.8
        else:
            w = torch.randn(v.shape, generator=g) * 0.05
        sd[k] = w
    return sd


def _write_glioma_cohort(root, sids, seed, grid=GLIOMA_GRID):
    """Each subject's four MRI sequences: an ellipsoidal brain of
    int16 intensities (a contrast per sequence) on a black background, in
    the reference layout radio_dir/<subject>/<file>, FLAIR as .nii.gz
    and the others as .nii, through the port's NIfTI writer, eight
    volumes at a time.  Returns (radio_dir, csv_path)."""
    from concurrent.futures import ThreadPoolExecutor
    from multimodalfusion_tpu_torch.data.nifti import write_nifti
    radio_dir = os.path.join(root, "glioma_scans")

    def volume(sid, k, seed):
        rng = np.random.default_rng(seed)
        Z, Y, X = grid
        zz, yy, xx = np.ogrid[:Z, :Y, :X]
        c = rng.normal([Z / 2, Y / 2, X / 2], 2)
        r = rng.uniform([0.44, 0.36, 0.3], [0.47, 0.4, 0.34]) * grid
        brain = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                 + ((xx - c[2]) / r[2]) ** 2) <= 1
        vol = np.where(brain, rng.integers(100 + 80 * k, 900 + 120 * k,
                                           grid, dtype=np.int16), 0)
        name = f"{sid}_{GLIOMA_SEQS[k]}.nii" + (".gz" if k == 0 else "")
        write_nifti(os.path.join(radio_dir, sid, name), vol.astype(np.int16),
                    origin_lps=(0.0, -239.0, 0.0))
        return name

    for sid in sids:
        os.makedirs(os.path.join(radio_dir, sid))
    # a subject's sequences share one brain: one seed per subject
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31, len(sids))
    with ThreadPoolExecutor(8) as ex:
        names = list(ex.map(lambda a: volume(*a),
                            [(sid, k, int(s)) for sid, s in zip(sids, seeds)
                             for k in range(4)]))
    csv_path = os.path.join(root, "glioma.csv")
    with open(csv_path, "w") as f:
        f.write("subject_id," + ",".join(GLIOMA_SEQS) + "\n")
        for i, sid in enumerate(sids):
            f.write(sid + "," + ",".join(names[4 * i:4 * i + 4]) + "\n")
    return radio_dir, csv_path


def _lung_hu(seed, shape=LUNG_SERIES):
    """A chest CT in Hounsfield units: outside air, an elliptical body of
    soft tissue, two ellipsoidal lungs joined by an airway, noise."""
    rng = np.random.default_rng(seed)
    Z, H, W = shape
    zz, yy, xx = np.ogrid[:Z, :H, :W]
    vol = np.full(shape, -1000, np.int16)
    body = (((yy - H / 2) / (H * 0.42)) ** 2
            + ((xx - W / 2) / (W * 0.45)) ** 2) <= 1
    vol[np.broadcast_to(body, shape)] = 40
    lungs = np.zeros(shape, bool)
    for cx in (0.32, 0.68):
        lungs |= (((zz - Z / 2) / (Z * 0.45)) ** 2
                  + ((yy - H / 2) / (H * 0.28)) ** 2
                  + ((xx - W * cx) / (W * 0.13)) ** 2) <= 1
    lungs[Z // 2 - 2:Z // 2 + 2, H // 2 - 3:H // 2 + 3,
          int(W * 0.32):int(W * 0.68)] = True
    vol[lungs & body] = -850
    return vol + rng.integers(-20, 21, shape).astype(np.int16)


def _write_lung_cohort(root, series, shape=LUNG_SERIES):
    """One DICOM series per (subject, seed, compression) of ``series``
    through the port's writer (stored value HU + 1024, intercept -1024),
    slices written eight at a time, a JPEG 2000 series' one at a time (its
    C++ tier 1 already runs on every host thread).  Returns (radio_dir,
    csv_path, the HU volumes, the seconds each series took to write)."""
    from concurrent.futures import ThreadPoolExecutor
    from multimodalfusion_tpu_torch.data import dicom
    radio_dir = os.path.join(root, "lung_scans")
    vols, seconds = {}, {}
    for sid, seed, compression in series:
        vols[sid] = _lung_hu(seed, shape)
        d = os.path.join(radio_dir, sid, "ct")
        os.makedirs(d)
        jobs = [(os.path.join(d, f"{z:03d}.dcm"), vols[sid][z], z)
                for z in range(shape[0])]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1 if compression == "jpeg2000" else 8) as ex:
            list(ex.map(lambda j: dicom.write_ct_slice(
                j[0], j[1] + 1024, z=LUNG_SPACING[0] * j[2],
                spacing=LUNG_SPACING[1:], thickness=LUNG_SPACING[0],
                intercept=-1024.0, compression=compression), jobs))
        seconds[sid] = time.perf_counter() - t0
    csv_path = os.path.join(root, "lung.csv")
    with open(csv_path, "w") as f:
        f.write("subject_id,CT\n" + "".join(f"{s},ct\n"
                                            for s, _, _ in series))
    return radio_dir, csv_path, vols, seconds


def _j2k_decode_parts(data):
    """``j2k.decode``'s steps on a one-tile file, timed apart on the host
    clock: the container, markers and packet headers (tier 2, Python),
    tier 1 (C++, every host thread), and the reconstruction (numpy
    dequantisation and colour, the inverse DWT in C++, PIL's mapping).
    Returns (pixels, {part: seconds})."""
    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.utils import j2k
    t0 = time.perf_counter()
    ct = j2k.parse_container(data)
    stream = j2k.parse_codestream(ct.codestream)
    mode = j2k.pil_mode(ct, stream.siz)
    (tile,) = j2k.prepare_tiles(stream)
    t1 = time.perf_counter()
    native.j2k_decode_blocks(tile.jobs, 0)
    t2 = time.perf_counter()
    px = j2k.pil_pixels(j2k.reconstruct(
        tile, stream.siz, lambda plane, tc: native.j2k_idwt(plane, tc, 0)),
        stream.siz, mode)
    t3 = time.perf_counter()
    return px, {"tier 2": t1 - t0, "tier 1": t2 - t1,
                "reconstruction": t3 - t2}


def _check_j2k_twin(l_dir, features, j2k_sid, twin_sid, lung_hu):
    """[extract]'s JPEG 2000 series: read back (host clock, C++ tier 1 on
    every host thread) to the HU volume written; its stage-1 features
    against its uncompressed twin's; one 512 x 512 frame decoded by C++
    and by the plain version, in ms per megapixel."""
    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.data import ct_preprocess
    from multimodalfusion_tpu_torch.data.io import load_features_h5
    from multimodalfusion_tpu_torch.utils import j2k
    native.j2k_decode_blocks.calls = 0
    t0 = time.perf_counter()
    hu = ct_preprocess.get_pixels_hu(ct_preprocess.load_scan(
        os.path.join(l_dir, j2k_sid, "ct")))
    read_s = time.perf_counter() - t0
    calls = native.j2k_decode_blocks.calls
    if not np.array_equal(hu, lung_hu[j2k_sid]) or calls != len(hu):
        raise AssertionError(f"[extract] the JPEG 2000 series does not read "
                             f"back to the volume written ({calls} tier-1 "
                             f"calls for {len(hu)} slices)")
    (f_j2k, s_j2k), (f_twin, s_twin) = (
        load_features_h5(os.path.join(features, "lung", "radio_h5_files",
                                      "CT", f"{sid}.h5"))
        for sid in (j2k_sid, twin_sid))
    bitwise = np.array_equal(f_j2k, f_twin) and np.array_equal(s_j2k, s_twin)
    diff = float(np.abs(f_j2k.astype(np.float64) - f_twin).max())
    if not np.array_equal(s_j2k, s_twin) or not np.allclose(
            f_j2k, f_twin, rtol=2e-3, atol=2e-4):
        raise AssertionError(f"[extract] the J2K series' features differ "
                             f"from its twin's: max |d| {diff:.3e}")
    frame = j2k.encode((lung_hu[j2k_sid][0] + 1024).astype(np.int16)
                       .view(np.uint16))
    mp = LUNG_SERIES[1] * LUNG_SERIES[2] / 1e6
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fast = j2k.decode(frame)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = j2k.decode(frame, plain=True)
    plain_s = time.perf_counter() - t0
    runs = [_j2k_decode_parts(frame) for _ in range(5)]
    if not all(np.array_equal(px, fast) for px, _ in runs):
        raise AssertionError("[extract] the JPEG 2000 decode's parts, run "
                             "apart, give other pixels than j2k.decode")
    parts = {k: min(p[k] for _, p in runs) for k in runs[0][1]}
    log(f"[extract] J2K decode of one lung frame by parts (host clock, "
        f"best of 5, {_card()}): " + ", ".join(
            f"{k} {v * 1e3:.3f} ms ({v / sum(parts.values()):.1%})"
            for k, v in parts.items()))
    if not np.array_equal(fast, plain):
        raise AssertionError("[extract] the C++ and plain JPEG 2000 "
                             "decoders differ on a lung frame")
    log(f"[extract] {j2k_sid}: read back (load_scan, get_pixels_hu) in "
        f"{read_s:.3f} s to the HU volume written, {calls} tier-1 calls; "
        f"its features vs its uncompressed twin {twin_sid}'s: bit for bit "
        f"{bitwise}, max |d| {diff:.3e} (tol rtol 2e-3 / atol 2e-4); J2K "
        f"decode of one {LUNG_SERIES[1]} x {LUNG_SERIES[2]} frame "
        f"({len(frame)} bytes) on the host ({_card()}): C++ "
        f"{min(times) * 1e3 / mp:.3f} ms/MP ({os.cpu_count()} threads, best "
        f"of 5), plain {plain_s * 1e3 / mp:.1f} ms/MP (one thread), C++ = "
        f"plain bit for bit")
    return bitwise


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images_per_s(fn, n, reps=3):
    """Images per second of ``fn`` (n images a call), CUDA events around
    each of ``reps`` calls after one warm-up call; the best of them."""
    import torch
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    return n / best


def phase_extract(launch_counters, radio_exp, root=None, n_glioma=8,
                  n_lung=2):
    """[extract] Radiology stage 1 on the card, through
    cli.feature_extraction, then served:
      - a glioma cohort (``n_glioma`` subjects x 4 sequences of 155 x 240
        x 240 int16 NIfTI, FLAIR gzipped) and a lung cohort (``n_lung``
        DICOM series of 60 x 512 x 512 int16, the first uncompressed, the
        others JPEG Lossless SV1, and a JPEG 2000 Lossless twin of the
        first, ``write_ct_slice(compression="jpeg2000")``), through the
        port's writers;
      - both extracted on the card in bf16 (the CLI's default) with
        seeded --weights, TF32 left at torch's default (on): no pooling
        kernel launches, the C++ JPEG and JPEG 2000 decoders decode every
        compressed slice (one ``native.j2k_decode_blocks`` call a J2K
        slice), every h5 and .pt is written and finite, the JPEG and J2K
        series read back to the HU volumes written, the J2K twin's
        features equal its uncompressed twin's (bit for bit expected: the
        same pixels; else rtol 2e-3 / atol 2e-4, the ResNet tolerance),
        its J2K decode ms per megapixel (C++, all host threads; plain, one
        512 x 512 frame);
      - the slice inputs made on the card equal the host path bit for bit;
        the first 8 slices of one scan in f32 on the card (the embedder
        turns TF32 off) against the CPU at rel (Frobenius) 1e-3; the
        card's bf16 features of that scan against its f32 ones at 2e-2;
      - Embedder.embed_images at 224 x 224, batch 128, bf16 and f32:
        images per second (uint8 images from the host, and the trunk
        alone on the card) beside the bound of the convolutions' 6.556
        GFLOP per image over the type's peak; a scan's short last chunk
        at its own size or padded to the batch, with and without cuDNN's
        autotuning;
      - cli.infer serves the glioma features with [radio]'s RadioAMIL
        experiment (its stage-2 layout reads {root}/brain, a symlink to
        the CLI's {root}/glioma), one forward launch per batch, risks
        against the plain pooling on the card at rel 1e-4; then the lung
        J2K series and its uncompressed twin (their CT bag linked as each
        of the four sequences): one forward launch, the two risks equal
        to each other and to the plain pooling's at rel 1e-4.
    Returns the launch counts by run and what [gradcam] reads: the glioma
    and lung scans, their ids, the extracted features and the weights
    (kept under ``root``)."""
    import io

    import torch
    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.cli import feature_extraction
    from multimodalfusion_tpu_torch.data import ct_preprocess
    from multimodalfusion_tpu_torch.data.io import load_features_h5, load_pt
    from multimodalfusion_tpu_torch.data.radiology import (
        preprocess_glioma_scan, slices_to_rgb)
    from multimodalfusion_tpu_torch.extract.features import (Embedder,
                                                             _fit_spatial)
    from multimodalfusion_tpu_torch.models import resnet
    wall, launches = {}, {}
    none = {c.__name__: 0 for c in launch_counters}

    def count():
        return {c.__name__: c.launches for c in launch_counters}

    with _workdir(root, "extract") as td:
        t0 = time.perf_counter()
        glioma_ids = [f"TCGA-GL-{i:04d}" for i in range(n_glioma)]
        lung_ids = [f"LUNG-{i:03d}" for i in range(n_lung)]
        # the JPEG 2000 series: the first series' volume again
        j2k_sid, twin_sid = "LUNG-J2K", lung_ids[0]
        g_dir, g_csv = _write_glioma_cohort(td, glioma_ids, seed=31)
        l_dir, l_csv, lung_hu, lung_s = _write_lung_cohort(td, [
            (sid, 41 + i, "jpeg_lossless" if i else None)
            for i, sid in enumerate(lung_ids)] + [(j2k_sid, 41, "jpeg2000")])
        lung_ids = lung_ids + [j2k_sid]
        state = _seeded_resnet(7)
        weights = os.path.join(td, "resnet50_seeded.pt")
        torch.save(state, weights)
        wall["write_cohorts"] = time.perf_counter() - t0
        log(f"[extract] wrote {n_glioma} glioma subjects x 4 sequences of "
            f"{GLIOMA_GRID} int16 NIfTI and {n_lung + 1} lung DICOM series "
            f"of {LUNG_SERIES} int16 ({n_lung - 1} JPEG Lossless SV1, "
            f"{j2k_sid} JPEG 2000 Lossless, the twin of {twin_sid}) in "
            f"{wall['write_cohorts']:.2f} s; the JPEG 2000 series written "
            f"in {lung_s[j2k_sid]:.3f} s (one slice at a time, C++ tier 1 "
            f"on {os.cpu_count()} host threads), its uncompressed twin in "
            f"{lung_s[twin_sid]:.3f} s (8 slices at a time)")

        out = os.path.join(td, "features")
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # torch's default
        try:
            summaries = {}
            for cancer, radio_dir, csv_path in (("glioma", g_dir, g_csv),
                                                ("lung", l_dir, l_csv)):
                for c in launch_counters:
                    c.launches = 0
                native.jpeg_lossless_decode.calls = 0
                native.j2k_decode_blocks.calls = 0
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = feature_extraction.main([
                        "--radio_dir", radio_dir, "--csv_path", csv_path,
                        "--output_dir", out, "--cancer_type", cancer,
                        "--weights", weights, "--device", "cuda"])
                torch.cuda.synchronize()
                wall[f"extract_{cancer}"] = time.perf_counter() - t0
                launches[cancer] = count()
                text = buf.getvalue()
                summaries[cancer] = [x for x in text.splitlines()
                                     if x.startswith("stage 1 wall s")][0]
                decodes = native.jpeg_lossless_decode.calls
                j2k_decodes = native.j2k_decode_blocks.calls
                log(f"[extract] cli.feature_extraction {cancer} (bf16): "
                    f"{summaries[cancer]}; pooling launches "
                    f"{launches[cancer]}; C++ JPEG decodes {decodes}, C++ "
                    f"JPEG 2000 tier-1 calls {j2k_decodes}")
                if rc != 0 or "FAILED" in text or launches[cancer] != none:
                    raise AssertionError(f"[extract] {cancer}: rc={rc}\n"
                                         f"{text}")
                want_decodes = (n_lung - 1) * LUNG_SERIES[0] \
                    if cancer == "lung" else 0
                want_j2k = LUNG_SERIES[0] if cancer == "lung" else 0
                if decodes != want_decodes or j2k_decodes != want_j2k:
                    raise AssertionError(
                        f"[extract] {decodes} C++ JPEG decodes and "
                        f"{j2k_decodes} JPEG 2000 tier-1 calls, expected "
                        f"{want_decodes} and {want_j2k}")
            # every file written, finite, slice ids increasing
            n_h5 = 0
            for cancer, seqs, ids in (("glioma", GLIOMA_SEQS, glioma_ids),
                                      ("lung", ("CT",), lung_ids)):
                for seq in seqs:
                    for sid in ids:
                        h5 = os.path.join(out, cancer, "radio_h5_files", seq,
                                          f"{sid}.h5")
                        f, si = load_features_h5(h5)
                        pt = load_pt(h5.replace("radio_h5_files",
                                                "radio_pt_files")
                                     .replace(".h5", ".pt"))
                        if (f.shape != (len(si), 1024) or len(si) < 50
                                or si.dtype != np.int64
                                or not np.all(np.diff(si) > 0)
                                or not np.isfinite(f).all()
                                or not np.array_equal(pt, f)):
                            raise AssertionError(f"[extract] {h5}: "
                                                 f"{f.shape} {si}")
                        n_h5 += 1
            # the JPEG series again, step by step as preprocess_lung_scan
            # runs it (its orientation is the identity), on the host clock
            jpeg_sid = lung_ids[n_lung - 1]
            t = [time.perf_counter()]
            series = ct_preprocess.load_scan(os.path.join(l_dir, jpeg_sid,
                                                          "ct"))
            hu = ct_preprocess.get_pixels_hu(series)
            t.append(time.perf_counter())
            if not np.array_equal(hu, lung_hu[jpeg_sid]):
                raise AssertionError("[extract] the JPEG series does not "
                                     "read back to the volume written")
            vol = np.maximum(hu, -1000)
            res, _ = ct_preprocess.resample(
                vol, (float(series[0].SliceThickness),
                      *map(float, series[0].PixelSpacing)), (1.0, 1.5, 1.5))
            t.append(time.perf_counter())
            seg = ct_preprocess.lung_mask(res)
            t.append(time.perf_counter())
            ct_preprocess.largest_lung_box(res, seg)
            t.append(time.perf_counter())
            steps = np.diff(t)
            log(f"[extract] {n_h5} h5 files (and their .pt copies) finite, "
                f"slice ids increasing; the JPEG Lossless series reads back "
                f"to the HU volume written.  Its host preprocessing, step by "
                f"step (s): read and decode {steps[0]:.3f}, cubic resample "
                f"to {res.shape} {steps[1]:.3f}, lung segmentation "
                f"{steps[2]:.3f}, boxes {steps[3]:.3f}")
            twins_bitwise = _check_j2k_twin(l_dir, out, j2k_sid, twin_sid,
                                            lung_hu)

            # card against the host and the CPU, on one glioma scan
            scan = os.path.join(g_dir, glioma_ids[0],
                                f"{glioma_ids[0]}_T1.nii")
            slices, ids = preprocess_glioma_scan(scan)
            gpu32 = Embedder(state_dict=state, dtype="float32")
            cpu32 = Embedder(state_dict=state, dtype="float32", device="cpu")
            host = resnet.preprocess_images(torch.from_numpy(_fit_spatial(
                slices_to_rgb(slices[:8]), 224)))
            same_inputs = torch.equal(gpu32.slice_inputs(slices[:8]).cpu(),
                                      host)
            tf32_outside = torch.backends.cudnn.allow_tf32
            with gpu32._compute():
                tf32_inside = torch.backends.cudnn.allow_tf32
            e_cpu = _rel_fro(gpu32.embed_slices(slices[:8]),
                             cpu32.embed_slices(slices[:8]))
            f32 = gpu32.embed_slices(slices)
            bf16, h5_ids = load_features_h5(os.path.join(
                out, "glioma", "radio_h5_files", "T1",
                f"{glioma_ids[0]}.h5"))
            e_bf16 = _rel_fro(bf16, f32)
            log(f"[extract] {glioma_ids[0]} T1 ({len(ids)} slices): card "
                f"slice inputs equal the host path's bit for bit: "
                f"{same_inputs}; f32 card vs CPU (first 8 slices, TF32 "
                f"{tf32_inside} inside the f32 embedder, {tf32_outside} "
                f"outside): "
                f"rel {e_cpu:.2e} (tol 1e-3); bf16 (the CLI's h5) vs f32 on "
                f"the card: rel {e_bf16:.2e} (tol 2e-2)")
            if not same_inputs or tf32_inside or e_cpu > 1e-3 \
                    or e_bf16 > 2e-2 or not np.array_equal(h5_ids, ids):
                raise AssertionError("[extract] card vs CPU or bf16 vs f32")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

        # throughput beside the bound of the trunk's convolutions
        flops = resnet.conv_flops(resnet.ResNet50Trunc())
        imgs = np.random.default_rng(5).integers(0, 256, (1024, 224, 224, 3),
                                                 dtype=np.uint8)
        for dtype in ("bfloat16", "float32"):
            emb = Embedder(state_dict=state, dtype=dtype, batch_size=128)
            x = emb._prepare_images(torch.from_numpy(imgs[:128]).cuda())

            def trunk():
                with torch.inference_mode(), emb._compute():
                    emb.model(x)
            bound = PEAK_FLOPS[dtype] / flops
            r = {"embed_images": _images_per_s(
                     lambda: emb.embed_images(imgs), len(imgs)),
                 "trunk": _images_per_s(trunk, 128, reps=5)}
            log(f"[extract] {dtype} batch 128 at 224 x 224: embed_images "
                f"(uint8 from the host) {r['embed_images']:.0f} images/s "
                f"({1e6 / r['embed_images']:.2f} us an image, "
                f"{r['embed_images'] / bound:.1%} of the bound), trunk on "
                f"the card {r['trunk']:.0f} images/s "
                f"({1e6 / r['trunk']:.2f} us, {r['trunk'] / bound:.1%}); "
                f"bound {bound:.0f} images/s ({1e6 / bound:.2f} us) = "
                f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s / "
                f"{flops / 1e9:.3f} GFLOP per image")
        if abs(flops / 6.556e9 - 1) > 5e-4:
            raise AssertionError(f"[extract] {flops} conv FLOP per image")

        # a scan's short last chunk at its own size (the embedder's way) or
        # padded with black slices to the batch (JAX's way), with cuDNN's
        # autotuning off (torch's default) and on, on three scans
        scans = [preprocess_glioma_scan(os.path.join(
            g_dir, sid, f"{sid}_T2.nii"))[0] for sid in glioma_ids[1:4]]
        emb = Embedder(state_dict=state)
        bench = torch.backends.cudnn.benchmark
        try:
            for pad, autotune in ((False, False), (True, False),
                                  (True, True), (False, True)):
                torch.backends.cudnn.benchmark = autotune
                times = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    for sl in scans:
                        if pad:
                            sl = np.concatenate([sl, np.zeros(
                                (-len(sl) % 128,) + sl.shape[1:],
                                sl.dtype)])
                        emb.embed_slices(sl)
                    times.append(time.perf_counter() - t0)
                log(f"[extract] bf16 embed_slices of 3 scans "
                    f"({'+'.join(str(len(sl)) for sl in scans)} slices), "
                    f"{'padded to 128' if pad else 'unpadded'}, cuDNN "
                    f"autotuning {'on' if autotune else 'off'}: first "
                    f"{times[0] * 1e3:.1f} ms, again {times[1] * 1e3:.1f} ms")
        finally:
            torch.backends.cudnn.benchmark = bench

        # serving: the [radio] experiment on the extracted features
        os.symlink(os.path.join(out, "glioma"), os.path.join(out, "brain"))
        served, _ = _serve_and_check(
            launch_counters, "extract", "serve", "of [radio]'s RadioAMIL on "
            "the extracted glioma features", radio_exp, g_csv,
            os.path.join(out, "brain"), td,
            dict(none, _fused_pool_cuda=-(-n_glioma // 8)), wall, launches)
        if sorted(served) != sorted(glioma_ids):
            raise AssertionError("[extract] serving the extracted features "
                                 "failed")
        # serving: the J2K lung series and its twin, their CT bag as each
        # of the four sequences [radio]'s experiment reads
        lung_serve = os.path.join(td, "lung_serve")
        for seq in GLIOMA_SEQS:
            os.makedirs(os.path.join(lung_serve, "radio_h5_files", seq))
            for sid in (twin_sid, j2k_sid):
                os.symlink(os.path.join(out, "lung", "radio_h5_files", "CT",
                                        f"{sid}.h5"),
                           os.path.join(lung_serve, "radio_h5_files", seq,
                                        f"{sid}.h5"))
        lung_csv = os.path.join(td, "lung_serve.csv")
        with open(lung_csv, "w") as f:
            f.write("subject_id," + ",".join(GLIOMA_SEQS) + "\n" + "".join(
                f"{sid}," + ",".join(["ct"] * len(GLIOMA_SEQS)) + "\n"
                for sid in (twin_sid, j2k_sid)))
        served, _ = _serve_and_check(
            launch_counters, "extract", "serve_lung_j2k", "of [radio]'s "
            "RadioAMIL on the J2K lung series and its uncompressed twin",
            radio_exp, lung_csv, lung_serve, td,
            dict(none, _fused_pool_cuda=1), wall, launches)
        # bit for bit when the features are; else within the pooling's
        # f32 tolerance of each other
        twin_err = abs(served[j2k_sid] - served[twin_sid]) / abs(
            served[twin_sid])
        log(f"[extract] the J2K lung series' risk and its twin's: {served}")
        if twin_err > (0 if twins_bitwise else 1e-4):
            raise AssertionError("[extract] the J2K lung series' risk "
                                 "differs from its twin's")
    log(f"[extract] wall s ({_card()}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items()))
    return launches, {"glioma_dir": g_dir, "glioma_csv": g_csv,
                      "glioma_ids": glioma_ids,
                      "lung_dir": l_dir, "lung_ids": lung_ids,
                      "features": os.path.join(out, "glioma"),
                      "weights": weights}


# the kernels of this repo, by the names torch.profiler gives them
POOL_KERNELS = ("pool_partial_f32_kernel", "pool_partial_bf16_kernel",
                "pool_merge_kernel", "bwd_rows_kernel", "bwd_dh_kernel",
                "bwd_dw_partial_kernel", "bwd_vec_partial_kernel",
                "bwd_reduce_kernel")


def phase_gradcam(launch_counters, radio_exp, cohort, root=None,
                  n_subjects=4):
    """[gradcam] Stage 5's radiology images on the card, on [extract]'s
    glioma cohort (its scans, its h5 features and its seeded --weights)
    and [radio]'s RadioAMIL (4 sequences, concat, gated, D = Da = 256),
    TF32 left at torch's default (on) for cuDNN; the launch counters reset
    just before each run and read just after:
      - cli.create_heatmaps radio with a scan_list and a 2-sequence
        display_modality on ``n_subjects`` subjects: no launch; every PNG
        read back by utils/png.read_png equals the preprocessed slice made
        uint8;
      - cli.gradcam cohort, top slices by that scores.csv, aug-smooth on,
        on the same subjects x 4 sequences: 6 forward and 6 backward
        launches a scan; every overlay read back;
      - one scan's CamRunner through the kernels and through the plain
        pooling on the card: CAMs (the backward kernel's dh) at atol 1e-4,
        and the AMIL's risk on the scan's layer3 maps (the forward
        kernel's output) at rel 1e-5;
      - --all_slices on one subject's T1: its NIfTI finite and in [0, 1];
      - single-scan lung on one DICOM series: 6 / 6 launches, the mean CAM
        inside the lung mask more than twice the mean outside (the CLI
        zeroes the CAM outside the mask before its blur: this holds that
        the mask was applied and left a CAM inside);
      - single-scan glioma of 8 slices at --image_size 96 on the card and
        on the CPU: cam_volume.nii.gz at atol 1e-4;
      - card time per CAM image (one trunk forward, the head's forward and
        backward: CUDA events over one aug variant of a scan) beside the
        f32 trunk's bound, and the pooling kernels' share of that pass
        (torch.profiler).
    Returns the launch counts by run."""
    import torch
    from multimodalfusion_tpu_torch.cli import create_heatmaps
    from multimodalfusion_tpu_torch.cli import gradcam as gc
    from multimodalfusion_tpu_torch.data.nifti import read_nifti, write_nifti
    from multimodalfusion_tpu_torch.data.radiology import (
        preprocess_glioma_scan, preprocess_lung_scan)
    from multimodalfusion_tpu_torch.models import resnet
    from multimodalfusion_tpu_torch.utils.experiment import read_experiment
    from multimodalfusion_tpu_torch.utils.png import read_png
    wall, launches = {}, {}
    none = {c.__name__: 0 for c in launch_counters}

    def per_scan(n):
        return {"_fused_pool_cuda": 6 * n, "_fused_pool_bwd_cuda": 6 * n}

    def run(stage, fn, argv, want):
        _run_stage(launch_counters, "gradcam", stage, fn, argv, wall,
                   launches, want)
        log(f"[gradcam] {stage}: {wall[stage]:.2f} s, launches "
            f"{launches[stage]} (expected {want})")

    g_dir, sids = cohort["glioma_dir"], cohort["glioma_ids"][:n_subjects]
    weights = cohort["weights"]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    try:
        with _workdir(root, "gradcam") as td:
            # the scan list with paths relative to the scans' directory
            names = {r["subject_id"]: r
                     for r in _csv_rows(cohort["glioma_csv"])}
            scans = os.path.join(td, "scans.csv")
            with open(scans, "w") as f:
                f.write("subject_id," + ",".join(GLIOMA_SEQS) + "\n")
                for sid in sids:
                    f.write(sid + "," + ",".join(
                        f"{sid}/{names[sid][m]}" for m in GLIOMA_SEQS)
                        + "\n")
            subjects = os.path.join(td, "subjects.csv")
            with open(subjects, "w") as f:
                f.write("subject_id\n" + "".join(f"{s}\n" for s in sids))
            heat = os.path.join(td, "heatmap")
            config = os.path.join(td, "heatmap.yaml")
            with open(config, "w") as f:
                f.write(f"exp_arguments:\n  branch: radio\n  save_dir: "
                        f"'{heat}'\ndata_arguments:\n  process_list: "
                        f"'{subjects}'\n  feat_dir: '{cohort['features']}'\n"
                        f"  modalities: [{', '.join(RADIO_SEQS)}]\n"
                        f"  scan_list: '{scans}'\n  scan_dir: '{g_dir}'\n"
                        f"  display_modality: [T1, FLAIR]\n"
                        f"model_arguments:\n  ckpt_path: '{radio_exp}'\n"
                        f"  which_k: 0\n")
            run("heatmap_scan_list", create_heatmaps.main,
                ["--config", config, "--device", "cuda"], none)
            n_png = 0
            for sid in sids:
                for m in ("T1", "FLAIR"):
                    slices, ids = preprocess_glioma_scan(os.path.join(
                        g_dir, sid, names[sid][m]))
                    at = {int(s): i for i, s in enumerate(ids)}
                    for group in ("top", "low"):
                        d = os.path.join(heat, sid, m, group)
                        for name in os.listdir(d):
                            i = at[int(name[5:name.index("_a")])]
                            want = (np.clip(slices[i], 0, 1) * 255).astype(
                                np.uint8)
                            if not np.array_equal(read_png(
                                    os.path.join(d, name)), want):
                                raise AssertionError(f"[gradcam] {d}/{name}")
                            n_png += 1
            want = 2 * sum(r["group"] != "mid" for r in _csv_rows(
                os.path.join(heat, "scores.csv")))
            log(f"[gradcam] create_heatmaps scan_list: {n_png} slice PNGs "
                f"(expected {want}) of {n_subjects} subjects x T1, FLAIR "
                f"read back equal to their preprocessed slices")
            if n_png != want:
                raise AssertionError(f"[gradcam] {n_png} slice PNGs")

            common = ["--ckpt_path", radio_exp, "--weights", weights,
                      "--device", "cuda"]
            top = os.path.join(td, "top")
            run("cohort_top", gc.main, common + [
                "--csv_path", scans, "--radio_dir", g_dir, "--scores_csv",
                os.path.join(heat, "scores.csv"), "--save_dir", top],
                per_scan(4 * n_subjects))
            n_png = 0
            for sid in sids:
                d = os.path.join(top, sid, "ig_heatmap")
                for name in sorted(os.listdir(d)):
                    img = read_png(os.path.join(d, name))
                    if img.dtype != np.uint8 or img.ndim != 3 \
                            or img.shape[2] != 3:
                        raise AssertionError(f"[gradcam] {d}/{name}")
                    n_png += 1
            log(f"[gradcam] cli.gradcam cohort: {n_png} overlays read back")
            if n_png != 20 * 4 * n_subjects:
                raise AssertionError(f"[gradcam] {n_png} overlays")

            # one scan through the kernels and through the plain pooling
            args = gc.build_parser().parse_args(common + ["--save_dir", td])
            dev = torch.device("cuda")
            embedder = gc._load_resnet(args, dev)
            amil = gc._load_amil(args, read_experiment(radio_exp), dev)
            slices, _ = preprocess_glioma_scan(os.path.join(
                g_dir, sids[0], names[sids[0]]["T1"]))
            x = embedder.slice_inputs(slices)
            runner = gc.CamRunner(embedder, amil, len(RADIO_SEQS), True)
            for c in launch_counters:
                c.launches = 0
            cams, scores = runner(x, RADIO_SEQS.index("T1"))
            kernel_launches = {c.__name__: c.launches
                               for c in launch_counters}
            with _plain_pooling():
                cams_p, _ = runner(x, RADIO_SEQS.index("T1"))
            plain_launches = {c.__name__: c.launches - kernel_launches[
                c.__name__] for c in launch_counters}
            # the risk is the forward kernel's output; the scores come from
            # the unfused read-out and launch no kernel on either side
            with torch.no_grad():
                bag = runner._bag(embedder.spatial_maps(x),
                                  RADIO_SEQS.index("T1"))
                ones = torch.ones(1, bag.shape[1], device=dev)
                risk = amil(bag, ones)["risk"]
                with _plain_pooling():
                    risk_p = amil(bag, ones)["risk"]
            e_cam = float(np.abs(cams - cams_p).max())
            e_r = float((risk - risk_p).abs().max() / risk_p.abs().max())
            log(f"[gradcam] {sids[0]} T1 ({len(slices)} slices), aug-smooth: "
                f"CamRunner through the kernels (launches {kernel_launches}) "
                f"vs the plain pooling on the card (launches "
                f"{plain_launches}): CAMs, from the backward kernel's dh, "
                f"max abs err {e_cam:.2e} (tol 1e-4); the AMIL's risk on the "
                f"scan's layer3 maps, the forward kernel's output, rel "
                f"{e_r:.2e} (tol 1e-5)")
            if kernel_launches != per_scan(1) or plain_launches != none \
                    or e_cam > 1e-4 or e_r > 1e-5:
                raise AssertionError("[gradcam] kernels vs plain pooling")

            # card time per CAM image, and the pooling kernels' share
            one = gc.CamRunner(embedder, amil, len(RADIO_SEQS), False)
            n = len(slices)
            cam_ms = _time_ms(lambda: one(x, 0), iters=3, warmup=1)
            trunk_ms = _time_ms(lambda: embedder.spatial_maps(x), iters=3,
                                warmup=1)
            per_kernel, wall_ms = _device_time(lambda: one(x, 0), reps=3)
            pool_us = sum(v for k, v in per_kernel.items()
                          if k in POOL_KERNELS)
            busy_us = sum(per_kernel.values())
            bound_us = resnet.conv_flops(resnet.ResNet50Trunc()) \
                / PEAK_FLOPS["float32"] * 1e6
            if not pool_us:
                raise AssertionError(f"[gradcam] no pooling kernel in the "
                                     f"profile of a CAM pass: {per_kernel}")
            log(f"[gradcam] one CAM pass of {n} slices at 224 x 224 (f32, "
                f"TF32 off; CUDA events): {cam_ms * 1e3 / n:.2f} us an image "
                f"(the trunk alone {trunk_ms * 1e3 / n:.2f} us), bound of the "
                f"trunk's convolutions {bound_us:.2f} us an image "
                f"({bound_us * n / (cam_ms * 1e3):.1%} of it); "
                f"torch.profiler: {busy_us / 1e3:.3f} ms of kernels in "
                f"{wall_ms:.3f} ms wall a pass, the pooling kernels "
                f"{pool_us:.1f} us ({pool_us / busy_us:.2%} of the kernel "
                f"time): " + ", ".join(f"{k} {v:.1f} us" for k, v in
                                       per_kernel.items()
                                       if k in POOL_KERNELS))
            # the pooling's bound at the shape a CAM pass gives it
            params = amil.pool.attn_params()
            h = torch.zeros(1, n, params.Wa.shape[0], device=dev)
            mask = torch.ones(1, n, device=dev)
            fwd_us = sum(v for k, v in per_kernel.items()
                         if k in POOL_KERNELS and k.startswith("pool_"))
            bounds = [_bound(h, mask, params.Wa.shape[1], amil.pool.gated,
                             backward=b) for b in (False, True)]
            log(f"[gradcam] the pooling of a CAM pass, B=1 N={n} "
                f"D={params.Wa.shape[0]} Da={params.Wa.shape[1]} f32 gated: "
                f"forward kernels {fwd_us:.1f} us, backward kernels "
                f"{pool_us - fwd_us:.1f} us (torch.profiler), bounds "
                f"{bounds[0][0] * 1e3:.3f} us ({bounds[0][1]}) and "
                f"{bounds[1][0] * 1e3:.3f} us ({bounds[1][1]})")

            # one sequence: the side-by-side PNGs are host work
            every = os.path.join(td, "all")
            run("all_slices", gc.main, common + [
                "--csv_path", scans, "--radio_dir", g_dir, "--scores_csv",
                os.path.join(heat, "scores.csv"), "--save_dir", every,
                "--all_slices", "--subject", sids[1], "--modalities", "T1"],
                per_scan(1))
            attr = read_nifti(os.path.join(
                every, sids[1], f"{sids[1]}_T1_attr.nii.gz")).data
            if not np.isfinite(attr).all() or attr.min() < 0 \
                    or attr.max() > 1 + 1e-5:
                raise AssertionError("[gradcam] T1 attr volume")
            log(f"[gradcam] --all_slices {sids[1]} T1: attr volume of "
                f"{attr.shape} finite, in [0, 1]; "
                f"{len(os.listdir(os.path.join(every, sids[1], 'ig_heatmap_all', 'T1')))}"
                f" side-by-side PNGs")

            lung = os.path.join(cohort["lung_dir"], cohort["lung_ids"][0],
                                "ct")
            run("lung_single", gc.main, common + [
                "--scan", lung, "--cancer_type", "lung", "--save_dir",
                os.path.join(td, "lung")], per_scan(1))
            cam = read_nifti(os.path.join(td, "lung",
                                          "cam_volume.nii.gz")).data
            _, _, mask = preprocess_lung_scan(lung, return_mask=True)
            inside, outside = cam[mask].mean(), cam[~mask].mean()
            log(f"[gradcam] lung {cohort['lung_ids'][0]}: CAM volume "
                f"{cam.shape}, mean inside the lung mask {inside:.4f}, "
                f"outside {outside:.4f}")
            if cam.shape != mask.shape or not np.isfinite(cam).all() \
                    or not inside > 2 * max(outside, 1e-9):
                raise AssertionError("[gradcam] lung CAM")

            rng = np.random.default_rng(61)
            vol = np.zeros((10, 96, 96), np.float32)
            vol[1:9, 16:80, 16:80] = rng.uniform(5, 90, (8, 64, 64))
            small = write_nifti(os.path.join(td, "small.nii.gz"), vol,
                                origin_lps=(0.0, -239.0, 0.0))
            vols = {}
            for d in ("cuda", "cpu"):
                run(f"glioma_single_{d}", gc.main, [
                    "--scan", small, "--ckpt_path", radio_exp, "--weights",
                    weights, "--image_size", "96", "--top_frac", "0.4",
                    "--save_dir", os.path.join(td, d), "--device", d],
                    per_scan(1) if d == "cuda" else none)
                vols[d] = read_nifti(os.path.join(td, d,
                                                  "cam_volume.nii.gz")).data
            e = float(np.abs(vols["cuda"] - vols["cpu"]).max())
            log(f"[gradcam] single-scan glioma {vols['cpu'].shape}: "
                f"cam_volume card vs CPU max abs err {e:.2e} (tol 1e-4)")
            if vols["cuda"].shape != (8, 64, 64) or e > 1e-4:
                raise AssertionError("[gradcam] card vs CPU")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"[gradcam] wall s ({_card()}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items()))
    return launches


DIST_B, DIST_N, DIST_D = 8, 4096, 256     # the sharded pool's shape
DIST_STEP_B, DIST_STEP_N = 8, 2048        # the training steps' batches
DIST_MEM_N = 32768                        # the peak-memory step's bag


class _MemoryView:
    """A cohort held in memory, read by the loader as it reads a
    ``SurvivalDataset``: ``Sample``s in order, every modality present."""
    modalities, pretrained, mode = (), False, "path"

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def probe_present(self, i):
        return self.samples[i].present

    def get_sample(self, i):
        return self.samples[i]


def _dist_view(n, lens, seed):
    """A seeded full-width PathAMIL cohort of ``n`` subjects whose bags
    [len, 1024] have the lengths ``lens(rng)``."""
    from multimodalfusion_tpu_torch.data.survival_dataset import Sample
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        samples.append(Sample(
            subject_id=f"d{i}", path=rng.standard_normal(
                (int(lens(rng)), 1024), dtype=np.float32) * 0.5,
            present={"path": True}, disc_label=int(rng.integers(0, 4)),
            event_time=float(rng.uniform(1, 60)),
            censorship=float(rng.uniform() < 0.3)))
    return _MemoryView(samples)


def _dist_rank(rank, world, work):
    """One of the [dist] ranks: gloo on cuda:0 (NCCL refuses two ranks on
    one GPU), the engine and op functions called directly.  Writes
    ``dist_rank{rank}.json``; a failure writes its traceback there and
    exits non-zero."""
    import datetime
    import traceback
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{work}/pg", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=240))
        out.update(_dist_rank_work(rank, world))
        dist.destroy_process_group()
    except BaseException:
        out["error"] = traceback.format_exc()
    with open(os.path.join(work, f"dist_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if "error" in out:
        sys.exit(1)


def _median_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` over ``reps`` calls after one."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _dist_rank_work(rank, world):
    import dataclasses

    import torch
    import torch.distributed as dist
    from multimodalfusion_tpu_torch.data.bags import PinnedPool
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.engine import train as ttrain
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    from multimodalfusion_tpu_torch.parallel import mesh as par
    counters = [mil._fused_pool_cuda, mil._fused_pool_bwd_cuda]

    def counts():
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    def reset():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
    res = {}
    # the sharded pool: every rank makes the same seeded inputs, pools its
    # block of the instance axis and holds it against the unsharded kernels
    h, mask, params = make_pool_case(DIST_B, DIST_N, DIST_D, DIST_D,
                                     "float32", seed=41)
    gen = torch.Generator(device="cuda").manual_seed(43)
    g = torch.randn(DIST_B, DIST_D, generator=gen, device="cuda")
    da, db = mil.make_dropout_masks(gen, (DIST_B, DIST_N, DIST_D))
    lo, hi = par.block(DIST_N, world, rank)
    for dropout in (False, True):
        tag = "dropout" if dropout else "plain"
        kw = ((da, db) if dropout else (None, None))

        def leaves():
            return mil.AttnParams(*(p.clone().requires_grad_()
                                    for p in params))
        ref_p, ref_h = leaves(), h.clone().requires_grad_()
        ref = (mil.attention_pool_dropout(ref_h, mask, da, db, ref_p)
               if dropout else mil.attention_pool(ref_h, mask, ref_p))
        ref.backward(g)
        blk_p = leaves()
        blk_h = h[:, lo:hi].clone().requires_grad_()
        blk = (mask[:, lo:hi],) + tuple(None if m is None else m[:, lo:hi]
                                        for m in kw)

        def sharded():
            out = (mil.attention_pool_dropout(blk_h, *blk, blk_p,
                                              group=dist.group.WORLD)
                   if dropout else
                   mil.attention_pool(blk_h, blk[0], blk_p,
                                      group=dist.group.WORLD))
            out.backward(g)
            return out
        reset()
        got = sharded()
        launches = counts()
        errs = {"out": rel_err(got.detach(), ref.detach()),
                "dh": rel_err(blk_h.grad, ref_h.grad[:, lo:hi])}
        for name in ("Wa", "ba", "Wb", "bb", "wc"):
            errs[name] = rel_err(getattr(blk_p, name).grad,
                                 getattr(ref_p, name).grad)
        # the median of 5 warm calls each, the other rank running beside
        # this one on the same card
        res[f"pool_{tag}"] = {
            "launches": launches, "rel_err": errs,
            "ms": _median_ms(sharded),
            "unsharded_ms": _median_ms(lambda: (
                mil.attention_pool_dropout(ref_h, mask, da, db, ref_p)
                if dropout else mil.attention_pool(ref_h, mask, ref_p)
            ).backward(g))}
    # two training steps of PathAMIL small per layout against two steps
    # of the one-process engine on the same card, generator seeds and
    # init, every batch made by the loader (this rank's rows only, into
    # page-locked buffers)
    cfg = ttrain.TrainConfig(model_type="path_attention_mil", mode="path",
                             gate_path=True, drop_out=True,
                             bag_loss="nll_surv", batch_size=DIST_STEP_B,
                             device="cuda:0")
    view = _dist_view(2 * DIST_STEP_B, lambda rng: rng.integers(
        DIST_STEP_N // 2, DIST_STEP_N + 1), seed=31)
    dev = torch.device("cuda:0")
    pool = PinnedPool()

    def steps(view, mesh=None, bag=False, cfg=cfg):
        model = ttrain.build_model(cfg, torch.Generator().manual_seed(0),
                                   mesh if bag else None).to(dev)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt = ttrain.make_optimizer(cfg, model.parameters())
        step, _ = ttrain.make_steps(cfg, model, opt, dev, pool=pool,
                                    mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(7)
        losses, grads = [], []
        for b in iter_batches(view, batch_size=cfg.batch_size, pool=pool,
                              mesh=mesh):
            losses.append(float(step(b, gen)["loss"]))
            grads.append({k: p.grad.detach().clone()
                          for k, p in model.named_parameters()
                          if p.grad is not None})
        return losses, init, {k: v.detach().clone()
                              for k, v in model.state_dict().items()}, grads
    want_loss, init, want, want_grads = steps(view)
    for tag, mesh in (("bag_shard", par.make_bag_mesh()),
                      ("data_parallel", par.make_mesh())):
        reset()
        t0 = time.perf_counter()
        loss, _, state, grads = steps(view, mesh, tag == "bag_shard")
        wall = time.perf_counter() - t0
        launches = counts()
        e_state = e_elem = 0.0
        for k in init:
            moved = float((want[k] - init[k]).norm())
            e_state = max(e_state, float((state[k] - want[k]).norm())
                          / max(moved, 1e-30))
            e_elem = max(e_elem, float((state[k] - want[k]).abs().max()))
        # the first step's gradients after the group sums: per tensor
        # |diff| / (|g| + 1e-2 max |g|), tolerance 1e-4 (a gradient scaled
        # by a group's size or summed twice is off by its whole norm,
        # which Adam's update would hide)
        g0, w0 = grads[0], want_grads[0]
        scale = max(float(g.norm()) for g in w0.values())
        e_grad = max(float((g0[k] - g).norm())
                     / (float(g.norm()) + 1e-2 * scale)
                     for k, g in w0.items()) if sorted(g0) == sorted(w0) \
            else float("inf")
        res[tag] = {"launches": launches, "losses": loss,
                    "want_losses": want_loss,
                    "loss_rel_err": max(abs(a - b) / abs(b)
                                        for a, b in zip(loss, want_loss)),
                    "state_rel_err": e_state, "elem_err": e_elem,
                    "grad_rel_err": e_grad, "lr": cfg.lr, "wall_s": wall}
    # peak device memory of one bag-sharded step with dropout against the
    # one-process step, each process its own (both share the card)
    big = _dist_view(1, lambda rng: DIST_MEM_N, seed=37)
    one = dataclasses.replace(cfg, batch_size=1)
    peaks = {}
    for tag, mesh in (("one_process", None),
                      ("bag_shard", par.make_bag_mesh())):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        steps(big, mesh, mesh is not None, one)
        torch.cuda.synchronize()
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    res["memory"] = {"peak_mib": peaks, "n": DIST_MEM_N}
    return res


def _run_dist_ranks(td, world=2, timeout=300):
    """Spawn the [dist] ranks and join them; a rank still running at the
    timeout is killed.  Returns the processes."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, td))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    return procs


def phase_dist(root=None):
    """[dist]: two ranks on cuda:0 over gloo (the card's machine has one
    GPU; NCCL refuses two ranks on one) run the bag-sharded pooling and
    two bag-sharded and two data-parallel PathAMIL training steps, each
    rank launching each kernel once per step, against the unsharded
    kernels and the one-process steps; then a torchrun launch of one rank
    runs cli.main --data_parallel --bag_shard over NCCL and prints the
    JAX package's unsharded lines.  Returns each rank's launch counts by
    path."""
    t_phase = time.perf_counter()
    with _workdir(root, "dist") as td:
        # one rank under torchrun (NCCL; JAX's lines at world size 1),
        # beside the two gloo ranks
        data_args = _write_train_experiment(td, n_subjects=8, n_val=2,
                                            bag_range=(100, 400))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=1", "-m",
               "multimodalfusion_tpu_torch.cli.main", *data_args, "--k", "1",
               "--max_epochs", "1", "--model_type", "path_attention_mil",
               "--mode", "path", "--gate_path", "--drop_out",
               "--batch_size", "4", "--data_parallel", "--bag_shard",
               "--bag_shard_devices", "1", "--results_dir",
               os.path.join(td, "results"), "--device", "cuda"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t_run = time.perf_counter()
        # its own session, so that its worker goes with it if killed
        run = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE,
                               start_new_session=True)
        try:
            procs = _run_dist_ranks(td)
            stdout, stderr = run.communicate(timeout=300)
        finally:
            if run.poll() is None:
                os.killpg(run.pid, 9)
                run.communicate()
        ranks = []
        for r in range(2):
            path = os.path.join(td, f"dist_rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {"error": "no result"})
        codes = [p.exitcode for p in procs]
        bad = [(r, x.get("error")) for r, x in enumerate(ranks)
               if "error" in x]
        if bad or any(codes):
            raise AssertionError(f"[dist] ranks failed (exit codes "
                                 f"{codes}): {bad}")
        launches = {}
        for r, x in enumerate(ranks):
            for tag in ("pool_plain", "pool_dropout"):
                p = x[tag]
                errs = p["rel_err"]
                log(f"[dist] rank {r} sharded pool ({tag[5:]}, B={DIST_B} "
                    f"N={DIST_N} D=Da={DIST_D} f32 gated, its block "
                    f"{DIST_N // 2} rows): fwd+bwd {p['ms']:.3f} ms with "
                    f"its collectives (the whole bag unsharded "
                    f"{p['unsharded_ms']:.3f} ms; both medians of 5, the "
                    f"other rank on the same card), launches "
                    f"{p['launches']}; rel err vs "
                    f"the unsharded kernels "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + " (tol 1e-5)")
                if max(errs.values()) > 1e-5 or list(
                        p["launches"].values()) != [1, 1]:
                    raise AssertionError(f"[dist] sharded pool {tag}")
            for tag in ("bag_shard", "data_parallel"):
                s = x[tag]
                log(f"[dist] rank {r} {tag}: 2 PathAMIL steps (B="
                    f"{DIST_STEP_B} N={DIST_STEP_N} --drop_out) in "
                    f"{s['wall_s']:.3f} s, launches {s['launches']}; losses "
                    + ", ".join(f"{v:.6f}" for v in s["losses"])
                    + " vs one process "
                    + ", ".join(f"{v:.6f}" for v in s["want_losses"])
                    + f": rel err {s['loss_rel_err']:.2e} (tol 1e-4); "
                    f"first step's gradients |diff| / (|g| + 1e-2 max |g|) "
                    f"{s['grad_rel_err']:.2e} (tol 1e-4); "
                    f"parameters |diff| / |moved| {s['state_rel_err']:.2e} "
                    f"(tol 1e-3), max element {s['elem_err']:.2e} (tol lr "
                    f"= {s['lr']:g})")
                if (s["loss_rel_err"] > 1e-4 or s["grad_rel_err"] > 1e-4
                        or s["state_rel_err"] > 1e-3
                        or s["elem_err"] > s["lr"]
                        or list(s["launches"].values()) != [2, 2]):
                    raise AssertionError(f"[dist] {tag} steps")
            mem = x["memory"]["peak_mib"]
            log(f"[dist] rank {r} peak device memory of one PathAMIL step "
                f"(B=1 N={x['memory']['n']} --drop_out): one process "
                f"{mem['one_process']:.1f} MiB, this rank's bag-sharded "
                f"step {mem['bag_shard']:.1f} MiB (tol 0.75 of one "
                f"process)")
            if mem["bag_shard"] > 0.75 * mem["one_process"]:
                raise AssertionError("[dist] bag-sharded peak memory")
            for tag in ("pool_plain", "pool_dropout", "bag_shard",
                        "data_parallel"):
                for name, n in x[tag]["launches"].items():
                    launches.setdefault(tag, {}).setdefault(name, []).append(
                        n)
        lines = stdout.splitlines()
        want = ["bag_shard: only one device visible, running unsharded",
                "data_parallel: only one device visible, running unsharded"]
        group = [x for x in lines if x.startswith("torch.distributed:")]
        log(f"[dist] torchrun --nproc_per_node=1 cli.main --data_parallel "
            f"--bag_shard: rc={run.returncode} in "
            f"{time.perf_counter() - t_run:.1f} s; "
            + " | ".join(group + [x for x in lines if x in want]))
        if run.returncode != 0 or not all(x in lines for x in want) or \
                not any("over nccl" in x for x in group):
            raise AssertionError(f"[dist] torchrun run: {stdout[-3000:]}"
                                 f"\n{stderr[-3000:]}")
    log(f"[dist] wall {time.perf_counter() - t_phase:.1f} s ({_card()})")
    return launches


OPS_SUBKERNELS = {"_fused_pool_cuda": ("pool_partial_f32_kernel",
                                       "pool_merge_kernel"),
                  "_fused_pool_bwd_cuda": ("bwd_rows_kernel", "bwd_dh_kernel",
                                           "bwd_dw_partial_kernel",
                                           "bwd_vec_partial_kernel",
                                           "bwd_reduce_kernel")}


def _ops_cohort(root):
    """[ops]' data arguments: [train]'s 32 bags (written anew when [train]
    did not run) under a cohort CSV of their own, with the four MRI
    columns blank (so --split pre_trained takes every subject for the path
    mode) and no censored subject (so the 4 label classes fit the 4
    validation subjects that a 0.1 test size leaves of 32)."""
    import csv
    td = os.path.join(root, "train")
    if not os.path.isdir(os.path.join(td, "features")):
        td = os.path.join(root, "ops_bags")
        os.makedirs(td)
        _write_train_experiment(td)
    with open(os.path.join(td, "dataset_csv", "brain", "survival.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    cohort = os.path.join(root, "ops", "dataset_csv", "brain")
    os.makedirs(cohort)
    cols = (["subject_id", "slide_id"] + list(RADIO_SEQS)
            + ["survival_months", "censorship", "train"])
    with open(os.path.join(cohort, "survival.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, cols, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(dict(r, censorship="0.0"))
    return ["--cancer_type", "brain", "--which_splits", "ops",
            "--data_root_dir", os.path.join(td, "features"),
            "--dataset_root", os.path.join(root, "ops", "dataset_csv"),
            "--splits_root", os.path.join(root, "ops", "splits")]


def _same_or_distance(tag, got_exp, want_exp, init):
    """Whether fold 0 of ``got_exp`` equals ``want_exp``'s bit for bit
    (metrics but ``sec``, the final checkpoint); if not, the losses'
    largest relative difference and the parameters' distance as a share
    of their movement from ``init``, held to the step check's 1e-4 and
    1e-3."""
    import torch

    def recs(exp):
        with open(os.path.join(exp, "0", "metrics.jsonl")) as f:
            return [json.loads(x) for x in f]
    g, w = recs(got_exp), recs(want_exp)
    if [r["epoch"] for r in g] != [r["epoch"] for r in w]:
        raise AssertionError(f"[ops] {tag}: epochs {[r['epoch'] for r in g]}"
                             f" vs {[r['epoch'] for r in w]}")
    gs = torch.load(os.path.join(got_exp, "s_0_checkpoint.pt"))
    ws = torch.load(os.path.join(want_exp, "s_0_checkpoint.pt"))
    same_metrics = all({k: v for k, v in a.items() if k != "sec"}
                       == {k: v for k, v in b.items() if k != "sec"}
                       for a, b in zip(g, w))
    same_params = all(torch.equal(gs[k], ws[k]) for k in ws)
    if same_metrics and same_params:
        log(f"[ops] {tag}: equal to the straight fold bit for bit "
            f"(metrics but sec, checkpoint)")
        return True
    keys = ("train_loss", "val_loss", "train_c_index", "val_c_index")
    e_loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                 for a, b in zip(g, w) for k in keys[:2])
    moved = sum(float((ws[k].float() - init[k].float()).norm()) ** 2
                for k in init if ws[k].is_floating_point()) ** 0.5
    dist = sum(float((gs[k].float() - ws[k].float()).norm()) ** 2
               for k in init if ws[k].is_floating_point()) ** 0.5
    share = dist / max(moved, 1e-30)
    log(f"[ops] {tag}: NOT bit for bit: losses max rel diff {e_loss:.3e} "
        f"(tol 1e-4), parameters |diff| / |moved| {share:.3e} (tol 1e-3)")
    if e_loss > 1e-4 or share > 1e-3:
        raise AssertionError(f"[ops] {tag}: resumed and straight folds "
                             f"disagree")
    return False


def _trace_kernels(path):
    """{sub-kernel name: count} of the pooling kernels' sub-kernels among
    the device kernels of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {n: 0 for names in OPS_SUBKERNELS.values() for n in names}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for n in counts:
            if n in e.get("name", ""):
                counts[n] += 1
    return counts


def phase_ops(launch_counters, root):
    """[ops] Operations on the card, on [train]'s 32 bags (PathAMIL small,
    gated, --drop_out, nll_surv, B=8, f32), each run with the launch
    counters reset just before and read just after:
      - cli.main --split pre_trained --k 2 (fold 0: 28 train, 4
        validation subjects) --tb --profile_dir for two epochs, then
        --resume to four;
      - the same fold in a subprocess, killed with SIGKILL after its second
        epoch's record, then --resume to four;
      - a straight 4-epoch fold, and two epochs with --ckpt_format orbax
        (which writes the same s_0_resume.pt bundle) resumed to four;
      - each resumed fold against the straight one: bit for bit, or the
        losses' and parameters' distance (tolerances of the step check);
      - the bundle's write time and size, an epoch's time
        with and without the profiler, the six pooling sub-kernels in the
        trace against the launch counters;
      - cli.export_model --platforms cuda --check, --platforms cpu
        --check and --platforms cuda cpu --check (on the CPU) on the
        straight fold; the cuda artifact's served batch
        (B=8, N=512) launches the forward once, equals the eager model's
        and is timed against it under CUDA events;
      - cli.doctor --full: both kernels match their plain versions.
    Returns the launch counts by run."""
    import contextlib
    import io
    import signal

    import torch
    from multimodalfusion_tpu_torch.cli import doctor, export_model
    from multimodalfusion_tpu_torch.cli import main as cli_main
    from multimodalfusion_tpu_torch.engine import train as ttrain
    from multimodalfusion_tpu_torch.utils import model_export
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, load_experiment_model, read_experiment)
    B, n_train, n_val = 8, 28, 4
    steps, evals = -(-n_train // B), -(-n_val // B)
    data_args = _ops_cohort(root)
    flags = data_args + ["--k", "2", "--k_end", "1", "--model_type",
                         "path_attention_mil", "--mode", "path",
                         "--gate_path", "--drop_out", "--bag_loss",
                         "nll_surv", "--batch_size", str(B), "--device",
                         "cuda"]
    launches, wall = {}, {}

    def count():
        return {c.__name__: c.launches for c in launch_counters}

    def run(stage, fn, argv, fwd=None, bwd=None):
        for c in launch_counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = fn(argv)
        torch.cuda.synchronize()
        wall[stage] = time.perf_counter() - t0
        launches[stage] = count()
        want = {"_fused_pool_cuda": fwd, "_fused_pool_bwd_cuda": bwd}
        if rc != 0 or (fwd is not None and launches[stage] != want):
            raise AssertionError(f"[ops] {stage}: rc={rc}, launches "
                                 f"{launches[stage]}, expected {want}")

    def fold(stage, name, max_epochs, *extra, epochs=2):
        """The fold in ``ops/name`` trained to ``max_epochs``, ``epochs``
        of them in this run."""
        run(stage, cli_main.main, flags + [
            "--results_dir", os.path.join(root, "ops", name),
            "--max_epochs", str(max_epochs)] + list(extra),
            fwd=epochs * (steps + evals) + 2 * evals, bwd=epochs * steps)

    def exp_of(name):
        sub = os.path.join(root, "ops", name, "brain", "ops")
        return os.path.join(sub, os.listdir(sub)[0])

    prof = os.path.join(root, "ops", "prof")
    fold("traced", "traced", 2, "--split", "pre_trained", "--tb",
         "--profile_dir", prof)
    splits = os.path.join(root, "ops", "splits", "brain", "ops")
    with open(os.path.join(splits, "splits_0.csv")) as f:
        cells = [r.split(",") for r in f.read().splitlines()[1:]]
    sizes = [sum(1 for c in cells if c[i]) for i in (0, 1)]
    log(f"[ops] --split pre_trained wrote {sorted(os.listdir(splits))}; "
        f"fold 0: {sizes[0]} train, {sizes[1]} validation subjects")
    if sizes != [n_train, n_val]:
        raise AssertionError(f"[ops] split sizes {sizes}")
    fold("traced_resume", "traced", 4, "--resume", "--tb", "--overwrite")

    # a subprocess killed with SIGKILL after its second epoch's record
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    boot = ("import sys; from multimodalfusion_tpu_torch.cli.main import "
            "main; sys.exit(main(sys.argv[1:]))")
    killed = os.path.join(root, "ops", "killed")
    err_path = os.path.join(root, "ops", "killed.stderr")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, "-c", boot] + flags + [
            "--results_dir", killed, "--max_epochs", "4"], env=env,
            stdout=subprocess.DEVNULL, stderr=err_file)
    log_path = None
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            found = [os.path.join(d, "0", "metrics.jsonl") for d in (
                [os.path.join(killed, "brain", "ops", e) for e in
                 os.listdir(os.path.join(killed, "brain", "ops"))]
                if os.path.isdir(os.path.join(killed, "brain", "ops"))
                else [])]
            found = [p for p in found if os.path.exists(p)]
            if found and len(open(found[0]).read().splitlines()) >= 2:
                log_path = found[0]
                break
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
    if log_path is None:
        with open(err_path) as f:
            raise AssertionError(f"[ops] the subprocess never logged epoch "
                                 f"2 (rc {proc.returncode}): "
                                 f"{f.read()[-2000:]}")
    bundle = ttrain.load_resume(os.path.join(exp_of("killed"),
                                             "s_0_resume.pt"))
    log(f"[ops] subprocess SIGKILLed {time.perf_counter() - t0:.1f} s after "
        f"its start, after {len(open(log_path).read().splitlines())} "
        f"epoch records; its bundle holds epoch {int(bundle['epoch'])}")
    run("killed_resume", cli_main.main, flags + [
        "--results_dir", killed, "--max_epochs", "4", "--resume",
        "--overwrite"])

    fold("straight", "straight", 4, epochs=4)
    fold("orbax", "orbax", 2, "--ckpt_format", "orbax")
    kept = sorted(f for f in os.listdir(exp_of("orbax")) if "resume" in f)
    if kept != ["s_0_resume.pt"]:
        raise AssertionError(f"[ops] --ckpt_format orbax bundle {kept}")
    fold("orbax_resume", "orbax", 4, "--ckpt_format", "orbax", "--resume",
         "--overwrite")

    cfg = ttrain.TrainConfig(model_type="path_attention_mil", mode="path",
                             gate_path=True, drop_out=True)
    init = ttrain.build_model(cfg, torch.Generator().manual_seed(1)
                              ).state_dict()
    straight = exp_of("straight")
    same = {name: _same_or_distance(f"{name} vs straight", exp_of(name),
                                    straight, init)
            for name in ("traced", "killed", "orbax")}

    # the bundle's write, from the card's tensors as training writes it
    bundle = {k: v if k == "generator" else v.cuda()
              for k, v in ttrain.load_resume(
                  os.path.join(straight, "s_0_resume.pt")).items()}
    path = os.path.join(root, "ops", "bundle.pt")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttrain.save_resume(path, bundle)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[ops] resume bundle .pt: {os.path.getsize(path) / 1e6:.3f} MB "
        f"written in " + ", ".join(f"{t:.3f}" for t in times) + " ms (3 "
        "writes, host clock)")

    # an epoch with and without the profiler
    def secs(name):
        with open(os.path.join(exp_of(name), "0", "metrics.jsonl")) as f:
            return [json.loads(x)["sec"] for x in f][:2]
    log(f"[ops] epoch s with the profiler (traced, epochs 0-1) "
        + ", ".join(f"{s:.3f}" for s in secs("traced")) + "; without "
        "(straight, epochs 0-1) " + ", ".join(f"{s:.3f}" for s in
                                               secs("straight")))
    trace = os.path.join(prof, "fold0.pt.trace.json")
    counts = _trace_kernels(trace)
    first = {"_fused_pool_cuda": 2 * (steps + evals) + 2 * evals,
             "_fused_pool_bwd_cuda": 2 * steps}
    log(f"[ops] trace {os.path.getsize(trace) / 1e6:.1f} MB: sub-kernel "
        f"launches " + ", ".join(
            f"{n} {counts[n]} ({counts[n] / first[c]:.2f} per "
            f"{c.strip('_')} launch)" for c, names in OPS_SUBKERNELS.items()
            for n in names) + f" over {first} counted launches")
    if not all(counts.values()):
        raise AssertionError(f"[ops] sub-kernels missing from the trace: "
                             f"{counts}")
    with open(os.path.join(prof, "stage_timings.json")) as f:
        log(f"[ops] stage_timings.json {f.read().split()}")
    tb = [n for n in os.listdir(os.path.join(exp_of("traced"), "0"))
          if n.startswith("events.out.tfevents")]
    if len(tb) != 1:
        raise AssertionError(f"[ops] event files {tb}")

    # export, check, serve
    art = os.path.join(root, "ops", "scorer.pt2")
    run("export_cuda", export_model.main, [
        "--model_path", straight, "--platforms", "cuda", "--check",
        "--out", art], fwd=2, bwd=0)
    log(f"[ops] export --platforms cuda --check: {wall['export_cuda']:.2f} "
        f"s, artifact {os.path.getsize(art) / 1e6:.3f} MB")
    run("export_cpu", export_model.main, [
        "--model_path", straight, "--platforms", "cpu", "--check",
        "--out", os.path.join(root, "ops", "scorer_cpu.pt2")], fwd=0, bwd=0)
    log(f"[ops] export --platforms cpu --check: {wall['export_cpu']:.2f} s")
    # any list but cuda alone is exported and checked on the CPU
    run("export_mixed", export_model.main, [
        "--model_path", straight, "--platforms", "cuda", "cpu", "--check",
        "--out", os.path.join(root, "ops", "scorer_mixed.pt2")], fwd=0,
        bwd=0)
    log(f"[ops] export --platforms cuda cpu --check: "
        f"{wall['export_mixed']:.2f} s")
    scorer = model_export.load_scorer(art)
    with open(art + ".json") as f:
        probe = {k: torch.as_tensor(v, device="cuda") for k, v in
                 export_model.probe_inputs(json.load(f)).items()}
    model = load_experiment_model(
        straight, 0, config_from_settings(read_experiment(straight)),
        torch.device("cuda"))
    for c in launch_counters:
        c.launches = 0
    got = scorer(probe)
    torch.cuda.synchronize()
    launches["served_artifact"] = count()
    with torch.inference_mode():
        want = model(**probe)
        t_art = _time_ms(lambda: scorer(probe))
        t_eager = _time_ms(lambda: model(**probe))
        t_art2 = _time_ms(lambda: scorer(probe))
    err = max(float((got[k] - want[k]).abs().max()) for k in got)
    log(f"[ops] artifact served B=8 N=512: launches "
        f"{launches['served_artifact']}; max |artifact - eager| {err:.2e}; "
        f"{t_art:.3f} / {t_art2:.3f} ms against the eager model's "
        f"{t_eager:.3f} ms (CUDA events, 20 calls after 3)")
    if launches["served_artifact"] != {"_fused_pool_cuda": 1,
                                       "_fused_pool_bwd_cuda": 0} \
            or err > 1e-5:
        raise AssertionError("[ops] the artifact did not serve through the "
                             "forward kernel")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run("doctor", doctor.main, ["--full"], fwd=1, bwd=1)
    text = out.getvalue()
    for line in text.splitlines():
        if "kernels" in line or "numerics" in line or "doctor" in line:
            log(f"[ops] doctor {line}")
    for name in ("mil_pool_fwd", "mil_pool_bwd"):
        if f"[ok]   numerics: {name} matches its plain version" not in text:
            raise AssertionError(f"[ops] doctor --full: {name}")
    log(f"[ops] resumed folds bit for bit: {same}; wall s "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    log(f"[ops] kernel launches {launches}")
    return launches


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _csv_rows(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_table(tag, got, want, key, text, sort_col=None, rtol=1e-4):
    """Two CSVs of one CLI (card, CPU): the same rows by ``key``, the
    ``text`` columns equal, every other column within ``rtol`` of its
    largest |value|.  The card's row order must be the CPU's, or, where
    ``sort_col`` ranks the rows (within the key's leading columns), an
    order of the CPU's values that is non-increasing within that
    tolerance (two near-equal values may swap).  Returns the largest
    relative error."""
    def keyed(rows):
        return {tuple(r[k] for k in key): r for r in rows}
    g, w = keyed(got), keyed(want)
    if list(g) != list(w) and (sorted(g) != sorted(w) or sort_col is None):
        raise AssertionError(f"[interpret] {tag}: rows differ")
    num = [c for c in want[0] if c not in text and c not in key]
    err = 0.0
    for c in num:
        wv = np.array([float(w[k][c]) for k in w])
        gv = np.array([float(g[k][c]) for k in w])
        err = max(err, float(np.abs(gv - wv).max()
                             / max(np.abs(wv).max(), 1e-30)))
        if c == sort_col and list(g) != list(w):
            scale = rtol * max(np.abs(wv).max(), 1e-30)
            ks = list(g)
            if [k[:-1] for k in ks] != [k[:-1] for k in w] or any(
                    a[:-1] == b[:-1] and
                    float(w[b][c]) - float(w[a][c]) > scale
                    for a, b in zip(ks, ks[1:])):
                raise AssertionError(f"[interpret] {tag}: order differs")
    for c in text:
        if any(g[k][c] != w[k][c] for k in w):
            raise AssertionError(f"[interpret] {tag}: column {c} differs")
    if err > rtol:
        raise AssertionError(f"[interpret] {tag}: rel err {err:.2e} > "
                             f"{rtol:g}")
    return err


def _readout_stages(model, bags):
    """[interpret]'s read-out, stage by stage, as ``model`` (a gated
    PathAMIL or RadioAMIL) computes it in its own types: the fused
    sequences (a radio model with several), the FC output h, the gate
    products a = tanh(h Wa + ba) and b = sigmoid(h Wb + bb), and the raw
    scores s = (a b) wc + cc; each on the host."""
    import torch
    out = {}
    if getattr(model, "n_modalities", 1) > 1:
        out["fused"] = model.fuse_radio(bags, None, model.compute_dtype)
    h = model.embed(bags)
    p = model.pool.attn_params()
    h = h.to(torch.promote_types(h.dtype, p.Wa.dtype))
    out["h"] = h
    out["a"] = torch.tanh(h @ p.Wa + p.ba)
    out["b"] = torch.sigmoid(h @ p.Wb + p.bb)
    out["s"] = ((out["a"] * out["b"]) @ p.wc + p.cc)[..., 0]
    return {k: v.cpu() for k, v in out.items()}


def phase_interpret(launch_counters, exps, root=None):
    """[interpret] Stage 5 on the card, each check against the CPU in the
    same call, all in f32, on the experiments of [radio] (``exps``), with
    the launch counters reset just before each run and read just after:
      - the attention read-out (``attention_only``) of the radio
        experiment on its first served batch and of a PathAMIL (small,
        seeded weights) on one 32,768 x 1024 bag: its raw scores against
        the CPU's at rel 1e-5, launching no kernel; then
        ``masked_softmax_pool`` of those scores against the pooled
        features that ``forward(return_features=True)`` gets from
        mil_pool_fwd (one launch), at rel 1e-5;
      - MMAttentionMIL(return_attention=True) on a radio_path_omic batch:
        A_raw of both branches at rel 1e-5, no launch;
      - cli.create_attributions on the stage-4 early-fcnn experiment:
        attr.csv and attr_orig.csv at rel 1e-4 (the IG completeness gap
        printed by the CLI);
      - cli.create_heatmaps, radio branch over every subject: scores.csv
        with the same slices and groups, attention at rel 1e-5;
      - cli.create_heatmaps, omic branch on the max_net: ig, and
        expected_gradients with the same draws on both devices, both CSVs
        at rel 1e-4.
    No CLI of the phase launches a kernel.  Returns the launch counts by
    run."""
    import torch
    from multimodalfusion_tpu_torch.cli import (create_attributions,
                                                create_heatmaps, infer)
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.engine import train as ttrain
    from multimodalfusion_tpu_torch.models.amil import PathAMIL
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, read_experiment)
    from multimodalfusion_tpu_torch.utils.params import spec_from_config
    wall, launches = {}, {}
    none = {c.__name__: 0 for c in launch_counters}
    one_fwd = dict(none, _fused_pool_cuda=1)

    def reset():
        for c in launch_counters:
            c.launches = 0

    def timed(stage, fn, *args, want=none):
        reset()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall[stage] = time.perf_counter() - t0
        launches[stage] = {c.__name__: c.launches for c in launch_counters}
        if launches[stage] != want:
            raise AssertionError(f"[interpret] {stage} launched "
                                 f"{launches[stage]}, expected {want}")
        return out

    def served_batch(exp, B=8):
        """(model on the card, model on the CPU, the first served batch
        as each one's inputs)."""
        settings = read_experiment(exp)
        view = infer._scored_split(settings, settings["csv_path"],
                                   settings["data_root_dir"], 0)
        cfg = config_from_settings(settings, batch_size=B, omic_input_dim=(
            view.genomic_features.shape[1]))
        batch = next(iter_batches(view, batch_size=B))
        out = []
        for dev in ("cuda", "cpu"):
            model = ttrain.build_model(cfg).to(dev).eval()
            ttrain.load_checkpoint(model, os.path.join(
                exp, "s_0_minloss_checkpoint.pt"), spec_from_config(cfg))
            out += [model, ttrain.model_inputs(cfg, batch,
                                               torch.device(dev))]
        return out

    def readout_vs_kernel(tag, gpu, cpu, kw, kw_cpu):
        """The card's raw scores against a float64 reference (a copy of
        the CPU model in ``.double()``), at rel 1e-5; the CPU's own f32
        error against it and card vs CPU beside it, and each stage's
        error on both devices, so the op that separates them shows."""
        ref = copy.deepcopy(cpu).double()
        ref.compute_dtype = torch.float64
        with torch.no_grad():
            s = timed(f"readout_{tag}", lambda: gpu(**kw,
                                                    attention_only=True))
            s_cpu = cpu(**kw_cpu, attention_only=True)
            s64 = ref(kw_cpu["bags"].double(), kw_cpu["mask"].double(),
                      attention_only=True)
            e_card, e_cpu = rel_err(s.cpu(), s64), rel_err(s_cpu, s64)
            e_s = rel_err(s.cpu(), s_cpu)
            st = [_readout_stages(m, b) for m, b in (
                (gpu, kw["bags"]), (cpu, kw_cpu["bags"]),
                (ref, kw_cpu["bags"].double()))]
            h = gpu.embed(kw["bags"]).float()
            pooled = mil.masked_softmax_pool(s, h, kw["mask"])[0]
            fused = timed(f"pooled_{tag}", lambda: gpu(
                **kw, return_features=True), want=one_fwd)
        e_p = rel_err(pooled, fused)
        stages = ", ".join(f"{k} card {rel_err(st[0][k], v):.2e} CPU "
                           f"{rel_err(st[1][k], v):.2e}"
                           for k, v in st[2].items())
        log(f"[interpret] read-out {tag} {tuple(kw['bags'].shape)}: raw "
            f"scores card vs float64 rel {e_card:.2e} (tol 1e-5), CPU vs "
            f"float64 {e_cpu:.2e}, card vs CPU {e_s:.2e}, launches "
            f"{launches[f'readout_{tag}']}; each stage vs float64: "
            f"{stages}; masked_softmax_pool(scores) vs "
            f"mil_pool_fwd's pooled features rel {e_p:.2e}, launches "
            f"{launches[f'pooled_{tag}']} (tol 1e-5)")
        if max(e_card, e_p) > 1e-5:
            raise AssertionError(f"[interpret] read-out {tag} disagrees")

    with _workdir(root, "interpret") as td:
        # the read-out against the forward kernel: a radio batch, then a
        # realistic WSI bag
        gpu, kw, cpu, kw_cpu = served_batch(exps["radio"])
        readout_vs_kernel("radio", gpu, cpu, kw, kw_cpu)
        cpu = PathAMIL("small", gate=True,
                       generator=torch.Generator().manual_seed(11)).eval()
        gpu = PathAMIL("small", gate=True).cuda().eval()
        gpu.load_state_dict(cpu.state_dict())
        bag = torch.randn(1, 32768, 1024,
                          generator=torch.Generator().manual_seed(12)) * 0.5
        mask = torch.ones(1, 32768)
        readout_vs_kernel("path_32768", gpu, cpu,
                          {"bags": bag.cuda(), "mask": mask.cuda()},
                          {"bags": bag, "mask": mask})

        # the trimodal model's A_raw
        gpu, kw, cpu, kw_cpu = served_batch(exps["radio_path_omic"])
        with torch.no_grad():
            out = timed("return_attention_radio_path_omic", lambda: gpu(
                **kw, return_attention=True))
            want = cpu(**kw_cpu, return_attention=True)
        errs = {n: rel_err(out["A_raw"][n].cpu(), want["A_raw"][n])
                for n in ("radiology", "pathology")}
        log(f"[interpret] MMAttentionMIL radio_path_omic return_attention: "
            f"A_raw card vs CPU rel "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tol 1e-5), launches "
            f"{launches['return_attention_radio_path_omic']}")
        if sorted(out["A_raw"]) != ["pathology", "radiology"] or \
                max(errs.values()) > 1e-5:
            raise AssertionError("[interpret] A_raw disagrees")

        # the CLIs, on the card and on the CPU
        def both(stage, fn, argv, out_dir):
            for dev in ("cuda", "cpu"):
                rc = timed(f"{stage}_{dev}", fn, argv(dev) + [
                    "--device", dev])
                if rc != 0:
                    raise AssertionError(f"[interpret] {stage} on {dev}: "
                                         f"rc={rc}")
            return [os.path.join(td, stage, dev, out_dir)
                    for dev in ("cuda", "cpu")]

        s4 = exps["stage4"]
        s4_settings = read_experiment(s4)
        sub = os.path.join("brain", os.path.basename(
            s4_settings["split_dir"]), os.path.basename(s4))
        dirs = both("create_attributions", create_attributions.main,
                    lambda dev: ["--model_path", s4, "--save_dir",
                                 os.path.join(td, "create_attributions",
                                              dev)], sub)
        for name in ("attr.csv", "attr_orig.csv"):
            e = _same_table(f"create_attributions {name}",
                            *[_csv_rows(os.path.join(d, name))
                              for d in dirs], ["subject_id"], [])
            log(f"[interpret] create_attributions {name}: "
                f"{len(_csv_rows(os.path.join(dirs[1], name)))} subjects, "
                f"card vs CPU rel {e:.2e} (tol 1e-4)")

        radio_settings = read_experiment(exps["radio"])
        subjects = os.path.join(td, "subjects.csv")
        with open(subjects, "w") as f:
            f.write("subject_id\n" + "".join(f"{r['subject_id']}\n" for r in
                                             _csv_rows(radio_settings[
                                                 "csv_path"])))

        def config(stage, dev, branch, data, model, method=None):
            """A heatmap config, as examples/heatmap_*.yaml, saving to
            td/stage/dev."""
            path = os.path.join(td, f"{stage}_{dev}.yaml")
            with open(path, "w") as f:
                f.write(f"exp_arguments:\n  branch: {branch}\n  save_dir: "
                        f"'{os.path.join(td, stage, dev)}'\n"
                        f"data_arguments: {data}\nmodel_arguments:\n  "
                        f"ckpt_path: '{model}'\n  which_k: 0\n"
                        + (f"heatmap_arguments: {{method: {method}}}\n"
                           if method else ""))
            return ["--config", path]

        seqs = ", ".join(radio_settings["radio_modality"])
        data = (f"{{process_list: '{subjects}', feat_dir: "
                f"'{radio_settings['data_root_dir']}', modalities: "
                f"[{seqs}]}}")
        dirs = both("heatmap_radio", create_heatmaps.main,
                    lambda dev: config("heatmap_radio", dev, "radio", data,
                                       exps["radio"]), "")
        rows = [_csv_rows(os.path.join(d, "scores.csv")) for d in dirs]
        e = _same_table("create_heatmaps radio scores.csv", *rows,
                        ["subject_id", "slice_index"], ["group"],
                        sort_col="attention", rtol=1e-5)
        log(f"[interpret] create_heatmaps radio: {len(rows[1])} slices of "
            f"{len({r['subject_id'] for r in rows[1]})} subjects, groups "
            f"equal, attention card vs CPU rel {e:.2e} (tol 1e-5)")

        for method in ("ig", "expected_gradients"):
            stage = f"heatmap_omic_{method}"
            dirs = both(stage, create_heatmaps.main,
                        lambda dev: config(stage, dev, "omic", "{}",
                                           exps["omic"], method), "")
            for name, key, sort_col in (
                    ("omic_attr_per_patient.csv", "subject_id", None),
                    ("omic_attr_global.csv", "gene", "mean_abs_attr")):
                e = _same_table(f"create_heatmaps omic {method} {name}",
                                *[_csv_rows(os.path.join(d, name))
                                  for d in dirs], [key], [],
                                sort_col=sort_col)
                log(f"[interpret] create_heatmaps omic {method} {name}: "
                    f"card vs CPU rel {e:.2e} (tol 1e-4)")
    log(f"[interpret] wall s ({_card()}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items()))
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


def _bound(h, mask, Da, gated, dropout=False, backward=False):
    """Least time (ms) for the function on these inputs: bytes each input
    read once and each output written once, over HBM rate; and the
    matrix-product operations the valid rows need, over the peak for the
    bag's type.  Returns (ms, 'bytes' | 'operations').

    Forward: the scoring products (2 n D Kc, Kc = 2 Da gated, Da ungated)
    and the pooling (2 n D); reads the valid bag rows, the mask, the keep
    masks of the valid rows and the weights; writes pooled and ml.
    Backward: the scoring products again, dh = [dpa | dpb] W^T and
    dW = h^T [dpa | dpb] (6 n D Kc in all, the TPU kernel's CostEstimate)
    and the g.h and a g terms (4 n D); reads the same plus g, out and ml;
    writes dh [B, N, D] and the parameter gradients."""
    B, N, D = h.shape
    n_valid = float(mask.sum())
    item = h.element_size()
    Kc = (2 if gated else 1) * Da
    nbytes = (n_valid * D * item + B * N * 4           # bag rows, mask
              + D * Kc * item                          # Wa, Wb
              + (3 * Da + 1) * 4 + B * (D + 2) * 4)    # vectors, outputs
    if dropout:
        nbytes += n_valid * Kc                         # u8 keep masks
    flops = 2 * n_valid * D * Kc + 2 * n_valid * D
    if backward:
        nbytes += (B * N * D * item                    # dh
                   + 2 * B * D * 4                     # g, out
                   + (D * Kc + 3 * Da + 1) * 4)        # parameter grads
        flops = 6 * n_valid * D * Kc + 4 * n_valid * D
    dtype = str(h.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _max_abs(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _device_time(fn, reps=5):
    """torch.profiler over ``reps`` calls of fn: {kernel name: device
    microseconds per call} and the wall milliseconds per call."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_kernel = {}
    for e in prof.key_averages():
        # device work only: no host events, no annotated ranges (such as
        # Optimizer.step) that the profiler also draws on the card
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        short = re.search(r"(\w+_kernel)\b", e.key)
        name = short.group(1) if short else e.key[:60]
        per_kernel[name] = per_kernel.get(name, 0.0) + us / reps
    return per_kernel, wall_ms


def phase_timing(B=32, N=4096, D=256, Da=256):
    """Each kernel variant against its plain version on the same inputs,
    timed plain, kernel, plain; gated, at the training and serving shape.
    The f32 forward also against cuBLAS's f32 product h [Wa | Wb] of the
    same shape (TF32 off): not the same function (no score, softmax or
    pooling), a yardstick for the SGEMM core on its dominant product.  The
    bf16 backward against cuBLAS's bf16 products of its three shapes, each
    timed alone (scores h [Wa | Wb], dh = dp Wcat, dW = h^T dp at M = B N
    rows): a yardstick for its tensor-core products, which the port never
    calls; cuBLAS's bf16 scoring product is also the bf16 forward's
    yardstick.  The forward variants and the backward's dropout and bf16
    variants are also profiled kernel by kernel, and the forward's
    partial kernel reports the CTAs it runs on an SM by variant."""
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    res = {"mil_pool_fwd": {}, "mil_pool_bwd": {}}
    dev = torch.device("cuda")
    log("[timing] mil_pool_fwd partial kernel CTAs per SM (gated; "
        "mil_pool_fwd_ctas_per_sm): " + ", ".join(
            f"{dt} D={d}{' dropout' if drop else ''} "
            f"{mil._fwd_ctas_per_sm(dev, d, True, dt == 'bfloat16', drop)}"
            for dt in ("float32", "bfloat16") for d in (D, mil._MAX_D)
            for drop in (False, True)))
    for dtype in ("float32", "bfloat16"):
        h, mask, params = make_pool_case(B, N, D, Da, dtype, seed=123)
        cublas_ms = bwd_cublas = None
        if dtype == "bfloat16":
            hv = h.view(-1, D)
            w = torch.cat([params.Wa, params.Wb], 1).to(h.dtype)
            wcat = w.t().contiguous()
            dp = torch.randn(B * N, 2 * Da, device="cuda").to(h.dtype)
            with torch.no_grad():
                bwd_cublas = {"scores": _time_ms(lambda: hv @ w),
                              "dh": _time_ms(lambda: dp @ wcat),
                              "dW": _time_ms(lambda: hv.t() @ dp)}
            bwd_cublas["sum"] = sum(bwd_cublas.values())
            cublas_ms = bwd_cublas["scores"]
            gflop = 2 * B * N * D * 2 * Da / 1e9
            log(f"[timing] yardstick: cuBLAS bf16 products of the backward "
                f"({B * N} x {D} x {2 * Da}, {gflop:.1f} GFLOP each, "
                f"alone): h.view(-1, {D}) @ cat([Wa, Wb], 1) "
                f"{bwd_cublas['scores']:.3f} ms, dp @ Wcat "
                f"{bwd_cublas['dh']:.3f} ms, h.view(-1, {D}).t() @ dp "
                f"{bwd_cublas['dW']:.3f} ms; sum {bwd_cublas['sum']:.3f} ms")
            del dp
        if dtype == "float32":
            assert not torch.backends.cuda.matmul.allow_tf32
            w = torch.cat([params.Wa, params.Wb], 1)
            with torch.no_grad():
                cublas_ms = _time_ms(lambda: h.view(-1, D) @ w)
            log(f"[timing] yardstick: cuBLAS f32 h.view(-1, {D}) @ "
                f"cat([Wa, Wb], 1) ({B * N} x {D} x {2 * Da}, "
                f"{2 * B * N * D * 2 * Da / 1e9:.1f} GFLOP, TF32 off): "
                f"{cublas_ms:.3f} ms")
        gen = torch.Generator(device="cuda").manual_seed(5)
        masks = mil.make_dropout_masks(gen, (B, N, Da), True)
        g = torch.randn(B, D, generator=gen, device="cuda")
        for dropout in (False, True):
            da, db = masks if dropout else (None, None)
            variant = (f"B={B} N={N} D={D} Da={Da} {dtype} gated"
                       + (" dropout" if dropout else ""))
            with torch.no_grad():
                out, ml = mil._fused_pool_cuda(h, mask, params, True, da, db)
                ref, ref_ml = mil._pool_plain(h, mask, params, True, da, db)
                runs = {
                    "mil_pool_fwd": (
                        (out,), (ref,),
                        lambda: mil._fused_pool_cuda(h, mask, params, True,
                                                     da, db),
                        lambda: mil._pool_plain(h, mask, params, True, da,
                                                db)),
                    "mil_pool_bwd": (
                        mil._fused_pool_bwd_cuda(h, mask, params, ref,
                                                 ref_ml, g, True, da, db),
                        mil._pool_bwd_plain(h, mask, params, ref, ref_ml, g,
                                            True, da, db),
                        lambda: mil._fused_pool_bwd_cuda(
                            h, mask, params, ref, ref_ml, g, True, da, db),
                        lambda: mil._pool_bwd_plain(
                            h, mask, params, ref, ref_ml, g, True, da, db)),
                }
                for name, (got, want, kern, plain) in runs.items():
                    if name == "mil_pool_bwd":  # (dh, AttnParams)
                        got, want = (got[0], *got[1]), (want[0], *want[1])
                    err = _max_abs(got, want)
                    plain1 = _time_ms(plain)
                    ms = _time_ms(kern)
                    plain2 = _time_ms(plain)
                    bound_ms, bound_by = _bound(
                        h, mask, Da, True, dropout,
                        backward=name == "mil_pool_bwd")
                    res[name][variant] = {
                        "ms": ms, "plain_ms": min(plain1, plain2),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "max_abs_err": err}
                    yardstick = ""
                    if name == "mil_pool_fwd":
                        res[name][variant]["cublas_product_ms"] = cublas_ms
                        yardstick = (f", cuBLAS {dtype} product "
                                     f"{cublas_ms:.3f} ms (kernel/cuBLAS "
                                     f"{ms / cublas_ms:.2f})")
                    if name == "mil_pool_bwd" and bwd_cublas is not None:
                        res[name][variant]["cublas_products_ms"] = bwd_cublas
                        yardstick = (f", cuBLAS bf16 products "
                                     f"{bwd_cublas['sum']:.3f} ms")
                    log(f"[timing] {name} {variant}: kernel {ms:.3f} ms, "
                        f"plain {plain1:.3f}/{plain2:.3f} ms, bound "
                        f"{bound_ms * 1e3:.1f} us ({bound_by}), "
                        f"kernel/bound {ms / bound_ms:.1f}, max abs err "
                        f"{err:.2e}{yardstick}")
                    # every forward variant and the backward's training
                    # and bf16 variants, kernel by kernel
                    if (dropout or name == "mil_pool_fwd"
                            or dtype == "bfloat16"):
                        per_kernel, _ = _device_time(kern)
                        res[name][variant]["profile_us"] = per_kernel
                        log(f"[timing] {name} {variant}, torch.profiler "
                            f"device time per call: " + ", ".join(
                                f"{k} {v:.1f} us"
                                for k, v in per_kernel.items()))
    return res


def phase_timing_radio(B=8, N=256, D=256, Da=256):
    """Both kernels at the radiology shape (RadioAMIL small: B=8 bags of
    140-155 slices padded to 256, D=Da=256, gated, f32, then the same
    bags in bf16): the serving and evaluation forward, the training
    forward (dropout) and the training backward (dropout) and its variant
    without; kernel vs plain on the same inputs, timed plain, kernel,
    plain; the bound; and, on the log line only, how many CTAs each launch
    gave the card's SMs, from the plan the wrapper launched with."""
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    res = {"mil_pool_fwd": {}, "mil_pool_bwd": {}}
    h32, mask, params = make_pool_case(B, N, D, Da, "float32", seed=321,
                                       lens=RADIO_LENS)
    gen = torch.Generator(device="cuda").manual_seed(9)
    masks = mil.make_dropout_masks(gen, (B, N, Da), True)
    g = torch.randn(B, D, generator=gen, device="cuda")
    sms = mil._sms(torch.device("cuda"))
    launched = {"mil_pool_fwd": mil._fused_pool_cuda,
                "mil_pool_bwd": mil._fused_pool_bwd_cuda}
    for dtype in ("float32", "bfloat16"):
        h = h32.to(getattr(torch, dtype))
        for dropout in (False, True):
            da, db = masks if dropout else (None, None)
            variant = (f"B={B} N={N} D={D} Da={Da} {dtype} gated"
                       + (" dropout" if dropout else ""))
            with torch.no_grad():
                out, _ = mil._fused_pool_cuda(h, mask, params, True, da, db)
                ref, ref_ml = mil._pool_plain(h, mask, params, True, da, db)
                kb = mil._fused_pool_bwd_cuda(h, mask, params, ref, ref_ml,
                                              g, True, da, db)
                pb = mil._pool_bwd_plain(h, mask, params, ref, ref_ml, g,
                                         True, da, db)
                runs = {
                    "mil_pool_fwd": (
                        (out,), (ref,),
                        lambda: mil._fused_pool_cuda(h, mask, params, True,
                                                     da, db),
                        lambda: mil._pool_plain(h, mask, params, True, da,
                                                db)),
                    "mil_pool_bwd": (
                        (kb[0], *kb[1]), (pb[0], *pb[1]),
                        lambda: mil._fused_pool_bwd_cuda(
                            h, mask, params, ref, ref_ml, g, True, da, db),
                        lambda: mil._pool_bwd_plain(
                            h, mask, params, ref, ref_ml, g, True, da, db)),
                }
                for name, (got, want, kern, plain) in runs.items():
                    err = _max_abs(got, want)
                    plain1 = _time_ms(plain, iters=50)
                    ms = _time_ms(kern, iters=50)
                    ctas = launched[name].last_plan.ctas()
                    plain2 = _time_ms(plain, iters=50)
                    bound_ms, bound_by = _bound(
                        h, mask, Da, True, dropout,
                        backward=name == "mil_pool_bwd")
                    res[name][variant] = {
                        "ms": ms, "plain_ms": min(plain1, plain2),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "max_abs_err": err}
                    log(f"[timing] radio {name} {variant}: kernel "
                        f"{ms:.4f} ms, plain {plain1:.4f}/{plain2:.4f} ms, "
                        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                        f"kernel/bound {ms / bound_ms:.1f}, max abs err "
                        f"{err:.2e}; CTAs per launch {ctas} on {sms} SMs")
    _log_wrapper_host_time(h32, mask, params, g)
    return res


def _host_us(fn, iters=50):
    """Host microseconds per call of ``fn`` to enqueue its work: the
    calls run back to back from an idle card, with no synchronize between
    them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def _log_wrapper_host_time(h, mask, params, g):
    """What the width-padding layer costs the host per call at widths that
    take no padding: each wrapper against the launch it wraps, on the same
    inputs, in turns (wrapper, launch, wrapper, launch), the lower of each
    pair kept."""
    import torch
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    rate = mil.ATTN_DROPOUT_RATE
    with torch.no_grad():
        out, ml = mil._pool_plain(h, mask, params, True)
        pairs = {
            "forward": (lambda: mil._fused_pool_cuda(h, mask, params, True),
                        lambda: mil._launch_fwd(h, mask, params, True, None,
                                                None, rate)),
            "backward": (lambda: mil._fused_pool_bwd_cuda(
                h, mask, params, out, ml, g, True),
                lambda: mil._launch_bwd(h, mask, params, out, ml, g, True,
                                        None, None, rate))}
        parts = []
        for name, (wrapper, launch) in pairs.items():
            times = [_host_us(f) for f in (wrapper, launch, wrapper, launch)]
            parts.append(f"{name} wrapper {min(times[0::2]):.1f} us, its "
                         f"launch alone {min(times[1::2]):.1f} us")
    log(f"[timing] host time per call to enqueue, radio shape, no padding "
        f"(host clock, 50 calls back to back, lower of two): "
        + "; ".join(parts))


def _pinned_copy(batch, pool):
    """``batch`` with its bags copied into ``pool``'s page-locked buffers,
    as the loader collates them for a CUDA device."""
    out = dict(batch)
    for k in ("path_bags", "path_mask"):
        out[k] = pool.take(batch[k].shape)
        np.copyto(out[k], batch[k])
    return out


STEP_STAGES = ("fc fwd", "pool fwd", "head+loss", "pool bwd", "fc bwd",
               "optimizer")


def _step_parts(cfg):
    """(model on the card in training mode, optimizer, loss spec) of
    ``cfg`` from the seeded init."""
    import torch
    from multimodalfusion_tpu_torch.engine import train as ttrain
    model = ttrain.build_model(cfg, torch.Generator().manual_seed(0)).cuda()
    model.train()
    return (model, ttrain.make_optimizer(cfg, model.parameters()),
            ttrain.make_loss_spec(cfg))


def _device_step(model, opt, spec, kw, lab, gen, timed=False):
    """One training step of a PathAMIL on inputs already on the card
    (``kw``: bags and mask; ``lab``: the labels).  ``timed``: CUDA events
    split it into ``STEP_STAGES`` (ms each, returned after a
    synchronize); autograd hooks mark where the backward leaves the head
    (gradient of the pooled features) and the pooling (gradient of the FC
    output)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    mark = (lambda i: ev[i].record()) if timed else (lambda i: None)
    opt.zero_grad(set_to_none=True)
    mark(0)
    h = model.embed(kw["bags"], gen)
    mark(1)
    M = model.pool(h, kw["mask"], gen).float()
    mark(2)
    out = model.head(M)
    loss = spec.apply(hazards=out["hazards"], S=out["S"], risks=out["risk"],
                      Y=lab["Y"], times=lab["t"], c=lab["c"],
                      valid=lab["valid"])
    if timed:
        M.register_hook(lambda grad: ev[4].record())
        h.register_hook(lambda grad: ev[5].record())
    loss.backward()
    mark(6)
    opt.step()
    mark(7)
    if not timed:
        return None
    torch.cuda.synchronize()
    return [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
            ev[2].elapsed_time(ev[4]), ev[4].elapsed_time(ev[5]),
            ev[5].elapsed_time(ev[6]), ev[6].elapsed_time(ev[7])]


def phase_step_breakdown(cfg, batches, host_ms):
    """One training step split into stages with CUDA events (host clock
    for the load, the collation and the copy), averaged over ``batches``
    after one untimed step.  The step copies its batch from page-locked
    buffers (``non_blocking``), as training on the card does; load,
    collate and the plain yardstick come from ``_collect_batches``."""
    import torch
    from multimodalfusion_tpu_torch.data.bags import PinnedPool
    from multimodalfusion_tpu_torch.engine import train as ttrain
    dev = torch.device("cuda")
    pool = PinnedPool()
    model, opt, spec = _step_parts(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    spent = dict.fromkeys(("copy",) + STEP_STAGES, 0.0)
    step_ms = 0.0
    for i, batch in enumerate([batches[0]] + list(batches)):
        timed = i > 0
        batch = _pinned_copy(batch, pool)
        t0 = time.perf_counter()
        kw = ttrain.model_inputs(cfg, batch, dev, pool)
        lab = ttrain.label_inputs(batch, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        parts = _device_step(model, opt, spec, kw, lab, gen, timed=True)
        if timed:
            spent["copy"] += (t1 - t0) * 1e3
            step_ms += (time.perf_counter() - t0) * 1e3
            for k, v in zip(STEP_STAGES, parts):
                spent[k] += v
    n = len(batches)
    res = {"load": float(np.mean(host_ms["load"])),
           "collate": float(np.mean(host_ms["collate"]))}
    res.update({k: v / n for k, v in spent.items()})
    res["step (copy .. optimizer, host clock)"] = step_ms / n
    buckets = [b["path_bags"].shape[1] for b in batches]
    log(f"[timing] training step, B={cfg.batch_size} bags x 1024 padded to "
        f"N in {buckets}, PathAMIL small gated, dropout, f32, mean of {n} "
        f"steps (host clock for load, collate, copy and step; CUDA events "
        f"for the rest): " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in res.items()))
    log(f"[timing] host path per batch (host clock, {n} batches, each "
        f"value in turn): " + "; ".join(
            f"{k} " + ", ".join(f"{v:.3f}" for v in vs) + " ms"
            for k, vs in host_ms.items()))
    res["yardstick: collate (pad_bags_plain)"] = float(
        np.mean(host_ms["collate (pad_bags_plain)"]))
    res["yardstick: copy (pageable)"] = float(
        np.mean(host_ms["copy (pageable, pad_bags_plain's batch)"]))

    # the card's busy share: device time of the whole train step (copy ..
    # optimizer) under torch.profiler, against the step's wall time with
    # and without the host loading of its batch
    train_step, _ = ttrain.make_steps(cfg, model, opt, dev)
    pinned = _pinned_copy(batches[0], pool)  # kept taken: copied each call
    per_kernel, wall_ms = _device_time(lambda: train_step(pinned, gen))
    copy_us = sum(v for k, v in per_kernel.items() if "Memcpy" in k)
    busy_ms = sum(v for k, v in per_kernel.items()
                  if "Memcpy" not in k) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    res.update({"profiled step wall": wall_ms, "profiled kernels": busy_ms,
                "profiled copies": copy_us / 1e3})
    log(f"[timing] train step under torch.profiler: wall {wall_ms:.3f} ms, "
        f"kernels {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%} busy; "
        f"{busy_ms / (wall_ms + res['load'] + res['collate']):.1%} with the "
        f"batch's load and collation), copies {copy_us / 1e3:.3f} ms; "
        f"largest: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in top))
    return res


def _bench_batch(B, N, seed):
    """The JAX package's benchmark batch (bench.py ``_setup``): bags [B, N,
    1024] f32 from a standard normal and a mask with 90% valid rows, drawn
    on the card from ``seed``; labels Y in 0..3, t in [1, 100), c in {0, 1}
    from numpy.  Returns (the host batch the engine's steps take, the bags
    and mask on the card, the labels on the card)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bags = torch.randn(B, N, 1024, generator=gen, device="cuda")
    mask = (torch.rand(B, N, generator=gen, device="cuda") < 0.9).float()
    rng = np.random.default_rng(seed)
    labels = {"Y": rng.integers(0, 4, size=B).astype(np.int32),
              "t": rng.uniform(1, 100, size=B).astype(np.float32),
              "c": rng.integers(0, 2, size=B).astype(np.float32),
              "valid": np.ones(B, np.float32)}
    batch = dict(labels, path_bags=bags.cpu().numpy(),
                 path_mask=mask.cpu().numpy())
    return batch, {"bags": bags, "mask": mask}, {
        k: torch.from_numpy(v).cuda() for k, v in labels.items()}


def phase_bf16step(launch_counters, B=48, N=4096, reps=5):
    """The JAX package's benchmark step through the port's engine: gated
    PathAMIL small with nll_surv and Adam at B=48 bags of 4096 x 1024 f32
    (90% valid rows), ``bag_dtype="bfloat16"`` (bench.py), without and
    with attention dropout.  Per arm: three train steps through the
    kernels against three through the plain versions (``_steps_agree``,
    one forward and one backward launch per kernel step, the bf16
    ``STEP_TOL``); the step on bags already on the card split with CUDA
    events as the f32 step is (``STEP_STAGES``, mean of ``reps`` after one
    untimed step); and the same step under torch.profiler: kernel time,
    wall and busy share.  Returns per arm the agreement, the split and
    the profile, and the launch counts of the kernel steps."""
    import torch
    from multimodalfusion_tpu_torch.engine import train as ttrain
    batch, kw, lab = _bench_batch(B, N, seed=0)
    res, launches = {}, {}
    for drop in (False, True):
        arm = "dropout" if drop else "no dropout"
        cfg = ttrain.TrainConfig(model_type="path_attention_mil",
                                 mode="path", bag_loss="nll_surv",
                                 gate_path=True, batch_size=B,
                                 bag_dtype="bfloat16", drop_out=drop,
                                 device="cuda")
        before = {c.__name__: c.launches for c in launch_counters}
        agree = _steps_agree("bf16step", cfg, [batch] * 3, launch_counters,
                             arm=f"{arm}: ")
        launches[arm] = {c.__name__: c.launches - before[c.__name__]
                         for c in launch_counters}
        model, opt, spec = _step_parts(cfg)
        gen = torch.Generator(device="cuda").manual_seed(7)
        parts = [_device_step(model, opt, spec, kw, lab, gen, timed=True)
                 for _ in range(reps + 1)][1:]
        split = {k: float(np.mean([p[i] for p in parts]))
                 for i, k in enumerate(STEP_STAGES)}
        split["step (sum)"] = sum(split.values())
        per_kernel, wall_ms = _device_time(
            lambda: _device_step(model, opt, spec, kw, lab, gen), reps)
        busy_ms = sum(per_kernel.values()) / 1e3
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        log(f"[bf16step] {arm}: B={B} N={N} x 1024 f32 bags on the card, "
            f"PathAMIL small gated, nll_surv, bf16, mean of {reps} steps "
            f"(CUDA events): " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in split.items()))
        log(f"[bf16step] {arm}: the step under torch.profiler: wall "
            f"{wall_ms:.3f} ms, kernels {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.1%} busy); largest: "
            + ", ".join(f"{k} {v:.1f} us" for k, v in top))
        res[arm] = dict(agree, split_ms=split, profiled_wall_ms=wall_ms,
                        profiled_kernels_ms=busy_ms, profile_us=per_kernel)
        del model, opt
    log(f"[bf16step] launches in the kernel steps: {launches}")
    return res, launches


def _expected_yamls(root, all_folds):
    """The heatmap configs that cli.summarize must emit for the tree at
    ``root``: every fold (or the best validation fold) of each PATH, RADIO
    and OMICS experiment whose summary.csv names it and whose minloss
    checkpoint exists; none for the MMF fusion heads."""
    out = set()
    for dirpath, _, files in os.walk(root):
        code = os.path.basename(dirpath).upper()
        if "summary.csv" not in files or not code.startswith(
                ("PATH", "RADIO", "OMIC")):
            continue
        rows = _csv_rows(os.path.join(dirpath, "summary.csv"))
        folds = [int(r["folds"]) for r in rows]
        vals = np.array([float(r["val_cindex"] or "nan") for r in rows])
        if not all_folds:
            if np.isnan(vals).all():
                continue
            folds = [folds[int(np.nanargmax(vals))]]
        exp = os.path.relpath(dirpath, root).replace(os.sep, "__")
        out |= {f"heatmap_config_{exp}_val_{k}.yaml" for k in folds
                if os.path.isfile(os.path.join(
                    dirpath, f"s_{k}_minloss_checkpoint.pt"))}
    return out


def phase_report(launch_counters, root):
    """[report] The reporting stage over the work tree, with the launch
    counters reset just before each run and read just after:
      - cli.main trains a 3-fold RadioAMIL small at [radio]'s full width on
        a 3-fold split of [radio]'s 32-subject cohort (concat, gated,
        --drop_out, nll_surv, B=8: [8, 256, 4096] f32 batches, two
        epochs): the forward once per train step and evaluated or summary
        batch, the backward once per train step, every loss finite; three
        kernel train steps on fold 0's batches agree with three plain ones;
      - cli.summarize over the whole work tree ([train]'s, [omic]'s,
        [radio]'s, [pretrained]'s and [ops]' experiments and this one) with
        --km --km_thresh 1.0 --percentiles 25,50,75 --hazard_hist
        --cohort_csv ([radio]'s cohort) --bootstrap 1000 --pivot
        --emit_heatmap_yamls --heatmap_template (examples/heatmap_radio.yaml
        rewritten with [radio]'s paths) --all_folds: no launch; one
        cv_summary.csv row per summary.csv; the new experiment's
        pooled_cindex equal to the c-index of its three pkls
        concatenated, finite iauc, ipcw_cindex and bootstrap bounds; one
        YAML per fold of each PATH, RADIO and OMICS experiment;
      - again without --all_folds, with examples/heatmap_omic.yaml
        rewritten the same way: one YAML per PATH, RADIO and OMICS
        experiment, none for MMF;
      - cli.create_heatmaps on an emitted RADIO config (the new
        experiment's fold 0) and an emitted OMICS config, unmodified: no
        launch, scores.csv and omic_attr_global.csv written.
    Returns the launch counts by run."""
    import contextlib
    import io

    import torch
    from multimodalfusion_tpu_torch import metrics
    from multimodalfusion_tpu_torch.cli import create_heatmaps
    from multimodalfusion_tpu_torch.cli import main as cli_main
    from multimodalfusion_tpu_torch.cli import summarize
    from multimodalfusion_tpu_torch.data.io import load_pkl
    from multimodalfusion_tpu_torch.data.loaders import iter_batches
    from multimodalfusion_tpu_torch.data.survival_dataset import \
        SurvivalDataset
    from multimodalfusion_tpu_torch.engine import train as ttrain
    from multimodalfusion_tpu_torch.utils import yaml_subset
    from multimodalfusion_tpu_torch.utils.experiment import read_experiment
    B, epochs, k_folds, n_subjects = 8, 2, 3, 32
    radio = os.path.join(root, "radio")
    td = os.path.join(root, "report")
    os.makedirs(td)
    launches, wall = {}, {}

    def run(stage, fn, argv, fwd, bwd, quiet=False):
        for c in launch_counters:
            c.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out) if quiet else \
                contextlib.nullcontext():
            rc = fn(argv)
        torch.cuda.synchronize()
        wall[stage] = time.perf_counter() - t0
        launches[stage] = {c.__name__: c.launches for c in launch_counters}
        want = {"_fused_pool_cuda": fwd, "_fused_pool_bwd_cuda": bwd}
        if rc != 0 or launches[stage] != want:
            raise AssertionError(f"[report] {stage}: rc={rc}, launches "
                                 f"{launches[stage]}, expected {want}")
        return out.getvalue()

    # 1. a 3-fold split of [radio]'s cohort, trained through both kernels
    cohort_csv = os.path.join(radio, "dataset_csv", "brain", "survival.csv")
    sids = [r["subject_id"] for r in _csv_rows(cohort_csv)]
    order = np.random.default_rng(15).permutation(len(sids))
    splits = os.path.join(td, "splits", "brain", "smoke3")
    os.makedirs(splits)
    want_fwd = want_bwd = 0
    for k in range(k_folds):
        val = [sids[i] for i in order[k::k_folds]]
        train = [s for s in sids if s not in set(val)]
        with open(os.path.join(splits, f"splits_{k}.csv"), "w") as f:
            f.write("train,val\n" + "".join(
                f"{t},{val[i] if i < len(val) else ''}\n"
                for i, t in enumerate(train)))
        steps, evals = -(-len(train) // B), -(-len(val) // B)
        want_fwd += epochs * (steps + evals) + 2 * evals
        want_bwd += epochs * steps
    results = os.path.join(td, "results")
    run("train_3fold", cli_main.main, [
        "--cancer_type", "brain", "--which_splits", "smoke3",
        "--data_root_dir", os.path.join(radio, "features"),
        "--dataset_root", os.path.join(radio, "dataset_csv"),
        "--splits_root", os.path.join(td, "splits")] + RADIO_FLAGS["radio"]
        + ["--k", str(k_folds), "--max_epochs", str(epochs),
           "--batch_size", str(B), "--results_dir", results, "--device",
           "cuda"], want_fwd, want_bwd)
    sub = os.path.join(results, "brain", "smoke3")
    exp = os.path.join(sub, os.listdir(sub)[0])
    losses = []
    for k in range(k_folds):
        with open(os.path.join(exp, str(k), "metrics.jsonl")) as f:
            losses += [json.loads(x)[c] for x in f
                       for c in ("train_loss", "val_loss")]
    log(f"[report] cli.main {k_folds}-fold RadioAMIL ({epochs} epochs): "
        f"{wall['train_3fold']:.2f} s, kernel launches "
        f"{launches['train_3fold']} (expected {want_fwd} / {want_bwd}); "
        f"losses finite: {bool(np.isfinite(losses).all())}")
    if len(losses) != 2 * k_folds * epochs or not np.isfinite(losses).all():
        raise AssertionError(f"[report] losses {losses}")
    ds = SurvivalDataset(cohort_csv, "radio",
                         os.path.join(radio, "features", "brain"), n_bins=4)
    train_split, _ = ds.load_splits(os.path.join(splits, "splits_0.csv"))
    batches = []
    for b in iter_batches(train_split, batch_size=B, shuffle=True, seed=3):
        b.pop("subject_ids")
        batches.append(b)
    if batches[0]["radio_bags"].shape != (B, 256, 4096):
        raise AssertionError(f"radio batch {batches[0]['radio_bags'].shape}")
    cfg = ttrain.TrainConfig(model_type="radio_attention_mil", mode="radio",
                             radio_fusion="concat", gate_radio=True,
                             drop_out=True, bag_loss="nll_surv",
                             batch_size=B, device="cuda")
    _steps_agree("report", cfg, batches[:3], launch_counters)

    # the templates, rewritten with [radio]'s paths
    settings = read_experiment(exp)
    subjects = os.path.join(td, "subjects.csv")
    with open(subjects, "w") as f:
        f.write("subject_id\n" + "".join(f"{s}\n" for s in sids[:8]))
    templates = {}
    for branch in ("radio", "omic"):
        tpl = yaml_subset.load_file(os.path.join(
            REPO, "examples", f"heatmap_{branch}.yaml"))
        tpl["exp_arguments"]["save_dir"] = os.path.join(td, "heatmaps")
        tpl["model_arguments"]["ckpt_path"] = exp
        if branch == "radio":
            # the cohort has feature h5 files and no raw scans to render
            tpl["data_arguments"] = {
                "process_list": subjects,
                "feat_dir": settings["data_root_dir"],
                "modalities": list(settings["radio_modality"])}
        templates[branch] = os.path.join(td, f"template_{branch}.yaml")
        yaml_subset.dump_file(tpl, templates[branch])

    # 2. every fold's config
    n_summaries = sum("summary.csv" in files
                      for _, _, files in os.walk(root))
    report = os.path.join(td, "summary_all")
    yamls = os.path.join(td, "yamls_all")
    common = ["--results_root", root, "--km", "--km_thresh", "1.0",
              "--percentiles", "25,50,75", "--hazard_hist", "--cohort_csv",
              cohort_csv, "--bootstrap", "1000", "--pivot"]
    text = run("summarize_all_folds", summarize.main, common + [
        "--save_dir", report, "--emit_heatmap_yamls", yamls,
        "--heatmap_template", templates["radio"], "--all_folds"], 0, 0,
        quiet=True)
    with open(os.path.join(td, "summarize_all_folds.log"), "w") as f:
        f.write(text)
    summary = _csv_rows(os.path.join(report, "cv_summary.csv"))
    stats = {r["experiment"]: r for r in _csv_rows(os.path.join(
        report, "risk_group_stats.csv"))}
    pivot = _csv_rows(os.path.join(report, "cv_pivot.csv"))
    name = os.path.relpath(exp, root).replace(os.sep, "__")
    pkls = [load_pkl(os.path.join(exp, f"split_train_val_{k}_results.pkl"))
            for k in range(k_folds)]
    cat = {c: np.concatenate([p[c] for p in pkls])
           for c in ("risk", "survival", "censorship")}
    want_c = metrics.concordance_index_censored(
        (1 - cat["censorship"]).astype(bool), cat["survival"],
        cat["risk"])[0]
    row = stats[name]
    got = {c: float(row[c]) for c in ("pooled_cindex", "iauc",
                                      "ipcw_cindex", "cindex_lo",
                                      "cindex_hi")}
    emitted = set(os.listdir(yamls)) - {"heatmap_results"}
    want_yamls = _expected_yamls(root, all_folds=True)
    skipped = [x for x in text.splitlines() if "skipped" in x
               or x.startswith("skipping")]
    log(f"[report] cli.summarize --all_folds over the work tree: "
        f"{wall['summarize_all_folds']:.2f} s, launches "
        f"{launches['summarize_all_folds']}; {len(summary)} cv_summary rows "
        f"for {n_summaries} summary.csv, pivot {len(pivot)} models x "
        f"{len(pivot[0]) - 1 if pivot else 0} cohorts, "
        f"{len(stats)} risk-group rows ({len(skipped)} lines skipped "
        f"something), {len(emitted)} YAMLs for {len(want_yamls)} folds; "
        f"{name}: n {row['n']}, pooled c-index {got['pooled_cindex']!r} "
        f"(concatenated pkls {want_c!r}), iauc {got['iauc']:.4f}, "
        f"ipcw_cindex {got['ipcw_cindex']:.4f}, bootstrap CI "
        f"[{got['cindex_lo']:.4f}, {got['cindex_hi']:.4f}]")
    for line in skipped:
        log(f"[report]   {line}")
    if len(summary) != n_summaries or int(row["n"]) != n_subjects \
            or got["pooled_cindex"] != want_c \
            or not all(np.isfinite(v) for v in got.values()) \
            or not got["cindex_lo"] <= got["pooled_cindex"] \
            <= got["cindex_hi"]:
        raise AssertionError(f"[report] summary {len(summary)} rows for "
                             f"{n_summaries}; {name}: {row}, c-index of "
                             f"the pkls {want_c}")
    prefixes = {y.split("__")[-1].split("_")[0] for y in emitted}
    if emitted != want_yamls or not {"PATH", "RADIO", "OMICS"} <= {
            p.upper() for p in prefixes} or not all(
            f"heatmap_config_{name}_val_{k}.yaml" in emitted
            for k in range(k_folds)):
        raise AssertionError(f"[report] emitted {sorted(emitted)}, "
                             f"expected {sorted(want_yamls)}")

    # 3. the best fold of each experiment
    yamls_best = os.path.join(td, "yamls_best")
    text = run("summarize_best_fold", summarize.main, common + [
        "--save_dir", os.path.join(td, "summary_best"),
        "--emit_heatmap_yamls", yamls_best, "--heatmap_template",
        templates["omic"]], 0, 0, quiet=True)
    best = set(os.listdir(yamls_best)) - {"heatmap_results"}
    want_best = _expected_yamls(root, all_folds=False)
    n_exps = len({y.rsplit("_val_", 1)[0] for y in want_yamls})
    log(f"[report] cli.summarize best fold: "
        f"{wall['summarize_best_fold']:.2f} s, launches "
        f"{launches['summarize_best_fold']}; {len(best)} YAMLs for "
        f"{n_exps} PATH, RADIO and OMICS experiments, none for MMF")
    if best != want_best or len(best) != n_exps or any(
            "__MMF" in y for y in best):
        raise AssertionError(f"[report] best-fold YAMLs {sorted(best)}, "
                             f"expected {sorted(want_best)}")

    # 4. stage 5 from the emitted configs, unmodified
    radio_cfg = os.path.join(yamls, f"heatmap_config_{name}_val_0.yaml")
    omic_cfg = os.path.join(yamls_best, sorted(
        y for y in best if "__OMICS" in y)[0])
    for stage, cfg_path, out in (("heatmaps_radio", radio_cfg, "scores.csv"),
                                 ("heatmaps_omic", omic_cfg,
                                  "omic_attr_global.csv")):
        run(stage, create_heatmaps.main, ["--config", cfg_path], 0, 0,
            quiet=True)
        save_dir = yaml_subset.load_file(cfg_path)["exp_arguments"][
            "save_dir"]
        rows = _csv_rows(os.path.join(save_dir, out))
        log(f"[report] cli.create_heatmaps {os.path.basename(cfg_path)}: "
            f"{wall[stage]:.2f} s, launches {launches[stage]}; {out} "
            f"{len(rows)} rows")
        if not rows:
            raise AssertionError(f"[report] {stage}: {out} is empty")
    log(f"[report] wall s: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in wall.items())
        + f"; card {_card()}")
    return launches

# [wsi]: four slides of 8192 x 6144 and one of 24576 x 18432, 3 levels each
WSI_SLIDES = [(8192, 6144)] * 4 + [(24576, 18432)]
WSI_MAX_BYTES = 4 << 30  # the large slide decodes to about 1.8 GB


def _stage_line(text, prefix):
    """The CLI's one-line summary ``{prefix} ...`` as {name: seconds}."""
    line = [x for x in text.splitlines() if x.startswith(prefix)][-1]
    out = {}
    for part in line.split(";", 1)[1].replace("(read: the prefetch "
                                              "thread)", "").split(","):
        words = part.split()
        if len(words) == 2:
            out[words[0]] = float(words[1])
    return line, out


# [wsi] slides 0..3 again as 256 x 256 tiled pyramids, one codec each
WSI_CODECS = ("jpeg", "jpeg_tables", "deflate", "lzw")
WSI_TILE = 256
# TIFF LZW as libtiff writes it (Clear first and when the table fills,
# the code width growing one code early, EOI last): the writer of
# [wsi]'s LZW slide, built by native.build beside the slides
LZW_ENCODER_SRC = r"""
#include <cstdint>
#include <vector>
extern "C" int64_t mmf_lzw_encode(const uint8_t* src, int64_t n,
                                  uint8_t* dst, int64_t cap) {
    std::vector<uint16_t> child(4096 * 256, 0);
    std::vector<int32_t> used;
    uint64_t acc = 0;
    int bits = 0, width = 9, next = 258;
    int64_t out = 0;
    auto put = [&](int code) {
        acc = (acc << width) | (uint64_t)code;
        bits += width;
        while (bits >= 8) {
            if (out >= cap) return false;
            dst[out++] = (uint8_t)(acc >> (bits - 8));
            bits -= 8;
        }
        return true;
    };
    auto grow = [&]() {  // after an entry: clear when full, else widen
        if (next == 4094) {
            if (!put(256)) return false;
            for (int k : used) child[k] = 0;
            used.clear();
            next = 258;
            width = 9;
        } else if (next > (1 << width) - 1) {
            ++width;
        }
        return true;
    };
    if (!put(256)) return -1;
    if (n > 0) {
        int w = src[0];
        for (int64_t i = 1; i < n; ++i) {
            int k = w * 256 + src[i];
            if (child[k]) {
                w = child[k];
                continue;
            }
            if (!put(w)) return -1;
            child[k] = (uint16_t)next;
            used.push_back(k);
            ++next;
            if (!grow()) return -1;
            w = src[i];
        }
        if (!put(w)) return -1;
        ++next;
        if (!grow()) return -1;
    }
    if (!put(257)) return -1;
    if (bits) {
        if (out >= cap) return -1;
        dst[out++] = (uint8_t)(acc << (8 - bits));
    }
    return out;
}
"""


def _lzw_encoder(build_dir):
    """A function bytes -> TIFF LZW bytes (``LZW_ENCODER_SRC``, built by
    g++ into ``build_dir``)."""
    import ctypes

    from multimodalfusion_tpu_torch import native
    src = os.path.join(build_dir, "lzw_encode.cpp")
    with open(src, "w") as f:
        f.write(LZW_ENCODER_SRC)
    lib = ctypes.CDLL(native.build(src, build_dir))
    lib.mmf_lzw_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64]
    lib.mmf_lzw_encode.restype = ctypes.c_int64

    def encode(raw: bytes) -> bytes:
        buf = np.frombuffer(raw, np.uint8)
        out = np.empty(2 * len(raw) + 64, np.uint8)
        n = lib.mmf_lzw_encode(buf.ctypes.data, len(raw), out.ctypes.data,
                               out.size)
        if n < 0:
            raise RuntimeError("LZW encoder ran out of room")
        return out[:n].tobytes()
    return encode


def _write_tiled_tiff(path, levels, codec, pool, lzw=None):
    """``levels`` (uint8 RGB) as the 256 x 256 tiled pages of a little-
    endian TIFF: ``codec`` jpeg (YCbCr 4:2:0 at quality 95, the tiles of
    ``utils/jpeg.encode_jpeg``, photometric 6), jpeg_tables (the same,
    its tables moved into JPEGTables), deflate (zlib level 6) or lzw
    (Predictor 2, ``_lzw_encoder``'s ``lzw``); tiles encoded on
    ``pool``."""
    import zlib

    from multimodalfusion_tpu_torch.utils import jpeg
    svs = _tool("svs_writer")
    T = WSI_TILE

    def encode(t):
        if codec.startswith("jpeg"):
            return jpeg.encode_jpeg(t)
        if codec == "deflate":
            return zlib.compress(t.tobytes(), 6)
        d = t.astype(np.int16)
        d[:, 1:] -= t[:, :-1]
        return lzw((d & 255).astype(np.uint8).tobytes())

    compression = {"deflate": 8, "lzw": 5}.get(codec, 7)
    with open(path, "wb") as f:
        f.write(b"II*\0\0\0\0\0")
        link = 4
        for lvl in levels:
            h, w = lvl.shape[:2]
            full = np.pad(lvl, ((0, -h % T), (0, -w % T), (0, 0)),
                          mode="edge")
            chunks = list(pool.map(encode, (
                np.ascontiguousarray(full[y:y + T, x:x + T])
                for y in range(0, h, T) for x in range(0, w, T))))
            tables = None
            if codec == "jpeg_tables":
                split = [svs.split_tables(c) for c in chunks]
                tables = split[0][0]
                if any(t != tables for t, _ in split):
                    raise AssertionError("[wsi] tiles of other tables")
                chunks = [c for _, c in split]
            offsets = []
            for c in chunks:
                offsets.append(f.tell())
                f.write(c)
            entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
                       (259, 3, [compression]),
                       (262, 3, [6 if compression == 7 else 2]),
                       (277, 3, [3]), (284, 3, [1]), (322, 4, [T]),
                       (323, 4, [T]), (324, 4, offsets),
                       (325, 4, [len(c) for c in chunks])]
            if codec == "lzw":
                entries.append((317, 3, [2]))
            if tables:
                entries.append((347, 7, list(tables)))
            if compression == 7:
                entries.append((530, 3, [2, 2]))
            link = svs.write_ifd(f, entries, link)


def _write_planar_tiff(path, rgba, lzw, pool):
    """``rgba`` (uint8 [H, W, 4]) as one 256 x 256 tiled page of a
    little-endian TIFF in PlanarConfiguration 2 (every tile of R, then of
    G, B and A), LZW without a predictor (``_lzw_encoder``'s ``lzw``),
    ExtraSamples 2 (unassociated alpha); tiles encoded on ``pool``."""
    T = WSI_TILE
    svs = _tool("svs_writer")
    h, w = rgba.shape[:2]
    full = np.pad(rgba, ((0, -h % T), (0, -w % T), (0, 0)), mode="edge")
    chunks = list(pool.map(lambda t: lzw(t.tobytes()), (
        np.ascontiguousarray(full[y:y + T, x:x + T, s]) for s in range(4)
        for y in range(0, h, T) for x in range(0, w, T))))
    with open(path, "wb") as f:
        f.write(b"II*\0\0\0\0\0")
        offsets = []
        for c in chunks:
            offsets.append(f.tell())
            f.write(c)
        svs.write_ifd(f, [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 4),
                       (259, 3, [5]), (262, 3, [2]), (277, 3, [4]),
                       (284, 3, [2]), (322, 4, [T]), (323, 4, [T]),
                       (324, 4, offsets), (325, 4, [len(c) for c in chunks]),
                       (338, 3, [2])], 4)


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2
                                                             / mse))


def _slide_seconds(text):
    """{slide file: seconds} of a create_patches run's per-slide lines."""
    out = {}
    for line in text.splitlines():
        head, _, rest = line.partition(": ")
        if rest.endswith("s") and " patches in " in rest:
            out[head] = float(rest.rsplit(" ", 1)[1][:-1])
    return out


def phase_wsi_compressed(launch_counters, path_exp, td, src_c, src_u,
                         twins, sources, out0, steps0, seconds0, wall,
                         launches):
    """[wsi]'s compressed slides (the keys of ``twins``: slides 0..3 of
    [wsi] as 256 x 256 tiled pyramids in ``src_c``, one codec each of
    ``WSI_CODECS``; their uncompressed twins in ``src_u``, patched into
    ``out0``; their source levels in ``sources``):
      - each slide read through ``PILSlide`` (C++ decoders, all host
        threads): the Deflate and LZW slides equal their source pixels;
        each level of a JPEG slide, on its top-left 1024 x 768, within
        1 dB of the PSNR of the encoder's round trip of that crop
        (``encode_jpeg`` then the decoder);
      - the smallest page of each slide decoded again through the plain
        versions (``read_page(plain=True)``): bit for bit the C++ pages;
      - the decode time per megapixel of each route, C++ (level 0, all
        threads) and plain (the smallest page), beside the uncompressed
        twin's read; the threads;
      - cli.create_patches on them (no launch): the Deflate and LZW
        slides give the coordinates of their uncompressed twins; the
        per-slide seconds against the twins' (``seconds0``);
      - cli.extract_features_fp (no launch), then cli.infer with
        [train]'s PathAMIL, the counters reset just before: one forward
        launch per batch of 8, risks equal to the plain pooling's at
        rel 1e-4.
    Adds its launch counts to ``launches`` and wall seconds to ``wall``;
    returns (the coordinates' folder, the features' folder, {subject P +
    stem: risk}).
    """
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import jpeg, tiff
    none = {c.__name__: 0 for c in launch_counters}
    stems_c = list(twins)
    threads = os.cpu_count()
    rates, plain_rates = {}, {}
    for stem, codec in zip(stems_c, WSI_CODECS):
        path = os.path.join(src_c, f"{stem}.tiff")
        src = sources[stem]
        t0 = time.perf_counter()
        levels = wsi.PILSlide(path).levels
        dt = time.perf_counter() - t0
        mp = sum(l.shape[0] * l.shape[1] for l in levels) / 1e6
        rates[codec] = dt * 1e3 / mp
        if codec in ("deflate", "lzw"):
            same = all(np.array_equal(a, b) for a, b in zip(levels, src))
            if not same:
                raise AssertionError(f"[wsi] {stem}: the {codec} slide does "
                                     f"not decode to its source pixels")
            detail = "equal to the source pixels"
        else:
            # each level's top-left 1024 x 768 (whole tiles): the slide's
            # pixels against one JPEG of the crop, encoded and decoded
            got, rt = [], []
            for a, b in zip(levels, src):
                crop = np.ascontiguousarray(b[:768, :1024])
                got.append(_psnr(a[:768, :1024], crop))
                rt.append(_psnr(jpeg.decode_jpeg(jpeg.encode_jpeg(crop)),
                                crop))
            if any(abs(g - r) > 1.0 for g, r in zip(got, rt)):
                raise AssertionError(f"[wsi] {stem}: PSNR {got} dB, the "
                                     f"encoder's round trip {rt} dB")
            detail = (f"PSNR of each level's top-left 1024 x 768 "
                      f"{[round(x, 3) for x in got]} dB, the encoder's "
                      f"round trip of it {[round(x, 3) for x in rt]} dB")
        pages = tiff.read_pages(path)
        small = pages[-1]
        t0 = time.perf_counter()
        plain = tiff.read_page(path, small, plain=True)
        plain_rates[codec] = ((time.perf_counter() - t0) * 1e3
                              / (small.width * small.height / 1e6))
        native_page = tiff.read_page(path, small)
        if not np.array_equal(plain, native_page):
            raise AssertionError(f"[wsi] {stem}: the C++ and plain "
                                 f"decoders differ on its smallest page")
        log(f"[wsi] {stem} ({codec}, {len(pages)} tiled pages, "
            f"{os.path.getsize(path) / 2**20:.1f} MiB): read in {dt:.3f} s "
            f"({rates[codec]:.3f} ms/MP, {threads} host threads); {detail}; "
            f"page {small.width} x {small.height}: C++ = plain bit for bit")
    t0 = time.perf_counter()
    mp = 0.0
    for stem in stems_c:
        mp += sum(l.shape[0] * l.shape[1] for l in wsi.PILSlide(os.path.join(
            src_u, f"{twins[stem]}.tiff")).levels) / 1e6
    rates["uncompressed"] = (time.perf_counter() - t0) * 1e3 / mp
    log(f"[wsi] decode ms per megapixel on the host ({_card()}): C++ "
        + ", ".join(f"{k} {v:.3f}" for k, v in rates.items())
        + f" (every level, {threads} threads; uncompressed: the twins, "
        f"read as before); plain "
        + ", ".join(f"{k} {v:.3f}" for k, v in plain_rates.items())
        + " (the smallest page, one thread)")

    # stage 0 on the compressed slides
    out_c = os.path.join(td, "patched_compressed")
    text = _run_stage(launch_counters, "wsi", "stage0_compressed",
                      create_patches.main, [
                          "--source", src_c, "--save_dir", out_c,
                          "--patch_size", "256", "--step_size", "256",
                          "--stitch", "--a_t", "0.5", "--a_h", "0.05",
                          "--device", "cuda"], wall, launches, none,
                      capture=True)
    line, steps = _stage_line(text, "stage 0 wall s")
    if "FAILED" in text:
        raise AssertionError(f"[wsi] stage 0 (compressed): FAILED\n{text}")
    for stem, codec in zip(stems_c, WSI_CODECS):
        if codec not in ("deflate", "lzw"):
            continue
        twin = twins[stem]
        with hdf5.File(os.path.join(out_c, "patches",
                                    f"{stem}_patches.h5")) as f:
            got = f["coords"]
        with hdf5.File(os.path.join(out0, "patches",
                                    f"{twin}_patches.h5")) as f:
            want = f["coords"]
        if not np.array_equal(got, want) or len(got) < 1:
            raise AssertionError(f"[wsi] {stem}: stage 0's coordinates "
                                 f"differ from its uncompressed twin's")
    secs = _slide_seconds(text)
    pairs = {stem: (secs[f"{stem}.tiff"],
                    seconds0[f"{twins[stem]}.tiff"])
             for stem in stems_c}
    log(f"[wsi] cli.create_patches on the compressed slides: "
        f"{wall['stage0_compressed']:.2f} s, launches "
        f"{launches['stage0_compressed']}; Deflate and LZW coordinates "
        f"equal to their uncompressed twins'; seconds per slide "
        f"(compressed, uncompressed twin) {pairs}; {line}; uncompressed "
        f"run's steps {json.dumps(steps0)}")

    # stage 1 and serving
    feat = os.path.join(td, "features_compressed")
    text = _run_stage(launch_counters, "wsi", "stage1_compressed",
                      extract_features_fp.main, [
                          "--data_h5_dir", out_c, "--data_slide_dir", src_c,
                          "--feat_dir", feat, "--slide_ext", ".tiff",
                          "--target_patch_size", "224", "--batch_size",
                          "128", "--allow_random_weights", "--device",
                          "cuda"], wall, launches, none, capture=True)
    line1, _ = _stage_line(text, "stage 1 wall s")
    for stem in stems_c:
        with hdf5.File(os.path.join(out_c, "patches",
                                    f"{stem}_patches.h5")) as f:
            coords = f["coords"]
        bag = load_pt(os.path.join(feat, "path_pt_files", f"{stem}.pt"))
        if bag.shape != (len(coords), 1024) or not np.isfinite(bag).all():
            raise AssertionError(f"[wsi] {stem}: bag {bag.shape} for "
                                 f"{len(coords)} coordinates")
    log(f"[wsi] cli.extract_features_fp on the compressed slides: "
        f"{wall['stage1_compressed']:.2f} s, launches "
        f"{launches['stage1_compressed']}; {line1}")
    cohort = os.path.join(td, "wsi_compressed_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"P{s},{s}.tiff\n" for s in stems_c))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_compressed", "on the compressed "
        "slides' bags", path_exp, cohort, feat, td,
        dict(none, _fused_pool_cuda=-(-len(stems_c) // 8)), wall, launches)
    return out_c, feat, served


J2K_FIXTURES = os.path.join(REPO, "multimodalfusion_tpu_torch", "testdata",
                            "j2k")


def phase_j2k(launch_counters):
    """[j2k] The committed JPEG 2000 fixtures (``J2K_FIXTURES``, made here
    by PIL's openjpeg and the port's encoder, tools/make_j2k_fixtures.py:
    9/7 in two layers, RPCL with precincts, tiles with an image offset, RGB
    with the ICT, 16-bit RLCP, signed 12-bit, every code-block style bit,
    PPT in tile-parts with POC): each decoded by the C++ version (every
    host thread) and by the plain one; both must give pixels whose SHA-256
    is the manifest's, PIL's.  No kernel launch (counters reset just
    before, read just after)."""
    import hashlib

    from multimodalfusion_tpu_torch.utils import j2k
    with open(os.path.join(J2K_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for c in launch_counters:
        c.launches = 0
    rows = []
    for entry in manifest["files"]:
        with open(os.path.join(J2K_FIXTURES, entry["name"]), "rb") as f:
            data = f.read()
        for plain in (False, True):
            px = j2k.decode(data, plain=plain)
            digest = hashlib.sha256(np.ascontiguousarray(px).tobytes())
            if (digest.hexdigest() != entry["sha256"]
                    or list(px.shape) != entry["shape"]
                    or str(px.dtype) != entry["dtype"]):
                raise AssertionError(
                    f"[j2k] {entry['name']} ({'plain' if plain else 'C++'})"
                    f": {px.dtype} {px.shape} does not match the manifest")
        rows.append(f"{entry['name']} {entry['dtype']} {entry['shape']}")
    counts = {c.__name__: c.launches for c in launch_counters}
    log(f"[j2k] {len(rows)} fixtures (Pillow {manifest['pillow']}, openjpeg "
        f"{manifest['openjpeg']}) decode by C++ and plain to the manifest's "
        f"digests: {'; '.join(rows)}; launches {counts}")
    if any(counts.values()):
        raise AssertionError("[j2k] a kernel launched")


JPEG_FIXTURES = os.path.join(REPO, "multimodalfusion_tpu_torch", "testdata",
                             "jpeg")


def _jpeg_writer():
    """tools/jpeg_writer.py, the test-stream writer (loaded by path; the
    package never imports it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jpeg_writer", os.path.join(REPO, "tools", "jpeg_writer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_jpeg(launch_counters):
    """[jpeg] The committed JPEG fixtures (``JPEG_FIXTURES``, made by PIL's
    libjpeg-turbo, tools/jpeg_writer.py and tools/jpeg_arith.py,
    tools/make_jpeg_fixtures.py: progressive at 4:4:4, 4:2:2, 4:2:0 and
    gray, successive approximation from Al = 3, EOB runs with restarts in
    every scan type, three scripts that stop early and are smoothed, CMYK
    with and without an Adobe marker and YCCK, baseline and progressive;
    arithmetic-coded SOF9 and SOF10 with restarts, non-default DAC
    conditioning, SA from Al = 3, an early stop and YCCK; lossless SOF3
    in gray, RGB with restarts and 4:2:0): each decoded by the C++
    version (every host thread) and by the plain one; both must give
    pixels whose SHA-256 is the manifest's, PIL's.  No kernel launch
    (counters reset just before, read just after)."""
    import hashlib

    from multimodalfusion_tpu_torch.utils import jpeg
    with open(os.path.join(JPEG_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for c in launch_counters:
        c.launches = 0
    rows = []
    for entry in manifest["files"]:
        with open(os.path.join(JPEG_FIXTURES, entry["name"]), "rb") as f:
            data = f.read()
        frame = jpeg.parse_jpeg(data)
        for plain in (False, True):
            px = jpeg.decode_jpeg(data, plain=plain)
            digest = hashlib.sha256(np.ascontiguousarray(px).tobytes())
            if (digest.hexdigest() != entry["sha256"]
                    or list(px.shape) != entry["shape"]):
                raise AssertionError(
                    f"[jpeg] {entry['name']} ({'plain' if plain else 'C++'})"
                    f": {px.shape} does not match the manifest")
        sof = {(jpeg.HUFFMAN, False): "SOF0/1", (jpeg.HUFFMAN, True): "SOF2",
               (jpeg.ARITHMETIC, False): "SOF9",
               (jpeg.ARITHMETIC, True): "SOF10",
               (jpeg.LOSSLESS, False): "SOF3"}[frame.coding,
                                               frame.progressive]
        rows.append(f"{entry['name']} {entry['shape']} {sof} "
                    f"{len(frame.scans)} scans")
    counts = {c.__name__: c.launches for c in launch_counters}
    log(f"[jpeg] {len(rows)} fixtures (Pillow {manifest['pillow']}, "
        f"libjpeg-turbo {manifest['libjpeg_turbo']}) decode by C++ and "
        f"plain to the manifest's digests: {'; '.join(rows)}; launches "
        f"{counts}")
    if any(counts.values()):
        raise AssertionError("[jpeg] a kernel launched")


def phase_wsi_progressive(launch_counters, path_exp, td, level0, stem, wall,
                          launches):
    """[wsi]'s progressive JPEG slide: ``level0`` (level 0 of [wsi]'s
    slide ``stem``, 8192 x 6144 RGB) encoded by ``jpeg.encode_jpeg``
    (baseline, YCbCr 4:2:0, quality 95) and, from the same quantised
    coefficients (``jpeg_writer.encode_jpeg_coefficients``), written by
    tools/jpeg_writer.py in libjpeg's default progressive script (10
    scans: DC at Al 1, luma AC 1-5 and 6-63 at Al 2, chroma AC at Al 1,
    then the refinements), the two written at once, the scans one a
    thread:
      - the progressive .jpg read through ``PILSlide`` (C++, all host
        threads) equals the baseline .jpg's read bit for bit; the decode
        ms per megapixel of each;
      - a 1024 x 768 crop (the top-left 64 x 48 MCUs' coefficients in the
        same script) decoded by the plain version equals the C++ version;
      - cli.create_patches and cli.extract_features_fp on the two slides
        in one directory (no launch): the same coordinates and the same
        features (bit for bit expected, the pixels being equal; else
        rtol 2e-3 / atol 2e-4, the ResNet tolerance);
      - cli.infer of [train]'s PathAMIL on the two bags (the counters
        reset just before): one forward launch, the risks equal when the
        features are (else at rel 1e-4) and equal to the plain pooling's
        at rel 1e-4.
    Adds its launch counts to ``launches`` and wall seconds to ``wall``."""
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import jpeg
    writer = _jpeg_writer()
    none = {c.__name__: 0 for c in launch_counters}
    h, w = level0.shape[:2]
    mp = h * w / 1e6
    threads = os.cpu_count()
    names = {k: f"WSIP_{k}_{w}x{h}" for k in ("baseline", "progressive")}
    src = os.path.join(td, "slides_progressive")
    os.makedirs(src)
    paths = {k: os.path.join(src, f"{n}.jpg") for k, n in names.items()}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[key] = time.perf_counter() - t0
        return out

    def progressive():
        co = timed("jpg_coefficients", writer.encode_jpeg_coefficients,
                   level0)
        return co, timed("jpg_progressive", lambda: writer.encode(
            co, threads=threads))

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        base_f = pool.submit(timed, "jpg_baseline", jpeg.encode_jpeg, level0)
        prog_f = pool.submit(progressive)
        data = {"baseline": base_f.result()}
        co, data["progressive"] = prog_f.result()
    wall["write_jpg"] = time.perf_counter() - t0
    for k, p in paths.items():
        with open(p, "wb") as f:
            f.write(data[k])
    frame = jpeg.parse_jpeg(data["progressive"])
    got, dt = {}, {}
    for k in ("baseline", "progressive"):
        t0 = time.perf_counter()
        got[k] = wsi.PILSlide(paths[k]).levels
        dt[k] = time.perf_counter() - t0
    if not frame.progressive or len(frame.scans) != 10 or len(
            got["progressive"]) != 1 or not np.array_equal(
                got["progressive"][0], got["baseline"][0]):
        raise AssertionError(f"[wsi] {names['progressive']}.jpg does not "
                             f"decode to its baseline source's pixels")
    crop = writer.Coefficients(1024, 768, co.sampling, co.qt, (
        co.blocks[0][:96, :128], co.blocks[1][:48, :64],
        co.blocks[2][:48, :64]))
    crop_data = writer.encode(crop)
    t0 = time.perf_counter()
    crop_plain = jpeg.decode_jpeg(crop_data, plain=True)
    dt_plain = time.perf_counter() - t0
    if not np.array_equal(crop_plain, jpeg.decode_jpeg(crop_data)):
        raise AssertionError("[wsi] the progressive crop: plain and C++ "
                             "differ")
    log(f"[wsi] {names['progressive']}.jpg (libjpeg's progressive script, "
        f"10 scans, per-scan optimal Huffman tables; "
        f"{len(data['progressive']) / 2**20:.2f} MiB against the baseline "
        f"source's {len(data['baseline']) / 2**20:.2f} MiB) written in "
        f"{wall['write_jpg']:.3f} s (baseline encode_jpeg "
        f"{wall['jpg_baseline']:.3f} s, beside it the coefficients "
        f"{wall['jpg_coefficients']:.3f} s and the 10 scans "
        f"{wall['jpg_progressive']:.3f} s in {threads} threads); PILSlide "
        f"read {dt['progressive']:.3f} s = "
        f"{dt['progressive'] * 1e3 / mp:.3f} ms/MP, the baseline source "
        f"{dt['baseline']:.3f} s = {dt['baseline'] * 1e3 / mp:.3f} ms/MP "
        f"(C++, {threads} host threads, {_card()}), equal bit for bit; a "
        f"1024 x 768 crop in the same script: plain {dt_plain:.3f} s, equal "
        f"to C++")
    del got

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "wsi", stage, fn, argv, wall,
                          launches, none, capture=True)
        if "FAILED" in text:
            raise AssertionError(f"[wsi] {stage}: FAILED\n{text}")

    out = os.path.join(td, "patched_progressive")
    feat = os.path.join(td, "features_progressive")
    run("stage0_jpg", create_patches.main, [
        "--source", src, "--save_dir", out, "--patch_size", "256",
        "--step_size", "256", "--a_t", "0.5", "--a_h", "0.05",
        "--device", "cuda"])
    run("stage1_jpg", extract_features_fp.main, [
        "--data_h5_dir", out, "--data_slide_dir", src, "--feat_dir", feat,
        "--slide_ext", ".jpg", "--target_patch_size", "224",
        "--batch_size", "128", "--allow_random_weights", "--device",
        "cuda"])
    coords, bags = {}, {}
    for k, n in names.items():
        with hdf5.File(os.path.join(out, "patches", f"{n}_patches.h5")) as f:
            coords[k] = f["coords"]
        bags[k] = load_pt(os.path.join(feat, "path_pt_files", f"{n}.pt"))
    bitwise = np.array_equal(bags["progressive"], bags["baseline"])
    diff = float(np.abs(bags["progressive"].astype(np.float64)
                        - bags["baseline"]).max())
    if not np.array_equal(coords["progressive"], coords["baseline"]) \
            or len(coords["baseline"]) < 1 or not np.allclose(
                bags["progressive"], bags["baseline"], rtol=2e-3,
                atol=2e-4):
        raise AssertionError(f"[wsi] {names['progressive']}: its patches "
                             f"or features differ from the baseline "
                             f"source's (max |d| {diff:.3e})")
    log(f"[wsi] the progressive .jpg and its baseline source: "
        f"cli.create_patches {wall['stage0_jpg']:.2f} s for both, "
        f"{len(coords['baseline'])} patches each, equal coordinates; "
        f"cli.extract_features_fp {wall['stage1_jpg']:.2f} s for both, "
        f"features bit for bit {bitwise}, max |d| {diff:.3e}; no launch in "
        f"either")
    cohort = os.path.join(td, "wsi_progressive_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"P_{k},{n}.jpg\n" for k, n in names.items()))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_jpg", "on the progressive .jpg "
        "slide's bag and its baseline source's", path_exp, cohort, feat, td,
        dict(none, _fused_pool_cuda=1), wall, launches)
    err = abs(served["P_progressive"] - served["P_baseline"]) / abs(
        served["P_baseline"])
    log(f"[wsi] the progressive .jpg slide's risk and its baseline "
        f"source's: {served}")
    if err > (0 if bitwise else 1e-4):
        raise AssertionError("[wsi] the progressive slide's risk differs "
                             "from its baseline source's")
    shutil.rmtree(src)


# [wsi]'s arithmetic-coded slides: the crop (rows, columns) of level 0,
# the SOF9 slide's restart interval (MCUs) and the side of the crop the
# plain decoder is timed on
WSI_ARITH_CROP = (1536, 2048)
WSI_ARITH_RESTART = 32
WSI_ARITH_PLAIN = 512


def _jpeg_arith():
    """tools/jpeg_arith.py, the arithmetic and lossless coder of test
    streams (loaded by path; the package never imports it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jpeg_arith", os.path.join(REPO, "tools", "jpeg_arith.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_wsi_arith(launch_counters, path_exp, td, level0, stem, wall,
                    launches):
    """[wsi]'s arithmetic-coded and planar slides: the central
    ``WSI_ARITH_CROP`` (2048 x 1536, where the tissue is) of ``level0``
    (level 0 of [wsi]'s slide ``stem``; cut so that the Python test coder
    codes it in seconds) written as
      - a baseline .jpg (``jpeg.encode_jpeg``, YCbCr 4:2:0, quality 95)
        and, from the same quantised coefficients
        (``jpeg_writer.encode_jpeg_coefficients``), a SOF9 .jpg with a
        restart interval of ``WSI_ARITH_RESTART`` MCUs and a SOF10 .jpg in
        libjpeg's default progressive script, each coded by
        tools/jpeg_arith.py in a subprocess of forked workers (its restart
        intervals and scans at once), and a Huffman progressive .jpg of
        the same script (tools/jpeg_writer.py);
      - an uncompressed chunky RGB .tiff (``tiff.write_tiff``) and a
        256 x 256 tiled planar (PlanarConfiguration 2) RGBA .tiff, LZW,
        with a seeded unassociated alpha plane (``_write_planar_tiff``);
    then: ``PILSlide`` (C++, every host thread) reads the SOF9 slide equal
    to the baseline bit for bit, the SOF10 slide equal to the Huffman
    progressive one and to the baseline, the planar slide equal to the
    chunky one and to the crop; the C++ decode ms per megapixel of each
    .jpg (best of 3); the plain decode of a ``WSI_ARITH_PLAIN`` square
    crop's coefficients in SOF9 and SOF10 equal to the C++ one and to
    the Huffman stream's pixels, its ms per megapixel; cli.create_patches
    and cli.extract_features_fp on the .jpg and the .tiff slides (no
    launch): every .jpg slide the baseline's coordinates and features,
    the planar slide the chunky one's (the lossy and the lossless slides
    segment apart); cli.infer of [train]'s PathAMIL on the six bags (the
    counters reset just before): one forward launch, every risk equal to
    its twin's when the features are (else at rel 1e-4).  Adds its
    launch counts to ``launches`` and wall seconds to ``wall``."""
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import jpeg, tiff
    coder = _jpeg_arith()
    writer = coder.writer
    none = {c.__name__: 0 for c in launch_counters}
    rows, cols = WSI_ARITH_CROP
    y0 = (level0.shape[0] - rows) // 32 * 16
    x0 = (level0.shape[1] - cols) // 32 * 16
    crop = np.ascontiguousarray(level0[y0:y0 + rows, x0:x0 + cols])
    mp = rows * cols / 1e6
    threads = os.cpu_count() or 1
    dirs = {".jpg": os.path.join(td, "slides_arith"),
            ".tiff": os.path.join(td, "slides_arith_tiff")}
    for d in dirs.values():
        os.makedirs(d)
    kinds = {"baseline": ".jpg", "sof9": ".jpg", "sof10": ".jpg",
             "progressive": ".jpg", "chunky": ".tiff", "planar_rgba": ".tiff"}
    names = {k: f"WSIA_{k}_{cols}x{rows}" for k in kinds}
    paths = {k: os.path.join(dirs[e], names[k] + e) for k, e in kinds.items()}
    npy = os.path.join(td, "arith_crop.npy")
    np.save(npy, crop)
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "jpeg_arith.py"), npy,
         paths[k], "--rgb", "--processes", str(max(1, threads // 2))]
        + (["--restart", str(WSI_ARITH_RESTART)] if k == "sof9"
           else ["--progressive"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in ("sof9", "sof10")}
    try:
        # meanwhile, in this process: the Huffman twins and the TIFFs
        co = writer.encode_jpeg_coefficients(crop)
        for k, data in (("baseline", jpeg.encode_jpeg(crop)),
                        ("progressive", writer.encode(co, threads=threads))):
            with open(paths[k], "wb") as f:
                f.write(data)
        tiff.write_tiff(paths["chunky"], [crop])
        alpha = np.random.default_rng(24).integers(0, 256, crop.shape[:2],
                                                   np.uint8)
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            _write_planar_tiff(paths["planar_rgba"], np.concatenate(
                [crop, alpha[..., None]], -1), _lzw_encoder(td), pool)
        wall["arith_twins"] = time.perf_counter() - t0
        for k, p in procs.items():
            out, _ = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"[wsi] tools/jpeg_arith.py for the "
                                     f"{k} slide failed:\n{out}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall["arith_write"] = time.perf_counter() - t0
    data = {k: open(paths[k], "rb").read() for k, e in kinds.items()
            if e == ".jpg"}
    f9, f10 = jpeg.parse_jpeg(data["sof9"]), jpeg.parse_jpeg(data["sof10"])
    if (f9.coding, f9.progressive, f9.scans[0].restart) != (
            jpeg.ARITHMETIC, False, WSI_ARITH_RESTART) or (
            f10.coding, f10.progressive, len(f10.scans)) != (
            jpeg.ARITHMETIC, True, 10):
        raise AssertionError("[wsi] the arithmetic slides are not SOF9 with "
                             "restarts and SOF10 in 10 scans")
    got = {k: wsi.PILSlide(p).levels for k, p in paths.items()}
    if any(len(v) != 1 for v in got.values()):
        raise AssertionError("[wsi] an arithmetic or planar slide of more "
                             "than one page")
    got = {k: v[0] for k, v in got.items()}
    for k, ref in (("sof9", "baseline"), ("sof10", "progressive"),
                   ("progressive", "baseline"), ("planar_rgba", "chunky")):
        if not np.array_equal(got[k], got[ref]):
            raise AssertionError(f"[wsi] {names[k]} does not decode to "
                                 f"{names[ref]}'s pixels")
    if not np.array_equal(got["chunky"], crop):
        raise AssertionError("[wsi] the chunky TIFF twin is not the crop")
    rate = {}
    for k, d in data.items():
        best = float("inf")
        for _ in range(3):
            t1 = time.perf_counter()
            jpeg.decode_jpeg(d)
            best = min(best, time.perf_counter() - t1)
        rate[k] = best * 1e3 / mp
    n = WSI_ARITH_PLAIN
    small = writer.Coefficients(n, n, co.sampling, co.qt, (
        co.blocks[0][:n // 8, :n // 8], co.blocks[1][:n // 16, :n // 16],
        co.blocks[2][:n // 16, :n // 16]))
    want = jpeg.decode_jpeg(writer.encode(small, progressive=False))
    plain = {}
    for k, kw in (("sof9", dict(progressive=False,
                                restart=WSI_ARITH_RESTART)),
                  ("sof10", {})):
        d = coder.encode(small, **kw)
        t1 = time.perf_counter()
        px = jpeg.decode_jpeg(d, plain=True)
        plain[k] = (time.perf_counter() - t1) * 1e3 / (n * n / 1e6)
        if not (np.array_equal(px, jpeg.decode_jpeg(d))
                and np.array_equal(px, want)):
            raise AssertionError(f"[wsi] the {n} x {n} {k} crop: plain, "
                                 f"C++ and the Huffman stream differ")
    del got
    log(f"[wsi] {cols} x {rows} crop of {stem} level 0 at ({x0}, {y0}): "
        f"SOF9 (restart {WSI_ARITH_RESTART} MCUs) "
        f"{len(data['sof9']) / 2**20:.3f} MiB and "
        f"SOF10 (libjpeg's default script, 10 scans) "
        f"{len(data['sof10']) / 2**20:.3f} MiB, coded in "
        f"{wall['arith_write']:.3f} s (two tools/jpeg_arith.py processes of "
        f"{max(1, threads // 2)} workers; the Huffman twins and the TIFFs "
        f"{wall['arith_twins']:.3f} s beside them), against the baseline's "
        f"{len(data['baseline']) / 2**20:.3f} MiB; PILSlide equal bit for "
        f"bit: SOF9 = baseline, SOF10 = Huffman progressive = baseline, "
        f"planar LZW RGBA = chunky = crop; C++ decode ms/MP ({threads} host "
        f"threads, {_card()}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in rate.items())
        + f"; plain decode ms/MP of a {n} x {n} crop: " + ", ".join(
            f"{k} {v:.1f}" for k, v in plain.items()) + " (equal to C++)")

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "wsi", stage, fn, argv, wall,
                          launches, none, capture=True)
        if "FAILED" in text:
            raise AssertionError(f"[wsi] {stage}: FAILED\n{text}")

    feat = os.path.join(td, "features_arith")
    outs = {}
    for ext, d in dirs.items():
        tag = ext[1:]
        outs[ext] = os.path.join(td, f"patched_arith_{tag}")
        run(f"stage0_arith_{tag}", create_patches.main, [
            "--source", d, "--save_dir", outs[ext], "--patch_size", "256",
            "--step_size", "256", "--a_t", "0.5", "--a_h", "0.05",
            "--device", "cuda"])
        run(f"stage1_arith_{tag}", extract_features_fp.main, [
            "--data_h5_dir", outs[ext], "--data_slide_dir", d, "--feat_dir",
            feat, "--slide_ext", ext, "--target_patch_size", "224",
            "--batch_size", "128", "--allow_random_weights", "--device",
            "cuda"])
    coords, bags = {}, {}
    for k, n_ in names.items():
        with hdf5.File(os.path.join(outs[kinds[k]], "patches",
                                    f"{n_}_patches.h5")) as f:
            coords[k] = f["coords"]
        bags[k] = load_pt(os.path.join(feat, "path_pt_files", f"{n_}.pt"))
    # each slide against its twin: the .jpg ones (lossy) against the
    # baseline, the planar TIFF against the chunky one (the crop itself)
    twin = {k: "baseline" if e == ".jpg" else "chunky"
            for k, e in kinds.items()}
    bitwise = all(np.array_equal(bags[k], bags[t]) for k, t in twin.items())
    diff = max(float(np.abs(bags[k].astype(np.float64) - bags[t]).max(
        initial=0.0)) for k, t in twin.items()
        if bags[k].shape == bags[t].shape)
    if min(len(coords[t]) for t in twin.values()) < 1 or any(
            not np.array_equal(coords[k], coords[t])
            or not np.allclose(bags[k], bags[t], rtol=2e-3, atol=2e-4)
            for k, t in twin.items()):
        raise AssertionError(f"[wsi] an arithmetic or planar slide's "
                             f"patches or features differ from its "
                             f"twin's (max |d| {diff:.3e})")
    log(f"[wsi] the six slides of the crop: cli.create_patches "
        f"{wall['stage0_arith_jpg']:.2f} s (.jpg) + "
        f"{wall['stage0_arith_tiff']:.2f} s (.tiff), "
        f"{len(coords['baseline'])} patches each .jpg, "
        f"{len(coords['chunky'])} each .tiff, coordinates equal to the "
        f"twin's; cli.extract_features_fp {wall['stage1_arith_jpg']:.2f} "
        f"s + {wall['stage1_arith_tiff']:.2f} s, features bit for bit "
        f"{bitwise}, max |d| {diff:.3e}; no launch")
    cohort = os.path.join(td, "wsi_arith_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"A_{k},{n_}{kinds[k]}\n" for k, n_ in names.items()))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_arith", "on the arithmetic, "
        "progressive, planar and baseline slides' bags", path_exp, cohort,
        feat, td, dict(none, _fused_pool_cuda=1), wall, launches)
    err = max(abs(served[f"A_{k}"] - served[f"A_{t}"])
              / abs(served[f"A_{t}"]) for k, t in twin.items())
    log(f"[wsi] the six slides' risks: {served}")
    if err > (0 if bitwise else 1e-4):
        raise AssertionError("[wsi] an arithmetic or planar slide's risk "
                             "differs from its twin's")
    for d in dirs.values():
        shutil.rmtree(d)
    os.remove(npy)


ZSTD_FIXTURES = os.path.join(REPO, "multimodalfusion_tpu_torch", "testdata",
                             "zstd")


def phase_zstd(launch_counters):
    """[zstd] The committed Zstandard fixtures (``ZSTD_FIXTURES``, written
    by libzstd through ``zstandard``, tools/make_zstd_fixtures.py:
    levels 1, 3, 9, 19 and 22, no content size, checksums, a match from
    more than a block back, long distance matching, skippable and
    concatenated frames, RLE and raw blocks, direct Huffman weights, one
    Huffman stream, RLE literals, treeless literals and repeated tables,
    RLE tables, a predictor-2 tile): each decoded by the C++ decoder
    (``native.zstd_decode``) and the plain one (``zstd.decompress``);
    both must give libzstd's output, by the manifest's size and SHA-256.
    No kernel launch (counters reset just before, read just after)."""
    import hashlib

    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.utils import zstd
    with open(os.path.join(ZSTD_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for c in launch_counters:
        c.launches = 0
    rows = []
    for entry in manifest["fixtures"]:
        with open(os.path.join(ZSTD_FIXTURES, entry["file"]), "rb") as f:
            data = f.read()
        for name, fn in (("C++", native.zstd_decode),
                         ("plain", zstd.decompress)):
            out = fn(data)
            if (len(out) != entry["size"] or hashlib.sha256(out).hexdigest()
                    != entry["sha256"]):
                raise AssertionError(f"[zstd] {entry['name']} ({name}): "
                                     f"{len(out)} bytes, not libzstd's")
        rows.append(f"{entry['name']} {len(data)} -> {entry['size']} B")
    counts = {c.__name__: c.launches for c in launch_counters}
    log(f"[zstd] {len(rows)} fixtures (zstandard {manifest['zstandard']}, "
        f"libzstd {manifest['libzstd']}) decode by C++ and plain to the "
        f"manifest's digests: {'; '.join(rows)}; launches {counts}")
    if any(counts.values()):
        raise AssertionError("[zstd] a kernel launched")


H5_FIXTURES = os.path.join(REPO, "multimodalfusion_tpu_torch", "testdata",
                           "h5")


def phase_h5(launch_counters, radio_exp, root=None):
    """[h5] The committed HDF5 fixtures (``H5_FIXTURES``, written by h5py
    outside its default format, tools/make_h5_fixtures.py: superblocks 2
    and 3, version-2 object headers, dense links and attributes, single
    chunk, implicit, fixed array (paged), extensible array (super
    blocks) and version-2 B-tree indexes, gzip, shuffle, lzf and
    fletcher32), each read by the port's reader with the C++ lzf decoder
    and with the plain one: both must give the manifest's shapes, dtypes,
    SHA-256s of h5py's arrays and attributes.  The lzf streams the reader
    met are decoded again by both decoders, equal, and timed (MB/s of
    output); each file's read is timed on the host clock (ms per MB of
    arrays).  Then cli.infer serves the fixtures' 2-subject glioma cohort
    with [radio]'s RadioAMIL (concat, 4 sequences, gated) on the card:
    one forward launch for its one batch and no backward (counters reset
    just before, read just after), risks within rel 1e-4 of the plain
    pooling on the card and equal bit for bit to those of the same
    cohort rewritten by the port's own writer (superblock 0, contiguous)
    and served in the same process.  Returns the launch counts by run."""
    import hashlib

    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.data import hdf5
    from multimodalfusion_tpu_torch.utils import lzf
    with open(os.path.join(H5_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    wall, launches = {}, {}
    # every lzf stream the reader decodes, recorded while the files are
    # checked against the manifest
    streams = []
    unfilter = hdf5.File._unfilter

    def recording(self, fid, raw, itemsize, csize):
        if fid == hdf5.LZF and not self.plain:
            streams.append((raw, csize))
        return unfilter(self, fid, raw, itemsize, csize)

    def same_attr(got, want):
        if want["dtype"] == "str":
            return got == want["value"]
        a = np.asarray(got)
        return a.dtype.str == want["dtype"] and a.tolist() == want["value"]

    for c in launch_counters:
        c.launches = 0
    rows = []
    for entry in manifest["files"]:
        path = os.path.join(H5_FIXTURES, entry["file"])
        nbytes = sum(int(np.prod(w["shape"])) * np.dtype(w["dtype"]).itemsize
                     for w in entry["datasets"].values())
        for plain in (False, True):
            hdf5.File._unfilter = recording
            try:
                with hdf5.File(path, plain=plain) as f:
                    for name, want in entry["datasets"].items():
                        arr, attrs = f[name], f.attrs(name)
                        ok = (list(arr.shape) == want["shape"]
                              and arr.dtype.str == want["dtype"]
                              and hashlib.sha256(arr.tobytes()).hexdigest()
                              == want["sha256"]
                              and sorted(attrs) == sorted(want["attrs"])
                              and all(same_attr(attrs[k], v) for k, v in
                                      want["attrs"].items()))
                        if not ok:
                            raise AssertionError(
                                f"[h5] {entry['file']} {name} "
                                f"({'plain' if plain else 'C++'} lzf): not "
                                f"the manifest's")
            finally:
                hdf5.File._unfilter = unfilter
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            with hdf5.File(path) as f:
                for name in entry["datasets"]:
                    f[name]
                    f.attrs(name)
            times.append(time.perf_counter() - t0)
        rows.append(f"{entry['file']} ({entry['covers']}): "
                    f"{min(times) * 1e3 / (nbytes / 1e6):.2f} ms/MB")
    counts = {c.__name__: c.launches for c in launch_counters}
    if any(counts.values()):
        raise AssertionError(f"[h5] reading the fixtures launched {counts}")
    out_bytes = sum(n for _, n in streams)
    rates, decoded = {}, {}
    for name, fn, reps in (("C++", native.lzf_decode, 5),
                           ("plain", lzf.decompress, 1)):
        t0 = time.perf_counter()
        for _ in range(reps):
            decoded[name] = [fn(raw, n) for raw, n in streams]
        rates[name] = out_bytes * reps / (time.perf_counter() - t0) / 1e6
    if decoded["C++"] != decoded["plain"]:
        raise AssertionError("[h5] the C++ and plain lzf decoders disagree")
    log(f"[h5] {len(manifest['files'])} fixtures (h5py "
        f"{manifest['h5py']}, HDF5 {manifest['hdf5']}) read by C++ and "
        f"plain lzf to the manifest; launches {counts}; {len(streams)} lzf "
        f"chunks ({out_bytes} B out) decode equal: C++ "
        f"{rates['C++']:.1f} MB/s, plain {rates['plain']:.2f} MB/s; host "
        f"read ({_card()}): " + "; ".join(rows))
    if len(streams) < 4:
        raise AssertionError(f"[h5] only {len(streams)} lzf chunks met")

    data = os.path.join(H5_FIXTURES, "cohort")
    csv_path = os.path.join(H5_FIXTURES, "cohort.csv")
    n = len(manifest["subjects"])
    want = {"_fused_pool_cuda": -(-n // 8), "_fused_pool_bwd_cuda": 0}
    with _workdir(root, "h5") as td:
        served, _ = _serve_and_check(
            launch_counters, "h5", "serve", "of [radio]'s RadioAMIL on the "
            "committed newer-format cohort", radio_exp, csv_path, data, td,
            want, wall, launches)
        # the twin: the same arrays through the port's own writer
        twin = os.path.join(td, "twin")
        for seq in manifest["sequences"]:
            os.makedirs(os.path.join(twin, "radio_h5_files", seq))
            for sid in manifest["subjects"]:
                rel = os.path.join("radio_h5_files", seq, f"{sid}.h5")
                with hdf5.File(os.path.join(data, rel)) as f:
                    arrays = {k: f[k] for k in ("features", "slice_index")}
                hdf5.write(os.path.join(twin, rel), arrays)
                with open(os.path.join(twin, rel), "rb") as f:
                    if f.read(9)[8] != 0:
                        raise AssertionError("[h5] the twin is not "
                                             "superblock 0")
        twin_served, _ = _serve_and_check(
            launch_counters, "h5", "serve_twin", "of the same cohort "
            "rewritten by the port's writer (superblock 0)", radio_exp,
            csv_path, twin, td, want, wall, launches)
        log(f"[h5] risks {served}; the superblock-0 twin's "
            f"{'equal bit for bit' if twin_served == served else 'DIFFER'}")
        if twin_served != served:
            raise AssertionError("[h5] the newer-format cohort serves other "
                                 "risks than its superblock-0 twin")
    log(f"[h5] wall s ({_card()}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items()))
    return launches


# the table modes every ZSTD slide of [wsi] must take between them
# (tools/zstd_writer.py's stats)
WSI_ZSTD_MODES = ("block_compressed", "block_raw", "huffman_4_streams",
                  "huffman_fse_weights", "literals_treeless",
                  "repeat_offsets")
WSI_ZSTD_TABLES = ("predefined", "rle", "fse", "repeat")


def phase_wsi_zstd(launch_counters, path_exp, td, level0, stem, wall,
                   launches):
    """[wsi]'s ZSTD slides: the central ``WSI_ARITH_CROP`` (2048 x 1536,
    where the tissue is) of ``level0`` (level 0 of [wsi]'s slide
    ``stem``; cut so that the Python test coder codes it in seconds)
    written by tools/zstd_writer.py (three subprocesses of forked
    workers, at once) as
      - a 256 x 256 tiled ZSTD page with Predictor 2, as vips writes it;
      - a ZSTD page in strips of 64 rows, predictor 1, checksummed
        frames in blocks of 8 KiB (so that every table mode comes up);
      - a 256 x 256 tiled planar ZSTD RGBA page (a seeded unassociated
        alpha plane);
    beside an uncompressed chunky twin (``tiff.write_tiff``).  Between
    them the frames take every sequence-table mode (predefined, RLE,
    FSE-coded, repeated), treeless literals, FSE-coded Huffman weights,
    repeat offsets and raw blocks (``WSI_ZSTD_MODES``).  Then:
    ``PILSlide`` (C++, every host thread) reads each equal to the crop
    bit for bit; the C++ decode ms per megapixel of each page (its
    chunks alone, and the whole ``read_page``; best of 3); the plain
    decode of a ``WSI_ARITH_PLAIN`` square written the same way equal to
    the C++ one and to the square, its ms per megapixel;
    cli.create_patches and cli.extract_features_fp on the four slides
    (no launch): each ZSTD slide the twin's coordinates and features bit
    for bit; cli.infer of [train]'s PathAMIL on the four bags (the
    counters reset just before): one forward launch, every risk equal to
    the twin's.  Adds its launch counts to ``launches`` and wall seconds
    to ``wall``."""
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import tiff
    none = {c.__name__: 0 for c in launch_counters}
    rows, cols = WSI_ARITH_CROP
    y0 = (level0.shape[0] - rows) // 32 * 16
    x0 = (level0.shape[1] - cols) // 32 * 16
    crop = np.ascontiguousarray(level0[y0:y0 + rows, x0:x0 + cols])
    mp = rows * cols / 1e6
    threads = os.cpu_count() or 1
    src = os.path.join(td, "slides_zstd")
    os.makedirs(src)
    kinds = {"tiled": ["--tile", "256", "--predictor", "2"],
             "strips": ["--rows", "64", "--checksum", "--block", "8192"],
             "planar_rgba": ["--tile", "256", "--planar", "--extra", "2"]}
    names = {k: f"WSIZ_{k}_{cols}x{rows}" for k in list(kinds) + ["twin"]}
    paths = {k: os.path.join(src, n + ".tiff") for k, n in names.items()}
    npy = os.path.join(td, "zstd_crop.npy")
    np.save(npy, crop)
    npy4 = os.path.join(td, "zstd_crop_rgba.npy")
    alpha = np.random.default_rng(25).integers(0, 256, crop.shape[:2],
                                               np.uint8)
    np.save(npy4, np.concatenate([crop, alpha[..., None]], -1))
    t0 = time.perf_counter()
    writer = os.path.join(REPO, "tools", "zstd_writer.py")
    procs = {k: subprocess.Popen(
        [sys.executable, writer, npy4 if k == "planar_rgba" else npy,
         paths[k], "--processes", str(max(1, threads // 3))] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, argv in kinds.items()}
    stats = {}
    try:
        tiff.write_tiff(paths["twin"], [crop])
        for k, p in procs.items():
            out, _ = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"[wsi] tools/zstd_writer.py for the "
                                     f"{k} slide failed:\n{out}")
            stats[k] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall["zstd_write"] = time.perf_counter() - t0
    total = {}
    for s in stats.values():
        for key, v in s.items():
            total[key] = total.get(key, 0) + v
    missing = [m for m in WSI_ZSTD_MODES if not total.get(m)] + [
        m for m in WSI_ZSTD_TABLES
        if not any(total.get(f"{t}_{m}") for t in ("ll", "of", "ml"))]
    if missing:
        raise AssertionError(f"[wsi] the ZSTD slides take no {missing}: "
                             f"{stats}")
    got = {k: wsi.PILSlide(p).levels for k, p in paths.items()}
    if any(len(v) != 1 or not np.array_equal(v[0], crop)
           for v in got.values()):
        raise AssertionError("[wsi] a ZSTD slide does not decode to the "
                             "crop")
    del got
    rate, chunk_rate, sizes = {}, {}, {}
    for k in kinds:
        page = tiff.read_pages(paths[k])[0]
        if page.compression != tiff.ZSTD:
            raise AssertionError(f"[wsi] {names[k]} is not ZSTD")
        places, shapes = tiff._layout(page)
        planes = page.samples if page.planar == 2 else 1
        chunks = tiff._chunk_bytes(paths[k], page, len(places) * planes)
        per = 1 if planes > 1 else page.samples
        outs = [np.empty(r * c * per, np.uint8) for _ in range(planes)
                for r, c in shapes]
        sizes[k] = sum(len(c) for c in chunks)
        best_c = best_p = float("inf")
        for _ in range(3):
            t1 = time.perf_counter()
            tiff.decode_chunks(tiff.ZSTD, chunks, outs)
            best_c = min(best_c, time.perf_counter() - t1)
            t1 = time.perf_counter()
            tiff.read_page(paths[k], page)
            best_p = min(best_p, time.perf_counter() - t1)
        chunk_rate[k] = best_c * 1e3 / mp
        rate[k] = best_p * 1e3 / mp
    n = WSI_ARITH_PLAIN
    square = os.path.join(td, "zstd_square.tiff")
    _tool("zstd_writer").write_tiff(square, np.ascontiguousarray(crop[:n, :n]),
                              tile=256, predictor=2, checksum=True)
    page = tiff.read_pages(square)[0]
    t1 = time.perf_counter()
    px = tiff.read_page(square, page, plain=True)
    plain = (time.perf_counter() - t1) * 1e3 / (n * n / 1e6)
    if not (np.array_equal(px, tiff.read_page(square, page))
            and np.array_equal(px, crop[:n, :n])):
        raise AssertionError(f"[wsi] the {n} x {n} ZSTD square: plain, C++ "
                             f"and the crop differ")
    os.remove(square)
    log(f"[wsi] {cols} x {rows} crop of {stem} level 0 at ({x0}, {y0}) as "
        f"ZSTD TIFFs by tools/zstd_writer.py in {wall['zstd_write']:.3f} s "
        f"(three processes of {max(1, threads // 3)} workers): " + ", ".join(
            f"{k} {sizes[k] / 2**20:.3f} MiB" for k in kinds)
        + f" (raw {crop.nbytes / 2**20:.3f} MiB); the frames' modes "
        + json.dumps(total) + "; PILSlide equal to the crop bit for bit; "
        f"C++ decode ms/MP ({threads} host threads, {_card()}): chunks "
        + ", ".join(f"{k} {v:.3f}" for k, v in chunk_rate.items())
        + "; read_page " + ", ".join(f"{k} {v:.3f}" for k, v in rate.items())
        + f"; plain read_page ms/MP of a {n} x {n} tiled predictor-2 "
        f"square: {plain:.1f} (equal to C++ and the crop)")

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "wsi", stage, fn, argv, wall,
                          launches, none, capture=True)
        if "FAILED" in text:
            raise AssertionError(f"[wsi] {stage}: FAILED\n{text}")

    patched = os.path.join(td, "patched_zstd")
    feat = os.path.join(td, "features_zstd")
    run("stage0_zstd", create_patches.main, [
        "--source", src, "--save_dir", patched, "--patch_size", "256",
        "--step_size", "256", "--a_t", "0.5", "--a_h", "0.05", "--device",
        "cuda"])
    run("stage1_zstd", extract_features_fp.main, [
        "--data_h5_dir", patched, "--data_slide_dir", src, "--feat_dir",
        feat, "--slide_ext", ".tiff", "--target_patch_size", "224",
        "--batch_size", "128", "--allow_random_weights", "--device",
        "cuda"])
    coords, bags = {}, {}
    for k, n_ in names.items():
        with hdf5.File(os.path.join(patched, "patches",
                                    f"{n_}_patches.h5")) as f:
            coords[k] = f["coords"]
        bags[k] = load_pt(os.path.join(feat, "path_pt_files", f"{n_}.pt"))
    if len(coords["twin"]) < 1 or any(
            not np.array_equal(coords[k], coords["twin"])
            or not np.array_equal(bags[k], bags["twin"]) for k in kinds):
        raise AssertionError("[wsi] a ZSTD slide's patches or features "
                             "differ from its uncompressed twin's")
    log(f"[wsi] the ZSTD slides and their twin: cli.create_patches "
        f"{wall['stage0_zstd']:.2f} s, {len(coords['twin'])} patches each, "
        f"coordinates equal to the twin's; cli.extract_features_fp "
        f"{wall['stage1_zstd']:.2f} s, features equal to the twin's bit "
        f"for bit; no launch")
    cohort = os.path.join(td, "wsi_zstd_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"Z_{k},{n_}.tiff\n" for k, n_ in names.items()))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_zstd", "on the ZSTD slides' bags and "
        "their twin's", path_exp, cohort, feat, td,
        dict(none, _fused_pool_cuda=1), wall, launches)
    log(f"[wsi] the ZSTD slides' risks: {served}")
    if any(served[f"Z_{k}"] != served["Z_twin"] for k in kinds):
        raise AssertionError("[wsi] a ZSTD slide's risk differs from its "
                             "twin's")
    shutil.rmtree(src)
    for p in (npy, npy4):
        os.remove(p)


def _tool(name):
    """tools/{name}.py, a coder of test files (loaded by path; the package
    never imports it): zstd_writer, the Zstandard coder of test streams;
    bigtiff, the BigTIFF re-packer; svs_writer, the Aperio slide writer
    (and the IFD and JPEGTables writers of [wsi]'s tiled pyramids)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_wsi_bigtiff(launch_counters, path_exp, td, src_c, stems_c, out_c,
                      feat_c, served_c, wall, launches):
    """[wsi]'s BigTIFF slides: the four 256 x 256 tiled pyramids of
    ``phase_wsi_compressed`` (``stems_c`` in ``src_c``, one codec each of
    ``WSI_CODECS``; their coordinates in ``out_c``, bags in ``feat_c``,
    risks ``served_c``) re-packed as little-endian BigTIFF by
    tools/bigtiff.py, every tile's bytes kept: the JPEG one as
    ``{stem}.btf``, its level-0 tiles past 4 GiB behind a hole (a sparse
    file: its size and allocated bytes printed), the others beside it;
    and the Deflate one again as a big-endian BigTIFF (``MM\\0+``).  Then:
      - ``PILSlide`` reads each of the four equal to its classic twin bit
        for bit; ``read_pages`` ms (best of 3) and the decode ms per
        megapixel of every level (C++, all host threads) of each beside
        its twin's;
      - the big-endian one is refused with ``BigEndianBigTIFFError`` (an
        ``OSError``) before any decode;
      - cli.create_patches and cli.extract_features_fp --slide_ext .btf
        on the .btf slide (no launch): the twin's coordinates and bag bit
        for bit;
      - cli.infer of [train]'s PathAMIL on its bag and the twin's, in one
        batch (the counters reset just before): exactly one forward
        launch and no backward, the two risks equal.
    Adds its launch counts to ``launches`` and wall seconds to ``wall``."""
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import tiff
    bigtiff = _tool("bigtiff")
    t_phase = time.perf_counter()
    none = {c.__name__: 0 for c in launch_counters}
    threads = os.cpu_count() or 1
    src = os.path.join(td, "slides_bigtiff")  # the served .btf alone
    others = os.path.join(td, "bigtiff_others")
    os.makedirs(src)
    os.makedirs(others)
    served_stem = stems_c[WSI_CODECS.index("jpeg")]
    paths = {}
    t0 = time.perf_counter()
    for stem, codec in zip(stems_c, WSI_CODECS):
        classic = os.path.join(src_c, f"{stem}.tiff")
        if stem == served_stem:
            paths[stem] = bigtiff.repack(classic, os.path.join(
                src, f"{stem}.btf"), gap=0)
        else:
            paths[stem] = bigtiff.repack(classic, os.path.join(
                others, f"{stem}.tif"))
    wall["bigtiff_write"] = time.perf_counter() - t0
    deflate = stems_c[WSI_CODECS.index("deflate")]
    be = bigtiff.repack(os.path.join(src_c, f"{deflate}.tiff"),
                        os.path.join(others, f"{deflate}_be.tif"), order=">")
    st = os.stat(paths[served_stem])
    level0 = tiff.read_pages(paths[served_stem])[0]
    first = min(o for o, _ in level0.chunks)
    if st.st_size <= 1 << 32 or first <= 1 << 32:
        raise AssertionError(f"[wsi] {served_stem}.btf: {st.st_size} bytes, "
                             f"level 0's first tile at {first}")
    log(f"[wsi] BigTIFF: the four tiled pyramids re-packed by "
        f"tools/bigtiff.py in {wall['bigtiff_write']:.3f} s; "
        f"{served_stem}.btf {st.st_size} bytes ({st.st_size / 2**30:.3f} "
        f"GiB), {st.st_blocks * 512} allocated, level 0's tiles from "
        f"offset {first}")

    rates, pages_ms = {}, {}
    for stem, codec in zip(stems_c, WSI_CODECS):
        classic = os.path.join(src_c, f"{stem}.tiff")
        best = float("inf")
        for _ in range(3):
            t1 = time.perf_counter()
            pages = tiff.read_pages(paths[stem])
            best = min(best, time.perf_counter() - t1)
        pages_ms[codec] = best * 1e3
        got = {}
        for who, path in (("big", paths[stem]), ("classic", classic)):
            t1 = time.perf_counter()
            got[who] = wsi.PILSlide(path).levels
            dt = time.perf_counter() - t1
            mp = sum(l.shape[0] * l.shape[1] for l in got[who]) / 1e6
            rates[f"{codec} {who}"] = dt * 1e3 / mp
        if len(got["big"]) != len(pages) or len(got["big"]) != len(
                got["classic"]) or not all(np.array_equal(a, b) for a, b in
                                           zip(got["big"], got["classic"])):
            raise AssertionError(f"[wsi] the BigTIFF {stem} differs from its "
                                 f"classic twin")
        del got
    try:
        wsi.PILSlide(be)
    except tiff.BigEndianBigTIFFError as e:
        refused = str(e)
    else:
        raise AssertionError(f"[wsi] {be} was read")
    log(f"[wsi] BigTIFF: PILSlide reads the four equal to their classic "
        f"twins bit for bit; read_pages ms (best of 3) " + ", ".join(
            f"{k} {v:.3f}" for k, v in pages_ms.items())
        + f"; decode ms/MP of every level ({threads} host threads, "
        f"{_card()}): " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in rates.items())
        + f"; the big-endian Deflate one refused: {refused}")

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "wsi", stage, fn, argv, wall,
                          launches, none, capture=True)
        if "FAILED" in text:
            raise AssertionError(f"[wsi] {stage}: FAILED\n{text}")

    patched = os.path.join(td, "patched_bigtiff")
    feat = os.path.join(td, "features_bigtiff")
    run("stage0_bigtiff", create_patches.main, [
        "--source", src, "--save_dir", patched, "--patch_size", "256",
        "--step_size", "256", "--a_t", "0.5", "--a_h", "0.05", "--device",
        "cuda"])
    run("stage1_bigtiff", extract_features_fp.main, [
        "--data_h5_dir", patched, "--data_slide_dir", src, "--feat_dir",
        feat, "--slide_ext", ".btf", "--target_patch_size", "224",
        "--batch_size", "128", "--allow_random_weights", "--device",
        "cuda"])
    coords, bags = {}, {}
    for who, folder, bag_dir in (("big", patched, feat),
                                 ("classic", out_c, feat_c)):
        with hdf5.File(os.path.join(folder, "patches",
                                    f"{served_stem}_patches.h5")) as f:
            coords[who] = f["coords"]
        bags[who] = load_pt(os.path.join(bag_dir, "path_pt_files",
                                         f"{served_stem}.pt"))
    if len(coords["big"]) < 1 or not np.array_equal(
            coords["big"], coords["classic"]) or not np.array_equal(
            bags["big"], bags["classic"]):
        raise AssertionError(f"[wsi] {served_stem}.btf: coordinates or "
                             f"features differ from the classic twin's")
    log(f"[wsi] BigTIFF {served_stem}.btf: cli.create_patches "
        f"{wall['stage0_bigtiff']:.2f} s, {len(coords['big'])} patches, the "
        f"twin's coordinates; cli.extract_features_fp --slide_ext .btf "
        f"{wall['stage1_bigtiff']:.2f} s, the twin's features bit for bit; "
        f"no launch")
    shutil.copy(os.path.join(feat_c, "path_pt_files", f"{served_stem}.pt"),
                os.path.join(feat, "path_pt_files",
                             f"{served_stem}_classic.pt"))
    cohort = os.path.join(td, "wsi_bigtiff_cohort.csv")
    with open(cohort, "w") as f:
        f.write(f"subject_id,slide_id\nB_btf,{served_stem}\n"
                f"B_classic,{served_stem}_classic\n")
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_bigtiff", "on the .btf slide's bag and "
        "its classic twin's", path_exp, cohort, feat, td,
        dict(none, _fused_pool_cuda=1), wall, launches)
    log(f"[wsi] BigTIFF risks: {served}; the classic twin's in a batch "
        f"of {len(served_c)} in [wsi]'s compressed run: "
        f"{served_c[f'P{served_stem}']}")
    if served["B_btf"] != served["B_classic"]:
        raise AssertionError("[wsi] the .btf slide's risk differs from its "
                             "classic twin's")
    shutil.rmtree(src)
    shutil.rmtree(others)
    wall["bigtiff"] = time.perf_counter() - t_phase
    log(f"[wsi] BigTIFF sub-phase: {wall['bigtiff']:.3f} s ({_card()})")


# [wsi]'s Aperio slide: level 0 (width, height), the downsamples of its
# other two levels, its pixels' seed, the level-0 tiles decoded again by
# the plain decoder
SVS_LEVEL0 = (16320, 12240)
SVS_DOWNSAMPLES = (4, 16)
SVS_SEED = 428
SVS_PLAIN_TILES = 64


def _svs_child(runs, result):
    """The child process of ``phase_wsi_svs`` (``python -c``, in the
    repo): a warm-up of the card's filters and embedder, then for each
    (name, slides dir, slide extension, patched dir, features dir,
    MMF_TPU_WSI_MAX_BYTES or None to unset it) of ``runs``
    cli.create_patches and cli.extract_features_fp
    (``--slide_ext`` only where it is not the default .svs) on the card,
    the launch counters reset just before each, no launch expected.
    Writes to ``result`` one JSON object: each stage's seconds, launches
    and stage-1 read and embed seconds, the tiles the Aperio slides it
    opened touched and decoded in each stage, their caches' peak and
    bound bytes, and the peak RSS (KiB) after the warm-up and after each
    run."""
    import resource

    import torch
    sys.path.insert(0, REPO)
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import wsi
    from multimodalfusion_tpu_torch.extract.features import Embedder
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    from multimodalfusion_tpu_torch.utils import image_ops
    counters = [mil._fused_pool_cuda, mil._fused_pool_bwd_cuda]
    none = {c.__name__: 0 for c in counters}
    opened, open_slide = [], wsi.open_slide

    def track(path):
        slide = open_slide(path)
        opened.append(slide)
        return slide
    wsi.open_slide = track
    x = torch.zeros(128, 256, 256, 3, dtype=torch.uint8)
    image_ops.median_blur(image_ops.hsv_saturation(x[0].cuda()), 7)
    Embedder(allow_random=True, batch_size=128, device="cuda").embed_images(
        x.numpy(), resize=True)
    out = {"wall": {}, "launches": {}, "tiles": {}, "steps1": {},
           "rss_kib": {"warm-up": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss}}
    for name, src, ext, patched, feat, max_bytes in runs:
        os.environ.pop("MMF_TPU_WSI_MAX_BYTES", None)
        if max_bytes is not None:
            os.environ["MMF_TPU_WSI_MAX_BYTES"] = str(max_bytes)
        for stage, fn, argv in (
                ("stage0", create_patches.main, [
                    "--source", src, "--save_dir", patched, "--patch_size",
                    "256", "--step_size", "256", "--a_t", "0.5", "--a_h",
                    "0.05", "--device", "cuda"]),
                ("stage1", extract_features_fp.main, [
                    "--data_h5_dir", patched, "--data_slide_dir", src,
                    "--feat_dir", feat, "--target_patch_size", "224",
                    "--batch_size", "128", "--allow_random_weights",
                    "--device", "cuda"] + ([] if ext == ".svs" else [
                        "--slide_ext", ext]))):
            first = len(opened)
            key = f"{stage}_{name}"
            text = _run_stage(counters, "wsi", key, fn, argv, out["wall"],
                              out["launches"], none, capture=True)
            if "FAILED" in text:
                raise AssertionError(f"[wsi] {key}: FAILED\n{text}")
            aperio = [sl for sl in opened[first:]
                      if isinstance(sl, wsi.OpenSlideBackend)]
            out["tiles"][key] = {
                "touched": sum(sl.tiles_touched for sl in aperio),
                "decoded": sum(sl.tiles_decoded for sl in aperio),
                "peak_bytes": max([sl.cache.peak_bytes for sl in aperio],
                                  default=0),
                "bound_bytes": max([sl.cache.max_bytes for sl in aperio],
                                   default=0)}
            if stage == "stage1":
                out["steps1"][name] = _stage_line(text, "stage 1 wall s")[1]
        out["rss_kib"][name] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
    with open(result, "w") as f:
        json.dump(out, f)


def phase_wsi_svs(launch_counters, path_exp, td, lzw, wall, launches):
    """[wsi]'s Aperio slide: ``synthetic_slide`` of ``SVS_LEVEL0`` (seed
    ``SVS_SEED``), its levels at ``SVS_DOWNSAMPLES`` resized on the card,
    written by tools/svs_writer.py as an Aperio ``.svs`` (240 x 240 JPEG
    tiles of ``utils/jpeg.encode_jpeg``, coded in spawned workers, their
    tables in JPEGTables; a JPEG thumbnail, an LZW label by ``lzw``, a
    JPEG macro; AppMag 20, MPP 0.4990) and, with the same tile bytes, as a
    plain tiled TIFF, its twin.  Then:
      - ``open_slide`` on the .svs (MMF_TPU_WSI_MAX_BYTES unset): 3
        levels, their dimensions, downsamples 4.0 and 16.0, openslide's
        mpp and objective power, ``fetch_mag_patching_params`` level 0 at
        20x and level 1 at 5x; ``PILSlide`` refuses the twin under its
        default budget and reads it under 4 GiB;
      - each level of the .svs read whole through ``read_region`` equals
        the twin's bit for bit (C++ decode ms per megapixel of each);
        level 2 and ``SVS_PLAIN_TILES`` seeded level-0 tiles decoded again
        by the plain decoder equal them;
      - in a child process (``_svs_child``): cli.create_patches and
        cli.extract_features_fp (the default --slide_ext .svs) on the
        .svs, then on the twin: no launch; the tiles each stage touched
        and decoded (decoded <= touched) and the cache's peak (<= its
        bound); the peak RSS after each; the .svs's coordinates,
        attributes and bags equal the twin's;
      - cli.infer of [train]'s PathAMIL on the two bags (the counters
        reset just before): one forward launch, no backward, the two
        risks equal and at rel 1e-4 of the plain pooling's.
    Adds its launch counts to ``launches`` and wall seconds to ``wall``."""
    import torch
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt, save_pt
    from multimodalfusion_tpu_torch.utils import image_ops, jpeg, tiff
    svs = _tool("svs_writer")
    t_phase = time.perf_counter()
    none = {c.__name__: 0 for c in launch_counters}
    w0, h0 = SVS_LEVEL0
    stem = f"SVS_{w0}x{h0}"
    dirs = {k: os.path.join(td, f"slide_{k}") for k in ("svs", "twin")}
    for d in dirs.values():
        os.makedirs(d)
    path = os.path.join(dirs["svs"], f"{stem}.svs")
    twin = os.path.join(dirs["twin"], f"{stem}.tiff")
    t0 = time.perf_counter()
    level0 = wsi.synthetic_slide(w0, h0, n_blobs=3, seed=SVS_SEED,
                                 n_levels=1).levels[0]
    x = torch.from_numpy(level0).cuda()
    levels = [level0] + [image_ops.resize_u8(x, (h0 // d, w0 // d)).cpu()
                         .numpy() for d in SVS_DOWNSAMPLES]
    del x
    wall["svs_pixels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coded = svs.encode_levels(levels, jpeg.encode_jpeg,
                              processes=os.cpu_count() or 1)
    small = levels[-1]
    svs.write_svs(path, coded, jpeg.encode_jpeg, thumbnail=small,
                  label=np.ascontiguousarray(level0[:463, :387]),
                  lzw=lambda a: lzw(a.tobytes()),
                  macro=np.ascontiguousarray(small[:400]))
    wall["svs_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    svs.write_twin(twin, coded)
    wall["svs_twin_write"] = time.perf_counter() - t0
    n_tiles = [len(c.tiles) for c in coded]
    log(f"[wsi] svs: {stem}.svs ({os.path.getsize(path) / 2**20:.1f} MiB; "
        f"levels {[(c.width, c.height) for c in coded]}, {n_tiles} tiles "
        f"of {svs.TILE} x {svs.TILE}) written in {wall['svs_write']:.3f} s "
        f"(utils/jpeg.encode_jpeg in {os.cpu_count()} spawned workers), "
        f"its pixels made in {wall['svs_pixels']:.3f} s; the twin "
        f"({os.path.getsize(twin) / 2**20:.1f} MiB, the same tile bytes) "
        f"in {wall['svs_twin_write']:.3f} s ({_card()})")
    del coded

    # stages 0 and 1 in a child process, the .svs then its twin
    result = os.path.join(td, "svs_child.json")
    # run names: the keys of their stages in ``wall`` and ``launches``
    runs = [("svs", dirs["svs"], ".svs", os.path.join(td, "patched_svs"),
             os.path.join(td, "features_svs"), None),
            ("svs_twin", dirs["twin"], ".tiff",
             os.path.join(td, "patched_twin"),
             os.path.join(td, "features_twin"), WSI_MAX_BYTES)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke._svs_child("
                               f"{runs!r}, {result!r})"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    wall["svs_child"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[wsi] svs: the child failed "
                             f"(rc {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    with open(result) as f:
        child = json.load(f)
    for key, counts in child["launches"].items():
        launches[key] = counts
        wall[key] = child["wall"][key]
        if counts != none:
            raise AssertionError(f"[wsi] svs: {key} launched {counts}")
    tiles = child["tiles"]
    for key in ("stage0_svs", "stage1_svs"):
        t = tiles[key]
        if not 0 < t["decoded"] <= t["touched"] \
                or t["peak_bytes"] > t["bound_bytes"]:
            raise AssertionError(f"[wsi] svs: {key} tiles {t}")
    coords, attrs, bags = {}, {}, {}
    for k in ("svs", "twin"):
        with hdf5.File(os.path.join(td, f"patched_{k}", "patches",
                                    f"{stem}_patches.h5")) as f:
            coords[k], attrs[k] = f["coords"], f.attrs("coords")
        bags[k] = load_pt(os.path.join(td, f"features_{k}", "path_pt_files",
                                       f"{stem}.pt"))
    xy = coords["svs"]
    n = len(xy)
    if n < 1 or not np.array_equal(xy, coords["twin"]) \
            or sorted(attrs["svs"]) != sorted(attrs["twin"]) \
            or any(not np.array_equal(attrs["svs"][a], attrs["twin"][a])
                   for a in attrs["svs"]) \
            or bags["svs"].shape != (n, 1024) \
            or bags["twin"].shape != (n, 1024):
        raise AssertionError(f"[wsi] svs: stage 0 differs from the twin's "
                             f"({n} coordinates)")
    # a patch across the level's edge reads black past it on the .svs, as
    # openslide's transparent pixels do, white on the twin (ArraySlide)
    inner = ((xy >= 0) & (xy + 256 <= [w0, h0])).all(axis=1)
    if not np.array_equal(bags["svs"][inner], bags["twin"][inner]):
        raise AssertionError("[wsi] svs: a bag row of a patch inside the "
                             "level differs from the twin's")

    env = os.environ.pop("MMF_TPU_WSI_MAX_BYTES", None)
    try:
        t0 = time.perf_counter()
        slide = wsi.open_slide(path)
        open_ms = (time.perf_counter() - t0) * 1e3
        props = slide.wsi.properties
        want_dims = [(w0 // d, h0 // d) for d in (1,) + SVS_DOWNSAMPLES]
        mags = [wsi.fetch_mag_patching_params(slide, mag_level=m)
                for m in (20, 5)]
        if not isinstance(slide, wsi.OpenSlideBackend) \
                or slide.level_dimensions != want_dims \
                or slide.level_downsamples != [(1.0, 1.0), (4.0, 4.0),
                                               (16.0, 16.0)] \
                or props["aperio.MPP"] != "0.4990" \
                or props["openslide.mpp-x"] != "%.17g" % 0.499 \
                or props["openslide.objective-power"] != "20" \
                or mags != [(20, 0, 256, 256, None), (20, 1, 256, 256, None)]:
            raise AssertionError(f"[wsi] svs: {slide.level_dimensions} "
                                 f"{slide.level_downsamples} {props} {mags}")
        try:
            wsi.PILSlide(twin)
        except ValueError as e:
            refused = str(e).split(". ")[0].split("needs ")[1]
        else:
            raise AssertionError("[wsi] svs: PILSlide read the twin under "
                                 "its default budget")
    finally:
        if env is not None:
            os.environ["MMF_TPU_WSI_MAX_BYTES"] = env
    t0 = time.perf_counter()
    twin_slide = wsi.PILSlide(twin, max_decode_bytes=WSI_MAX_BYTES)
    want = twin_slide.levels
    twin_s = time.perf_counter() - t0
    rates = []
    for lvl, (w, h) in enumerate(want_dims):
        t0 = time.perf_counter()
        got = slide.read_region((0, 0), lvl, (w, h))
        rates.append((time.perf_counter() - t0) * 1e3 / (w * h / 1e6))
        if not np.array_equal(got, want[lvl]):
            raise AssertionError(f"[wsi] svs: level {lvl} differs from the "
                                 f"twin's")
        if lvl == 0:
            level0_read = got
    pages = tiff.read_pages(path)
    rng = np.random.default_rng(SVS_SEED)
    T = svs.TILE
    for lvl, picks in ((2, None), (0, SVS_PLAIN_TILES)):
        page = pages[slide.wsi.levels[lvl]]
        across, down = tiff.tile_grid(page)
        tiles_ = (range(across * down) if picks is None else
                  rng.choice(across * down, picks, replace=False).tolist())
        src = want[lvl] if lvl else level0_read
        for t in tiles_:
            y, x = t // across * T, t % across * T
            out = np.empty_like(src[y:y + T, x:x + T])
            tiff.read_tiles(path, page, [t], [out], plain=True)
            if not np.array_equal(out, src[y:y + T, x:x + T]):
                raise AssertionError(f"[wsi] svs: level {lvl} tile {t}: "
                                     f"plain and C++ differ")
    del level0_read
    # every stage-1 patch, the twin's blacked out past the level's edge
    got = wsi.read_patches(slide, xy, 0, 256)
    ref = wsi.read_patches(twin_slide, xy, 0, 256)
    for i in np.flatnonzero(~inner):
        x, y = xy[i]
        ref[i, max(h0 - y, 0):] = 0
        ref[i, :, max(w0 - x, 0):] = 0
    if not np.array_equal(got, ref):
        raise AssertionError("[wsi] svs: the stage-1 patches differ from "
                             "the twin's")
    log(f"[wsi] svs: open_slide {open_ms:.3f} ms, MMF_TPU_WSI_MAX_BYTES "
        f"unset, 3 levels {want_dims}, downsamples "
        f"{[d for d, _ in slide.level_downsamples]}, aperio.MPP "
        f"{props['aperio.MPP']!r}, openslide.mpp-x "
        f"{props['openslide.mpp-x']!r}, objective-power "
        f"{props['openslide.objective-power']!r}; fetch_mag_patching_params "
        f"20x {mags[0]}, 5x {mags[1]}; PILSlide refuses the twin under its "
        f"default budget ({refused}) and reads it under 4 GiB in "
        f"{twin_s:.3f} s; each level read whole through read_region equals "
        f"the twin's bit for bit, C++ ms/MP {[round(r, 3) for r in rates]} "
        f"({os.cpu_count()} host threads, {_card()}); level 2 and "
        f"{SVS_PLAIN_TILES} seeded level-0 tiles: plain = C++; the {n} "
        f"stage-1 patches equal the twin's ({int((~inner).sum())} across "
        f"the level's edge: black past it, as openslide reads); tiles "
        f"decoded {slide.tiles_decoded} of {slide.tiles_touched} touched, "
        f"cache peak {slide.cache.peak_bytes} of {slide.cache.max_bytes} "
        f"bytes")
    del want, twin_slide, slide, got, ref, level0, levels, small

    steps = child["steps1"]
    per = {k: {"read_ms_per_patch": steps[k]["read"] * 1e3 / n,
               "embed_ms_per_patch": steps[k]["embed"] * 1e3 / n}
           for k in steps}
    log(f"[wsi] svs: in a child process (cuda, after a warm-up), "
        f"cli.create_patches {wall['stage0_svs']:.3f} s on the .svs, "
        f"{wall['stage0_svs_twin']:.3f} s on the twin; "
        f"cli.extract_features_fp (the default --slide_ext .svs) "
        f"{wall['stage1_svs']:.3f} / {wall['stage1_svs_twin']:.3f} s; {n} "
        f"patches each, the twin's coordinates and attributes, its bag's "
        f"{int(inner.sum())} rows of patches inside the level bit for "
        f"bit; no launch; read ms per patch (prefetch thread) "
        f"{per['svs']['read_ms_per_patch']:.4f} (.svs tiles) / "
        f"{per['svs_twin']['read_ms_per_patch']:.4f} (the twin's crop in "
        f"RAM), "
        f"embedding ms per patch {per['svs']['embed_ms_per_patch']:.4f} / "
        f"{per['svs_twin']['embed_ms_per_patch']:.4f}; tiles touched / "
        f"decoded "
        f"/ cache peak bytes (bound): stage 0 {tiles['stage0_svs']}, stage 1 "
        f"{tiles['stage1_svs']}; the child's peak RSS after its warm-up "
        f"{child['rss_kib']['warm-up'] / 2**20:.3f} GiB, after the .svs "
        f"{child['rss_kib']['svs'] / 2**20:.3f} GiB, after the twin too "
        f"{child['rss_kib']['svs_twin'] / 2**20:.3f} GiB; the child "
        f"{wall['svs_child']:.3f} s ({_card()})")

    # served: both bags, and both cut to the rows inside the level
    serve = os.path.join(td, "serve_svs")
    os.makedirs(os.path.join(serve, "path_pt_files"))
    for k in bags:
        for cut, rows in (("", bags[k]), ("_inner", bags[k][inner])):
            save_pt(os.path.join(serve, "path_pt_files",
                                 f"{stem}_{k}{cut}.pt"), rows)
    cohort = os.path.join(td, "wsi_svs_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"S_{k}{cut},{stem}_{k}{cut}.svs\n" for k in bags
            for cut in ("", "_inner")))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_svs", "on the .svs slide's bag and "
        "its twin's, whole and cut to the patches inside the level",
        path_exp, cohort, serve, td, dict(none, _fused_pool_cuda=1), wall,
        launches)
    log(f"[wsi] svs risks: {served}")
    if served["S_svs_inner"] != served["S_twin_inner"] or (
            inner.all() and served["S_svs"] != served["S_twin"]):
        raise AssertionError("[wsi] svs: the .svs slide's risk differs from "
                             "its twin's")
    for d in list(dirs.values()) + [serve] + [os.path.join(td, f"{p}_{k}")
                                              for p in ("patched",
                                                        "features")
                                              for k in ("svs", "twin")]:
        shutil.rmtree(d)
    wall["svs"] = time.perf_counter() - t_phase
    log(f"[wsi] svs sub-phase: {wall['svs']:.3f} s ({_card()})")


def phase_wsi_j2k(launch_counters, path_exp, td, level0, stem, wall,
                  launches):
    """[wsi]'s JPEG 2000 slide: ``level0`` (level 0 of [wsi]'s slide
    ``stem``, 8192 x 6144 RGB) written as a lossless 3-component .jp2 with
    the RCT by the port's encoder (C++ tier 1 on every host thread), and
    again as a one-page uncompressed TIFF, its twin (a .jp2 holds one
    page, so the twin holds the same one):
      - the .jp2 read through ``PILSlide`` (C++, all host threads) equals
        the source pixels; its decode ms per megapixel beside the twin's
        read;
      - cli.create_patches on each (no launch; no stitch, the
        coordinates are what is compared): the same coordinates;
      - cli.extract_features_fp on each (no launch): the same features
        (bit for bit expected, the pixels being equal; else rtol 2e-3 /
        atol 2e-4, the ResNet tolerance);
      - cli.infer of [train]'s PathAMIL on the two bags (the counters
        reset just before): one forward launch, the two risks equal when
        the features are (else at rel 1e-4) and equal to the plain
        pooling's at rel 1e-4.
    Adds its launch counts to ``launches`` and wall seconds to ``wall``."""
    from multimodalfusion_tpu_torch import native
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.utils import j2k, tiff
    none = {c.__name__: 0 for c in launch_counters}
    h, w = level0.shape[:2]
    mp = h * w / 1e6
    name = f"WSIJ_{w}x{h}"
    dirs = {k: os.path.join(td, f"slide_{k}") for k in ("j2k", "twin")}
    for d in dirs.values():
        os.makedirs(d)
    jp2 = os.path.join(dirs["j2k"], f"{name}.jp2")
    native.j2k_encode_blocks.calls = 0
    t0 = time.perf_counter()
    data = j2k.encode(level0)
    with open(jp2, "wb") as f:
        f.write(data)
    wall["write_jp2"] = time.perf_counter() - t0
    tiff.write_tiff(os.path.join(dirs["twin"], f"{name}.tiff"), [level0])
    native.j2k_decode_blocks.calls = 0
    t0 = time.perf_counter()
    got = wsi.PILSlide(jp2).levels
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    wsi.PILSlide(os.path.join(dirs["twin"], f"{name}.tiff"))
    dt_twin = time.perf_counter() - t0
    if len(got) != 1 or not np.array_equal(got[0], level0) \
            or native.j2k_decode_blocks.calls != 1 \
            or native.j2k_encode_blocks.calls != 1:
        raise AssertionError(f"[wsi] {name}.jp2 does not decode to its "
                             f"source pixels")
    log(f"[wsi] {name}.jp2 (lossless 5/3, RCT, 5 levels, 64 x 64 "
        f"code-blocks; {len(data) / 2**20:.1f} MiB, "
        f"{len(data) / level0.nbytes:.3f} of the raw bytes) written in "
        f"{wall['write_jp2']:.3f} s, read in {dt:.3f} s = "
        f"{dt * 1e3 / mp:.3f} ms/MP ({os.cpu_count()} host threads, "
        f"{_card()}), equal to its source ({stem}'s level 0); its "
        f"uncompressed one-page TIFF twin read in {dt_twin:.3f} s = "
        f"{dt_twin * 1e3 / mp:.3f} ms/MP")

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "wsi", stage, fn, argv, wall,
                          launches, none, capture=True)
        if "FAILED" in text:
            raise AssertionError(f"[wsi] {stage}: FAILED\n{text}")

    coords, bags = {}, {}
    for k, ext in (("j2k", ".jp2"), ("twin", ".tiff")):
        out = os.path.join(td, f"patched_{k}")
        feat = os.path.join(td, f"features_{k}")
        run(f"stage0_{k}", create_patches.main, [
            "--source", dirs[k], "--save_dir", out, "--patch_size", "256",
            "--step_size", "256", "--a_t", "0.5", "--a_h", "0.05",
            "--device", "cuda"])
        run(f"stage1_{k}", extract_features_fp.main, [
            "--data_h5_dir", out, "--data_slide_dir", dirs[k], "--feat_dir",
            feat, "--slide_ext", ext, "--target_patch_size", "224",
            "--batch_size", "128", "--allow_random_weights", "--device",
            "cuda"])
        with hdf5.File(os.path.join(out, "patches",
                                    f"{name}_patches.h5")) as f:
            coords[k] = f["coords"]
        bags[k] = load_pt(os.path.join(feat, "path_pt_files", f"{name}.pt"))
    bitwise = np.array_equal(bags["j2k"], bags["twin"])
    diff = float(np.abs(bags["j2k"].astype(np.float64) - bags["twin"]).max())
    if not np.array_equal(coords["j2k"], coords["twin"]) \
            or len(coords["j2k"]) < 1 or not np.allclose(
                bags["j2k"], bags["twin"], rtol=2e-3, atol=2e-4):
        raise AssertionError(f"[wsi] {name}: the .jp2 patches or features "
                             f"differ from its twin's (max |d| {diff:.3e})")
    log(f"[wsi] {name}.jp2 and its twin: cli.create_patches "
        f"{wall['stage0_j2k']:.2f} / {wall['stage0_twin']:.2f} s, "
        f"{len(coords['j2k'])} patches each, equal coordinates; "
        f"cli.extract_features_fp {wall['stage1_j2k']:.2f} / "
        f"{wall['stage1_twin']:.2f} s, features bit for bit {bitwise}, max "
        f"|d| {diff:.3e}; no launch in either")
    serve = os.path.join(td, "serve_j2k")
    os.makedirs(os.path.join(serve, "path_pt_files"))
    for k in bags:
        os.symlink(os.path.join(td, f"features_{k}", "path_pt_files",
                                f"{name}.pt"),
                   os.path.join(serve, "path_pt_files", f"{name}_{k}.pt"))
    cohort = os.path.join(td, "wsi_j2k_cohort.csv")
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n" + "".join(
            f"P_{k},{name}_{k}.tiff\n" for k in bags))
    served, _ = _serve_and_check(
        launch_counters, "wsi", "serve_j2k", "on the .jp2 slide's bag and "
        "its twin's", path_exp, cohort, serve, td,
        dict(none, _fused_pool_cuda=1), wall, launches)
    twin_err = abs(served["P_j2k"] - served["P_twin"]) / abs(served["P_twin"])
    log(f"[wsi] the .jp2 slide's risk and its twin's: {served}")
    if twin_err > (0 if bitwise else 1e-4):
        raise AssertionError("[wsi] the .jp2 slide's risk differs from its "
                             "twin's")
    for d in dirs.values():
        shutil.rmtree(d)


def phase_wsi(launch_counters, path_exp, root=None, slides=WSI_SLIDES,
              before_delete=None):
    """[wsi] WSI stages 0 and 1 on the card, then the bags served:
      - ``slides`` synthetic slides (``data/wsi.synthetic_slide``, 3
        levels, 3 blobs, seeds 100..) written as multi-page TIFFs by
        ``utils/tiff.py``; the large one read under MMF_TPU_WSI_MAX_BYTES
        of 4 GiB;
      - cli.create_patches --patch_size 256 --step_size 256 --stitch --a_t
        0.5 --a_h 0.05 (the filters on the card): no kernel launch; the
        patches of each slide and the host seconds of the filters,
        contour tracing, patch grid, mask/stitch drawing and JPEG
        encoding and h5 writing;
      - cli.extract_features_fp --slide_ext .tiff --target_patch_size 224
        --allow_random_weights, bf16, batch 128: no kernel launch; patches
        per second, split into the host's reads and the embedding (the
        256 -> 224 resize on the card included); every bag has as many
        rows as its h5 has coordinates, all finite; the port's reader
        reads back each coords h5's attributes;
      - the resize of a batch of 128 patches on the host and on the card,
        the trunk's card time per patch at 224 and embed_images' time per
        patch, warm, on 1024 host patches (CUDA events);
      - cli.infer serves the bags with [train]'s PathAMIL experiment, the
        counters reset just before: one forward launch per batch of 8,
        risks finite and equal to the plain pooling's at rel 1e-4;
      - the first four slides again as 256 x 256 tiled pyramids, one
        codec each of ``WSI_CODECS``, through ``phase_wsi_compressed``,
        then the sub-phases of the first one's level 0 and of BigTIFF,
        and last the Aperio slide of ``phase_wsi_svs``.
    Then ``before_delete(td, slides dir, features dir, stems)`` when
    given ([heatmap]).  The slides are deleted at the end.  Returns (the
    launch counts by run, what ``before_delete`` returned).
    """
    import torch
    from multimodalfusion_tpu_torch.cli import (create_patches,
                                                extract_features_fp)
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.data.io import load_pt
    from multimodalfusion_tpu_torch.extract.features import Embedder
    from multimodalfusion_tpu_torch.utils import image_ops, tiff
    wall, launches = {}, {}
    none = {c.__name__: 0 for c in launch_counters}

    with _workdir(root, "wsi") as td:
        src = os.path.join(td, "slides")
        src_c = os.path.join(td, "slides_compressed")
        os.makedirs(src)
        os.makedirs(src_c)
        t0 = time.perf_counter()
        stems, twins, sources = [], {}, {}
        lzw = _lzw_encoder(td)
        for i, (w, h) in enumerate(slides):
            slide = wsi.synthetic_slide(w, h, n_blobs=3, seed=100 + i,
                                        n_levels=3)
            stems.append(f"WSI{i}_{w}x{h}")
            tiff.write_tiff(os.path.join(src, f"{stems[-1]}.tiff"),
                            slide.levels)
            if i < len(WSI_CODECS):
                codec = WSI_CODECS[i]
                stem = f"WSIC{i}_{codec}_{w}x{h}"
                twins[stem], sources[stem] = stems[-1], slide.levels
                t1 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(
                        os.cpu_count()) as pool:
                    _write_tiled_tiff(os.path.join(src_c, f"{stem}.tiff"),
                                      slide.levels, codec, pool, lzw)
                wall[f"write_{codec}"] = time.perf_counter() - t1
            del slide
        wall["write_slides"] = time.perf_counter() - t0
        log(f"[wsi] wrote {len(slides)} synthetic slides "
            f"({', '.join(f'{w}x{h}' for w, h in slides)}, 3 levels each) "
            f"as TIFF, and the first {len(twins)} again as 256 x 256 tiled "
            f"pyramids ({', '.join(WSI_CODECS)}: "
            + ", ".join(f"{wall[f'write_{c}']:.2f}" for c in WSI_CODECS)
            + f" s, tiles encoded in {os.cpu_count()} threads), in "
            f"{wall['write_slides']:.2f} s")
        env = os.environ.get("MMF_TPU_WSI_MAX_BYTES")
        os.environ["MMF_TPU_WSI_MAX_BYTES"] = str(WSI_MAX_BYTES)
        try:
            # stage 0
            out0 = os.path.join(td, "patched")
            text = _run_stage(launch_counters, "wsi", "stage0",
                              create_patches.main, [
                                  "--source", src, "--save_dir", out0,
                                  "--patch_size", "256", "--step_size",
                                  "256", "--stitch", "--a_t", "0.5",
                                  "--a_h", "0.05", "--device", "cuda"],
                              wall, launches, none, capture=True)
            line0, steps0 = _stage_line(text, "stage 0 wall s")
            rows = {r["slide_id"]: r for r in _csv_rows(os.path.join(
                out0, "process_list_autogen.csv"))}
            n_patches = {s: int(rows[f"{s}.tiff"]["n_patches"])
                         for s in stems}
            seconds0 = _slide_seconds(text)
            log(f"[wsi] cli.create_patches: {wall['stage0']:.2f} s, "
                f"launches {launches['stage0']}; patches per slide "
                f"{n_patches}; {line0}")
            if "FAILED" in text or any(
                    rows[f"{s}.tiff"]["status"] != "processed"
                    or n_patches[s] < 1 for s in stems):
                raise AssertionError(f"[wsi] stage 0:\n{text}")
            for s in stems:
                for d, suffix in (("masks", "_mask.jpg"),
                                  ("stitches", "_stitch.jpg")):
                    with open(os.path.join(out0, d, s + suffix), "rb") as f:
                        head = f.read(4)
                    if head[:3] != b"\xff\xd8\xff":
                        raise AssertionError(f"[wsi] {d}/{s}{suffix} is not "
                                             f"a JPEG")

            # stage 1
            feat = os.path.join(td, "features")
            text = _run_stage(launch_counters, "wsi", "stage1",
                              extract_features_fp.main, [
                                  "--data_h5_dir", out0, "--data_slide_dir",
                                  src, "--feat_dir", feat, "--slide_ext",
                                  ".tiff", "--target_patch_size", "224",
                                  "--batch_size", "128",
                                  "--allow_random_weights", "--device",
                                  "cuda"], wall, launches, none,
                              capture=True)
            line1, steps1 = _stage_line(text, "stage 1 wall s")
            total = sum(n_patches.values())
            log(f"[wsi] cli.extract_features_fp (bf16, batch 128, 256 -> "
                f"224 on the card): {wall['stage1']:.2f} s, launches "
                f"{launches['stage1']}; {total} patches: "
                f"{total / wall['stage1']:.1f} patches/s overall, host "
                f"reads {total / steps1['read']:.1f} patches/s (prefetch "
                f"thread), resize + embedding "
                f"{total / steps1['embed']:.1f} patches/s; {line1}")
        finally:
            if env is None:
                os.environ.pop("MMF_TPU_WSI_MAX_BYTES", None)
            else:
                os.environ["MMF_TPU_WSI_MAX_BYTES"] = env

        # every bag against its coordinates; the attributes read back
        for s, (w, h) in zip(stems, slides):
            with hdf5.File(os.path.join(out0, "patches",
                                        f"{s}_patches.h5")) as f:
                coords, attrs = f["coords"], f.attrs("coords")
            with hdf5.File(os.path.join(feat, "h5_files", f"{s}.h5")) as f:
                feats, coords1 = f["features"], f["coords"]
            bag = load_pt(os.path.join(feat, "path_pt_files", f"{s}.pt"))
            ok = (bag.shape == (len(coords), 1024) and feats.shape ==
                  bag.shape and np.array_equal(coords1, coords)
                  and np.isfinite(bag).all() and np.array_equal(feats, bag)
                  and attrs["name"] == s and int(attrs["patch_size"]) == 256
                  and int(attrs["patch_level"]) == 0
                  and attrs["level_dim"].tolist() == [w, h]
                  and attrs["downsample"].tolist() == [1.0, 1.0])
            if not ok:
                raise AssertionError(f"[wsi] {s}: bag {bag.shape}, "
                                     f"coords {coords.shape}, attrs {attrs}")
        log(f"[wsi] {len(stems)} bags: rows equal to their h5's "
            f"coordinates, finite, .pt equal to h5; the coords attributes "
            f"read back by the port's reader")

        # the resize of one batch on the host and on the card; the trunk
        rng = np.random.default_rng(7)
        batch = torch.from_numpy(rng.integers(0, 256, (128, 256, 256, 3),
                                              dtype=np.uint8))
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            image_ops.resize_u8(batch, (224, 224))
            host.append(time.perf_counter() - t0)
        gpu = batch.cuda()
        card = 1.0 / _images_per_s(
            lambda: image_ops.resize_u8(gpu, (224, 224)), 1, reps=5)
        same = torch.equal(image_ops.resize_u8(gpu, (224, 224)).cpu(),
                           image_ops.resize_u8(batch, (224, 224)))
        emb = Embedder(allow_random=True, batch_size=128, device="cuda")
        x = emb._prepare_images(image_ops.resize_u8(gpu, (224, 224)))

        def trunk():
            with torch.inference_mode(), emb._compute():
                emb.model(x)
        trunk_us = 1e6 / _images_per_s(trunk, 128, reps=5)
        # embed_images as the CLI calls it, warm, on 1024 host patches
        patches = rng.integers(0, 256, (1024, 256, 256, 3), dtype=np.uint8)
        embed_us = 1e6 / _images_per_s(
            lambda: emb.embed_images(patches, resize=True), len(patches))
        log(f"[wsi] resize of 128 patches 256 -> 224 (uint8, exact): host "
            f"(torch CPU) {min(host) * 1e3:.2f} ms, card "
            f"{card * 1e3:.3f} ms (CUDA events), equal {same}; bf16 trunk "
            f"on the card {trunk_us:.2f} us a patch at 224, batch 128 "
            f"(as [extract]'s trunk line); embed_images(resize=True) of "
            f"1024 uint8 256-px patches from the host, warm: "
            f"{embed_us:.2f} us a patch")
        if not same:
            raise AssertionError("[wsi] the card's resize differs from the "
                                 "host's")

        # serving the bags with [train]'s PathAMIL
        cohort = os.path.join(td, "wsi_cohort.csv")
        with open(cohort, "w") as f:
            f.write("subject_id,slide_id\n" + "".join(
                f"P{s},{s}.tiff\n" for s in stems))
        served, _ = _serve_and_check(
            launch_counters, "wsi", "serve", "of [train]'s PathAMIL on the "
            "extracted bags", path_exp, cohort, feat, td,
            dict(none, _fused_pool_cuda=-(-len(stems) // 8)), wall, launches)
        log(f"[wsi] served risks {sorted(served.values())}")
        out_c, feat_c, served_c = phase_wsi_compressed(
            launch_counters, path_exp, td, src_c, src, twins, sources, out0,
            steps0, seconds0, wall, launches)
        first = next(iter(twins))
        phase_wsi_j2k(launch_counters, path_exp, td, sources[first][0],
                      twins[first], wall, launches)
        phase_wsi_progressive(launch_counters, path_exp, td,
                              sources[first][0], twins[first], wall,
                              launches)
        phase_wsi_arith(launch_counters, path_exp, td, sources[first][0],
                        twins[first], wall, launches)
        phase_wsi_zstd(launch_counters, path_exp, td, sources[first][0],
                       twins[first], wall, launches)
        phase_wsi_bigtiff(launch_counters, path_exp, td, src_c, list(twins),
                          out_c, feat_c, served_c, wall, launches)
        phase_wsi_svs(launch_counters, path_exp, td, lzw, wall, launches)
        del sources
        shutil.rmtree(src_c)
        log(f"[wsi] wall s ({_card()}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in wall.items()) + "; stage 0 steps "
            + json.dumps(steps0) + "; stage 1 steps " + json.dumps(steps1))
        extra = None
        if before_delete is not None:
            extra = before_delete(td, src, feat, stems)
        shutil.rmtree(src)
    return launches, extra


# [heatmap] run B's small slide, and the sampling specs of its list form
HEATMAP_B_SAMPLES = [
    {"name": "topk_high", "sample": True, "k": 8, "mode": "topk"},
    {"name": "mid_band", "sample": True, "seed": 1, "k": 8,
     "mode": "range_sample", "score_start": 0.45, "score_end": 0.55},
    {"name": "skipped", "sample": False, "k": 8, "mode": "reverse_topk"},
]


def phase_heatmap(launch_counters, path_exp, td, src, feat, stems):
    """[heatmap] The path branch of cli.create_heatmaps on [wsi]'s slides
    (``src``) and feature h5 files (``feat``), with [train]'s PathAMIL
    small (1024 -> 256, gated), the counters reset just before each run
    and read just after:
      - run A: cli.summarize --emit_heatmap_yamls over [train]'s
        experiment with examples/heatmap_path.yaml as the template, its
        data paths rewritten to [wsi]'s and resnet_weights swapped for
        allow_random_weights (coolwarm, overlap 0.75, vis_level -1,
        segment, use_holes, save_orig, jpg, floor 200, save_n 16); the
        emitted config run unmodified over the five slides: no launch;
        each slide's blockmap with its h5's coordinates and finite scores,
        its heatmap, orig and fine heatmap JPEGs, 16 PNGs and a mosaic for
        topk and reverse_topk;
      - run B: the first slide with an empty feat_dir (extraction on a
        miss), RdYlBu_r, blur, custom_downsample 2, use_ref_scores, png and
        the list form with a range_sample spec: no launch;
      - run C: run B's coarse pass (overlap 0) with --device cpu on the
        features run B wrote: blockmap scores at rel 1e-5 of the card's,
        the orig PNG's pixels equal, the heatmap's equal or else only
        where near-tied scores change percentile rank between the two
        read-outs (the share of pixels and the patches that moved are
        printed), and the card's scores drawn again on the CPU equal to
        run B's heatmap pixel for pixel;
      - the read-out against mil_pool_fwd on the largest coarse and fine
        bags (B=1): masked_softmax_pool of the raw scores against the
        pooled features at rel 1e-4, one launch each; the kernel timed
        against its bound and the plain version.
    Each CLI prints one line of stage seconds per slide.  Returns (launch
    counts by run, the kernel's times at the slide bags)."""
    import torch
    from multimodalfusion_tpu_torch.cli import create_heatmaps, summarize
    from multimodalfusion_tpu_torch.data import hdf5, wsi
    from multimodalfusion_tpu_torch.interpret import heatmaps as hmaps
    from multimodalfusion_tpu_torch.ops import mil_attention as mil
    from multimodalfusion_tpu_torch.utils import png, yaml_subset
    from multimodalfusion_tpu_torch.utils.experiment import (
        config_from_settings, load_experiment_model, read_experiment)
    t_phase = time.perf_counter()
    hm = os.path.join(td, "heatmap")
    os.makedirs(hm)
    launches, wall = {}, {}
    none = {c.__name__: 0 for c in launch_counters}
    one_fwd = dict(none, _fused_pool_cuda=1)

    def reset():
        for c in launch_counters:
            c.launches = 0

    def count():
        return {c.__name__: c.launches for c in launch_counters}

    def run(stage, fn, argv):
        text = _run_stage(launch_counters, "heatmap", stage, fn, argv, wall,
                          launches, none, capture=True)
        with open(os.path.join(hm, f"{stage}.log"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "path heatmap stages" in line:
                log(f"[heatmap] {stage}: {line}")
        log(f"[heatmap] {stage}: {wall[stage]:.2f} s, launches "
            f"{launches[stage]}")
        return text

    # the largest fine bag of run A, kept for the kernel check below
    fine_bags = {}
    fine_scores = create_heatmaps.compute_fine_scores

    def recording(*args, **kw):
        score = args[4]

        def keep(feats):
            if len(feats) > len(fine_bags.get("feats", ())):
                fine_bags["feats"] = feats
            return score(feats)
        return fine_scores(*args[:4], keep, *args[5:], **kw)

    plist = os.path.join(hm, "slides.csv")
    with open(plist, "w") as f:
        f.write("slide_id\n" + "".join(f"{s}.tiff\n" for s in stems))
    tpl = yaml_subset.load_file(os.path.join(REPO, "examples",
                                             "heatmap_path.yaml"))
    tpl["data_arguments"] = {"process_list": plist, "data_dir": src,
                             "feat_dir": feat}
    tpl["model_arguments"].pop("resnet_weights")
    tpl["model_arguments"]["allow_random_weights"] = True
    template = os.path.join(hm, "template_path.yaml")
    yaml_subset.dump_file(tpl, template)
    env = os.environ.get("MMF_TPU_WSI_MAX_BYTES")
    os.environ["MMF_TPU_WSI_MAX_BYTES"] = str(WSI_MAX_BYTES)
    create_heatmaps.compute_fine_scores = recording
    try:
        yamls = os.path.join(hm, "yamls")
        run("summarize", summarize.main, [
            "--results_root", os.path.dirname(path_exp), "--save_dir",
            os.path.join(hm, "summary"), "--emit_heatmap_yamls", yamls,
            "--heatmap_template", template])
        emitted = sorted(y for y in os.listdir(yamls) if y.endswith(".yaml"))
        if len(emitted) != 1:
            raise AssertionError(f"[heatmap] emitted {emitted}")
        cfg_a = os.path.join(yamls, emitted[0])
        cfg = yaml_subset.load_file(cfg_a)
        h = cfg["heatmap_arguments"]
        log(f"[heatmap] run A config {emitted[0]} (emitted by "
            f"cli.summarize): branch {cfg['exp_arguments']['branch']}, "
            f"cmap {h['cmap']}, overlap {h['overlap']}, vis_level "
            f"{h['vis_level']}, save_ext {h['save_ext']}, sample "
            f"{cfg['sample_arguments']}, model "
            f"{cfg['model_arguments']}")
        if cfg["exp_arguments"]["branch"] != "path" or h["cmap"] != \
                "coolwarm" or float(h["overlap"]) != 0.75:
            raise AssertionError(f"[heatmap] emitted config {cfg}")
        run("A", create_heatmaps.main, ["--config", cfg_a])
    finally:
        create_heatmaps.compute_fine_scores = fine_scores
    save_a = cfg["exp_arguments"]["save_dir"]
    summary = []
    for s in stems:
        with hdf5.File(os.path.join(save_a, f"{s}_blockmap.h5")) as f:
            scores, coords = f["attention_scores"], f["coords"]
        with hdf5.File(os.path.join(feat, "h5_files", f"{s}.h5")) as f:
            want_coords = f["coords"]
        pngs = {n: len(os.listdir(os.path.join(save_a, f"{s}_{n}")))
                for n in ("topk", "reverse_topk")}
        files = [f"{s}_{x}" for x in ("heatmap.jpg", "orig.jpg",
                                      "fine_heatmap.jpg", "topk_mosaic.png",
                                      "reverse_topk_mosaic.png")]
        missing = [x for x in files
                   if not os.path.isfile(os.path.join(save_a, x))]
        summary.append(f"{s}: {len(scores)} coarse scores, PNGs {pngs}")
        if not np.array_equal(coords, want_coords) or \
                not np.isfinite(scores).all() or missing or \
                any(n != min(16, len(scores)) for n in pngs.values()):
            raise AssertionError(f"[heatmap] run A {s}: missing {missing}, "
                                 f"PNGs {pngs}")
    log("[heatmap] run A outputs: " + "; ".join(summary))

    # runs B (card) and C (CPU) on the first slide
    stem = stems[0]
    plist_b = os.path.join(hm, "slide_b.csv")
    with open(plist_b, "w") as f:
        f.write(f"slide_id\n{stem}.tiff\n")
    feat_b = os.path.join(hm, "feat_b")

    def config_b(name, overlap):
        path = os.path.join(hm, f"{name}.yaml")
        yaml_subset.dump_file({
            "exp_arguments": {"branch": "path",
                              "save_dir": os.path.join(hm, name)},
            "data_arguments": {"process_list": plist_b, "data_dir": src,
                               "feat_dir": feat_b},
            "patching_arguments": tpl["patching_arguments"],
            "model_arguments": {"ckpt_path": path_exp, "which_k": 0,
                                "allow_random_weights": True},
            "heatmap_arguments": {
                "alpha": 0.4, "overlap": overlap, "vis_level": -1,
                "segment": True, "use_holes": True, "save_orig": True,
                "save_ext": "png", "blur": True, "custom_downsample": 2,
                "use_ref_scores": True},
            "sample_arguments": {"samples": HEATMAP_B_SAMPLES}}, path)
        return path
    run("B", create_heatmaps.main, ["--config", config_b("B", 0.75)])
    if not os.path.isfile(os.path.join(feat_b, "h5_files", f"{stem}.h5")):
        raise AssertionError("[heatmap] run B wrote no features h5")
    run("C", create_heatmaps.main, ["--config", config_b("C", 0.0),
                                    "--device", "cpu"])
    if env is None:
        os.environ.pop("MMF_TPU_WSI_MAX_BYTES", None)
    else:
        os.environ["MMF_TPU_WSI_MAX_BYTES"] = env
    blocks = []
    for name in ("B", "C"):
        with hdf5.File(os.path.join(hm, name, f"{stem}_blockmap.h5")) as f:
            blocks.append((f["attention_scores"], f["coords"]))
    err = float(np.abs(blocks[0][0] - blocks[1][0]).max()
                / np.abs(blocks[1][0]).max())
    same = {}
    for x in ("heatmap", "orig"):
        a, b = (png.read_png(os.path.join(hm, n, f"{stem}_{x}.png"))
                for n in ("B", "C"))
        same[x] = (a.shape, float(np.any(a != b, axis=-1).mean())
                   if a.shape == b.shape else 1.0)
    sampled = {n: sorted(os.listdir(os.path.join(hm, "B", f"{stem}_{n}")))
               for n in ("topk_high", "mid_band")}
    # use_ref_scores draws percentile ranks: where the card's and the
    # CPU's read-outs order two near-tied scores differently, the ranks
    # and so the pixels differ.  The card's scores drawn again on the
    # CPU must give run B's PNG exactly.
    ranks = [hmaps.score_to_percentile(b[0], b[0]) for b in blocks]
    n_moved = int(np.sum(ranks[0] != ranks[1]))
    slide = wsi.open_slide(os.path.join(src, f"{stem}.tiff"))
    patching = tpl["patching_arguments"]
    tissue, holes = wsi.segment_tissue(
        slide, a_t=float(patching["a_t"]), a_h=float(patching["a_h"]),
        device="cpu")
    redraw = hmaps.draw_heatmap(
        slide, ranks[0] / 100.0, blocks[0][1], patch_size=256, alpha=0.4,
        blur=True, use_percentiles=False, custom_downsample=2,
        segment=True, tissue=tissue, holes=holes, use_holes=True,
        device="cpu")
    redrawn_equal = np.array_equal(redraw, png.read_png(os.path.join(
        hm, "B", f"{stem}_heatmap.png")))
    # a patch whose rank moved changes at most its square at the vis level
    # grown by the blur's radius (the coarse pass blurs with 2 ps + 1 taps)
    w_vis, h_vis = slide.level_dimensions[-1]
    ps_vis = int(np.ceil(256 / slide.level_downsamples[-1][0]))
    share_max = n_moved * (3 * ps_vis) ** 2 / (w_vis * h_vis)
    log(f"[heatmap] runs B (card) and C (CPU) on {stem}: "
        f"{len(blocks[0][0])} patches extracted on a miss; blockmap scores "
        f"card vs CPU max rel err {err:.2e} (tol 1e-5), coords equal "
        f"{np.array_equal(blocks[0][1], blocks[1][1])}; PNG (shape, share "
        f"of pixels that differ) {same}; {n_moved} patches of "
        f"{len(ranks[0])} change percentile rank between the card's and "
        f"the CPU's scores (at most {share_max:.4f} of the pixels may "
        f"differ); the card's scores drawn on the CPU equal run "
        f"B's heatmap: {redrawn_equal}; sampled PNGs "
        f"{ {n: len(v) for n, v in sampled.items()} }, skipped spec absent "
        f"{not os.path.exists(os.path.join(hm, 'B', stem + '_skipped'))}")
    if err > 1e-5 or not np.array_equal(blocks[0][1], blocks[1][1]) or \
            same["orig"][1] != 0.0 or not redrawn_equal or \
            same["heatmap"][1] > share_max or \
            os.path.exists(os.path.join(hm, "B", f"{stem}_skipped")) or \
            not all(sampled.values()):
        raise AssertionError("[heatmap] run B and run C disagree")

    # the read-out against the forward kernel on the slide bags, B=1
    settings = read_experiment(path_exp)
    dev = torch.device("cuda")
    model = load_experiment_model(path_exp, 0, config_from_settings(
        settings, batch_size=1, device="cuda"), dev)
    params, gated = model.pool.attn_params(), model.pool.gated
    with hdf5.File(os.path.join(feat, "h5_files",
                                f"{stems[-1]}.h5")) as f:
        coarse = f["features"]
    timing = {}
    for tag, feats in (("coarse", coarse), ("fine", fine_bags["feats"])):
        bag = torch.from_numpy(np.ascontiguousarray(feats)).cuda()[None]
        mask = torch.ones(1, bag.shape[1], device=dev)
        with torch.no_grad():
            reset()
            s = model(bag, mask, attention_only=True)
            h = model.embed(bag).float()
            pooled = mil.masked_softmax_pool(s, h, mask)[0]
            launches[f"readout_{tag}"] = count()
            reset()
            fused = model(bag, mask, return_features=True)
            torch.cuda.synchronize()
            launches[f"pooled_{tag}"] = count()
            e = rel_err(pooled, fused)
            out, _ = mil._fused_pool_cuda(h, mask, params, gated, None, None)
            ref, _ = mil._pool_plain(h, mask, params, gated, None, None)
            plain1 = _time_ms(lambda: mil._pool_plain(h, mask, params, gated,
                                                      None, None))
            ms = _time_ms(lambda: mil._fused_pool_cuda(h, mask, params,
                                                       gated, None, None))
            plain2 = _time_ms(lambda: mil._pool_plain(h, mask, params, gated,
                                                      None, None))
        bound_ms, bound_by = _bound(h, mask, params.Wa.shape[1], gated)
        shape = (f"B=1 N={bag.shape[1]} D={h.shape[-1]} "
                 f"Da={params.Wa.shape[1]} float32 "
                 f"{'gated' if gated else 'ungated'}")
        timing[tag] = {"shape": shape, "ms": ms,
                       "plain_ms": min(plain1, plain2),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": _max_abs((out,), (ref,)),
                       "readout_rel_err": e}
        log(f"[heatmap] read-out of the largest {tag} bag ({shape}): "
            f"masked_softmax_pool(raw scores) vs mil_pool_fwd's pooled "
            f"features rel {e:.2e} (tol 1e-4), launches read-out "
            f"{launches[f'readout_{tag}']}, pooled "
            f"{launches[f'pooled_{tag}']}; kernel {ms:.3f} ms, plain "
            f"{plain1:.3f}/{plain2:.3f} ms, bound {bound_ms * 1e3:.1f} us "
            f"({bound_by}), kernel/bound {ms / bound_ms:.1f}")
        if e > 1e-4 or launches[f"readout_{tag}"] != none or \
                launches[f"pooled_{tag}"] != one_fwd:
            raise AssertionError(f"[heatmap] read-out {tag} disagrees")
    wall["phase"] = time.perf_counter() - t_phase
    log(f"[heatmap] wall s ({_card()}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in wall.items()))
    return launches, timing


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of build,kernels,digest,"
                         "slice,train,native,omic,pretrained,radio,extract,"
                         "gradcam,interpret,j2k,jpeg,zstd,h5,timing,"
                         "bf16step,"
                         "dist,"
                         "ops,report,wsi,svs,heatmap "
                         "(default: all but digest, which prints the "
                         "result lines)")
    args = ap.parse_args(argv)
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
    counters = [mil._fused_pool_cuda, mil._fused_pool_bwd_cuda]
    # the stage-2 experiments of [train] and [omic] stay here until
    # [pretrained] has extracted their embeddings
    with tempfile.TemporaryDirectory() as work:
        if args.phases != "all":
            return _partial(args.phases.split(","), counters, work, t_all)
        return _full(counters, work, t_all)


def _partial(phases, counters, work, t_all) -> int:
    """The phases asked for, in the full run's order; no result lines."""
    phase_build()
    if "kernels" in phases:
        phase_kernels()
        phase_kernels_train()
    if "digest" in phases:
        phase_digest()
    if "slice" in phases:
        phase_slice(counters[:1])
    if {"train", "wsi", "heatmap", "svs"} & set(phases):
        # [wsi] serves its bags with [train]'s experiment
        _, cfg, batches, host_ms, path_exp = phase_train(counters, work)
    if "native" in phases:
        phase_native(counters, os.path.join(work, "train") if "train" in
                     phases else None)
    if "omic" in phases:
        _, omic_exps, omic_args = phase_omic(counters, root=work)
    if "pretrained" in phases:
        if "train" in phases and "omic" in phases:
            phase_pretrained(counters, path_exp, omic_exps["omic"],
                             omic_args, work)
        else:
            phase_pretrained(counters, root=work)
    if {"radio", "extract", "interpret", "gradcam", "report", "h5"} & set(
            phases):
        # [extract], [interpret], [gradcam], [report] and [h5] alone first
        # write and train their own radio cohort
        _, _, radio_exps = phase_radio(counters, work)
    if "interpret" in phases:
        phase_interpret(counters, radio_exps, work)
    if "j2k" in phases:
        phase_j2k(counters)
    if "jpeg" in phases:
        phase_jpeg(counters)
    if "zstd" in phases:
        phase_zstd(counters)
    if "h5" in phases:
        phase_h5(counters, radio_exps["radio"], work)
    if "timing" in phases:
        phase_timing()
        phase_timing_radio()
        if "train" in phases:
            phase_step_breakdown(cfg, batches, host_ms)
    if "bf16step" in phases:
        phase_bf16step(counters)
    if {"extract", "gradcam"} & set(phases):
        # [gradcam] runs on [extract]'s cohort
        _, cohort = phase_extract(counters, radio_exps["radio"], work)
    if "gradcam" in phases:
        phase_gradcam(counters, radio_exps["radio"], cohort, work)
    if "dist" in phases:
        phase_dist(work)
    if "ops" in phases:
        phase_ops(counters, work)
    if "report" in phases:
        phase_report(counters, work)
    if "svs" in phases and "wsi" not in phases:
        # [wsi]'s Aperio sub-phase alone
        td = os.path.join(work, "svs")
        os.makedirs(td)
        phase_wsi_svs(counters, path_exp, td, _lzw_encoder(td), {}, {})
    if {"wsi", "heatmap"} & set(phases):
        # [heatmap] runs on [wsi]'s slides before they are deleted
        phase_wsi(counters, path_exp, work, before_delete=(
            (lambda *a: phase_heatmap(counters, path_exp, *a))
            if "heatmap" in phases else None))
    log(f"[total] {time.perf_counter() - t_all:.1f} s (partial run, "
        f"no result)")
    return 0


def _full(counters, work, t_all) -> int:
    import torch
    phase_build()
    t = time.perf_counter()
    phase_kernels()
    phase_kernels_train()
    log(f"[kernels] done in {time.perf_counter() - t:.1f} s")
    serve_launches = phase_slice(counters[:1])
    t = time.perf_counter()
    train_launches, cfg, batches, host_ms, path_exp = phase_train(counters,
                                                                  work)
    log(f"[train] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_native(counters, os.path.join(work, "train"))
    log(f"[native] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    omic_launches, omic_exps, omic_args = phase_omic(counters, root=work)
    log(f"[omic] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    pretrained_launches = phase_pretrained(counters, path_exp,
                                           omic_exps["omic"], omic_args,
                                           work)
    log(f"[pretrained] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    radio_launches, _, radio_exps = phase_radio(counters, work)
    log(f"[radio] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    interpret_launches = phase_interpret(counters, radio_exps, work)
    log(f"[interpret] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_j2k(counters)
    log(f"[j2k] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_jpeg(counters)
    log(f"[jpeg] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_zstd(counters)
    log(f"[zstd] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    h5_launches = phase_h5(counters, radio_exps["radio"], work)
    log(f"[h5] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    timing = phase_timing()
    timing_radio = phase_timing_radio()
    step = phase_step_breakdown(cfg, batches, host_ms)
    log(f"[timing] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bf16step, bf16step_launches = phase_bf16step(counters)
    log(f"[bf16step] done in {time.perf_counter() - t:.1f} s")
    # stage 1 last, after every earlier phase, on [radio]'s experiment
    t = time.perf_counter()
    extract_launches, cohort = phase_extract(counters, radio_exps["radio"],
                                             work)
    log(f"[extract] done in {time.perf_counter() - t:.1f} s")
    # stage 5's radiology images on the extracted cohort
    t = time.perf_counter()
    gradcam_launches = phase_gradcam(counters, radio_exps["radio"], cohort,
                                     work)
    log(f"[gradcam] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dist_launches = phase_dist(work)
    log(f"[dist] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ops_launches = phase_ops(counters, work)
    log(f"[ops] done in {time.perf_counter() - t:.1f} s")
    # the report over every experiment the phases above left
    t = time.perf_counter()
    report_launches = phase_report(counters, work)
    log(f"[report] done in {time.perf_counter() - t:.1f} s")
    # WSI stages 0 and 1, the bags served by [train]'s experiment, then
    # the heatmap path branch on the same slides and features
    t = time.perf_counter()
    wsi_launches, (heatmap_launches, heatmap_timing) = phase_wsi(
        counters, path_exp, work, before_delete=lambda *a: phase_heatmap(
            counters, path_exp, *a))
    log(f"[wsi] and [heatmap] done in {time.perf_counter() - t:.1f} s")
    # the headline variant of each kernel: the forward as serving and
    # evaluation run it (f32, no dropout), the backward as the training
    # CLI runs it (f32, --drop_out)
    main_variant = {"mil_pool_fwd": "B=32 N=4096 D=256 Da=256 float32 gated",
                    "mil_pool_bwd": "B=32 N=4096 D=256 Da=256 float32 gated "
                                    "dropout"}
    counter_of = {"mil_pool_fwd": "_fused_pool_cuda",
                  "mil_pool_bwd": "_fused_pool_bwd_cuda"}
    entries = []
    for name in ("mil_pool_fwd", "mil_pool_bwd"):
        head = timing[name][main_variant[name]]
        entry = dict(KERNELS[name],
                     launches=train_launches[counter_of[name]],
                     max_abs_err=head["max_abs_err"], ms=head["ms"],
                     plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                     bound_by=head["bound_by"], library_ms=None,
                     shape=main_variant[name], variants=timing[name],
                     radio_shape=timing_radio[name])
        if name == "mil_pool_fwd":
            entry["launches_serving"] = serve_launches["_fused_pool_cuda"]
            entry["cublas_product_ms"] = head["cublas_product_ms"]
        for path, counts in list(omic_launches.items()) + list(
                pretrained_launches.items()):
            entry[f"launches_{path}"] = counts[counter_of[name]]
        for arm, counts in bf16step_launches.items():
            entry[f"launches_bf16step_{arm.replace(' ', '_')}"] = counts[
                counter_of[name]]
        if name == "mil_pool_bwd":
            entry["bf16step"] = bf16step
        for path, counts in radio_launches.items():
            entry[f"launches_radio_{path}"] = counts[counter_of[name]]
        for path, counts in h5_launches.items():
            entry[f"launches_h5_{path}"] = counts[counter_of[name]]
        for path, counts in interpret_launches.items():
            entry[f"launches_interpret_{path}"] = counts[counter_of[name]]
        for path, counts in extract_launches.items():
            entry[f"launches_extract_{path}"] = counts[counter_of[name]]
        for path, counts in gradcam_launches.items():
            entry[f"launches_gradcam_{path}"] = counts[counter_of[name]]
        # per rank of the two on the card, one list entry each
        for path, counts in dist_launches.items():
            entry[f"launches_dist_{path}"] = counts[counter_of[name]]
        for path, counts in ops_launches.items():
            entry[f"launches_ops_{path}"] = counts[counter_of[name]]
        for path, counts in report_launches.items():
            entry[f"launches_report_{path}"] = counts[counter_of[name]]
        for path, counts in wsi_launches.items():
            entry[f"launches_wsi_{path}"] = counts[counter_of[name]]
        for path, counts in heatmap_launches.items():
            entry[f"launches_heatmap_{path}"] = counts[counter_of[name]]
        if name == "mil_pool_fwd":
            entry["heatmap_slide_bags"] = heatmap_timing
        entries.append(entry)
    log(f"[timing] train step ms {json.dumps(step)}")
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(f"nvidia-smi: {_card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
