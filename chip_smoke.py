#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every hand-written CUDA kernel of the port from the sources in
`mrfa_tpu_torch/csrc/` (nvcc, sm_90a, one process per source, all at once)
and runs these phases; any failure exits non-zero:

  1. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, in f32 and bf16: the lookup forward at the serving, the
     training, the reconstruction chunk's and the 4-stream server's query
     counts (bit-exact in f32) and at one count that is
     no multiple of its block's eight queries, the lookup backward at the
     training ones, the splat at the shapes of the training step's feature
     warps on noisy, smooth, wild and collapsing flows (its bins equal to
     `splat_bins_plain`'s as sets), the pooled lookup backward at the
     probes' query counts, the streaming probe (f32, both variants) at both
     probes' BQ 4096 and 16384 and on 48x48 maps (each level ending in a
     partial stage), bit-exact, its machine code (bulk copies, no per-thread
     cp.async) and its rate after an L2 flush (above the memory rate fails:
     bytes were skipped);
  2. the frame step on the card against the port's CPU path, at a small
     config, with TF32 off, with and without `prior_only`; and under the
     bf16 policy (every module's output dtype equal on both, the frames
     within the policy's tolerance);
  3. the serving paths at full width: config/vox1.yaml's MTIA model at
     256 px, B=1, random weights from a seed — `Animator.begin`, warm-up
     frames, back-to-back frames (frames/s), then one request at a time from
     host frame to host image (latency p50/p90) — in f32, then under the bf16
     policy (its frames against the f32 frames of the same inputs, and the
     bf16 gate: on smooth, textured and white-noise clips, the policy and a
     control that rounds every warp's sampling coordinates to bf16, against
     f32), then
     `animate_chunk` in f32 and bf16 (K=4, a CUDA graph of the frame step,
     equal to the frame-by-frame frames),
     `make_animation_from_best_frame`, and the `prior_only` model; each path
     with the kernels' launch counts read from its own run alone (6 lookups
     a frame, none under `prior_only`, no backward kernel);
  4. one training step on the card against the port's CPU path, at a small
     config, from the same weights and the same equivariance transform;
  5. the training path at full width: the same model, batch 10, smooth
     synthetic frames from a seed, warm-up and timed `Trainer.step`s (ms per
     step, samples/s, peak memory), with the launch counts of this run alone
     checked against the expected 6 lookups, 6 lookup backwards and 17
     splats a step (and 22 launches of the splat's two binning kernels);
  6. a learning check: 20 steps on one fixed batch at the small config;
  7. each kernel timed with CUDA events at its main path's largest shape,
     beside its plain version, a library yardstick and its bound (the larger
     of bytes over the memory rate and operations over the f32 rate), the
     lookup also at the serving BQ 4096 and the reconstruction BQ 32768,
     the streaming probe at BQ 4096 and 16384 beside a same-bytes library
     read (`l0.sum(); l1.sum()`) and, at 16384, back to back without the
     flush;
     the splat at all six shapes and the lookup at all twelve query counts,
     with the sums of launches x ms against launches x bound, training per
     step, serving per frame and reconstruction per chunk
     (`mrfa_tpu_torch/tools/kernel_times.py`);
  8. a torch.profiler breakdown of a few frames (f32 and bf16), of one
     `animate_chunk` call of each (its traced lookup kernels equal to the
     graph's counted launches) and of one training step;
  9. the probes of the pooled lookup (`mrfa_tpu_torch.tools.probe_lookup`
     and `probe_stream`, at their default sizes), with the launch counts of
     the pooled backward and the streaming kernels read from them alone;
 10. the run entry point's paths at full width, each with its own launch
     counts, on in-memory clips (smooth frames from the seed): `loop.train`
     on config/celebvhq.yaml (background predictor on, batch 10, 2 epochs
     of 3 steps, a checkpoint each; the loop's epoch lines, ms/step, peak
     memory; the bg term finite, the predictor moved; the epoch-0
     checkpoint restored bit for bit, and epoch 1 run again from it), the
     `.pth` import of the trained model, `loop.train` on config/vox1.yaml
     (TokenPose cut to 2 layers, 2 steps), one training step with the
     predictor on the card against the CPU at 64 px (as phase 4),
     `evals.reconstruction` (64 px against the CPU; then 2 clips of 12
     frames at 256 px in chunks of 8: frames/s, phase clocks, finite
     metrics) and `evals.animate` (8 frames, equal to
     `Animator.make_animation`);
 11. the multi-stream server (`serving.AnimationServer`): on the card
     against the CPU at the small config (S=3 different sources, with and
     without the per-stream scale, `serve` and `serve_chunk` K=2); then at
     full width (config/vox1.yaml's MTIA model, 256 px, random weights from
     the seed) for S = 1, 4 and 8 streams in f32 and bf16: `open_streams`,
     back-to-back `serve` steps (stream-frames/s), one call at a time from
     host frames to host images (p50/p90), `serve_chunk` K=4 (its CUDA
     graph, equal to `serve` frame by frame), busy ms a step, each stream
     against a lone `Animator`, 6 lookups a step and, in f32, `serve` with
     cuDNN's autotuner on;
 12. the FOMM and TPSM priors: the frame step and one training step on the
     card against the CPU at the small config (TPSM with its channel
     dropout and its detector's keypoints spread), then each on config/vox1.yaml with `prior_model` overridden
     at full width: `Animator` serving as in phase 3, and `Trainer` steps at
     batch 10 (TPSM with epoch 0's dropout): ms/step, peak memory and the
     6 / 6 / 17 / 22 launches a step;
 13. training under the bf16 policy (`Trainer(compute_dtype=torch.bfloat16)`,
     f32 master weights): one step on the card against the CPU's bf16 step
     at phase 4's setup, within twice the CPU's own bf16-to-f32 distance
     measured in this run; config/vox1.yaml's model at full width, batch 10,
     phase 5's steps (ms/step, samples/s, peak memory, 6 / 6 / 17 / 22
     launches a step, every parameter moved, gradients and Adam moments
     f32); phase 6's learning check in f32 and bf16 from the same weights,
     both falling, the bf16 loss near the f32 one;
 14. the data path from files: the host codec's build (or why it does not
     build), a PNG dataset written by the port (32 training clips of 16
     frames at 256 px), `FramesDataset` + `BatchLoader` samples/s with the
     config's workers and the decoders that served, `loop.train` on vox1
     under `compute_dtype: bf16` from the files (ms/step, seconds a step
     waits on the loader) beside the same loop on in-memory clips, and a
     resume from its checkpoint;
 15. the CLIs: `convert_backbones` on random torchvision-shaped state dicts
     (read back by `weights/`), `convert` on a reference-format `.pth` of
     the full-width model, `demo` from the converted checkpoint on PNG
     inputs (32 driving frames; plain and `--find_best_frame`): frames/s,
     6 lookups a frame, the frames equal to `Animator.make_animation`'s;
 16. `utils.profiling` on the card: `trace` and `annotate` around 2 bf16
     training steps (the spans and the port's kernels, in bf16, in the
     trace; the cuDNN FFT-convolution share beside the f32 step's of phase
     8), `StepTimer` against CUDA events;
 17. more than one device: (a) a one-rank NCCL world in this process and
     its data mesh (`parallel.mesh`), config/vox1.yaml at 256 px, batch 10,
     bf16 policy: the mesh `Trainer`'s step against a plain `Trainer`'s
     from the same weights (within twice the card's own run-to-run spread),
     then timed steps (ms/step beside phase 13b's, peak memory, 6 / 6 / 17
     / 22 launches a step); (b) two ranks on the one card over gloo (NCCL
     refuses two ranks on one GPU), spawned right after phase 1, while this
     process holds little of the card's memory: at phase 4's setup each rank's
     step against a one-process card step on the global batch with phase
     4's tolerances and the ranks' weights equal, then 256 px bf16 at 5
     rows a rank (ms/step: gloo through the host, not NCCL between cards)
     and each rank's launches; (c) `AnimationServer(devices=["cuda:0",
     "cuda:0"])` at S=8 against the one-device server (f32 `serve` within
     1e-4; bf16 `serve` and `serve_chunk` K=4 within phase 11b's mean gate,
     stream-frames/s beside phase 11b's S=8), 6 lookups a step on each
     device. A run over several GPUs is not verified;
 18. the 'model' mesh axis: two ranks on the one card over gloo on a 1x2
     ("data", "model") mesh, spawned right after phase 17b, each holding the
     whole batch and half of each sample's correlation queries: (a) at
     phase 4's setup in f32, the sharded eval forward against a one-process
     forward (1e-5), one sharded `Trainer` step against the one-process card
     step with phase 17b's gates, the ranks' weights and buffers bit-equal;
     (b) config/vox1.yaml at 256 px, the sharded f32 forward at B=1 against
     the one-process forward (1e-4), then bf16 `Trainer` steps at batch 10
     (ms/step, each rank's peak memory beside a one-process step's, 6 / 6 /
     17 / 22 launches a step on each rank, the weights and buffers
     bit-equal after them); the lookup's and its backward's query counts,
     read at the wrappers, half of the one-process ones.

Stdout ends with a `{"kernels": [...], "sums": {...}}` line, the card's name and power limit
(as nvidia-smi reports them) and, last, `{"ok": true, "device": {...}}`.
TF32 is off throughout (cuDNN and matmul): the port runs at f32.
"""
from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

FRAME_SIZE = 256
WARMUP_FRAMES = 3
TIMED_FRAMES = 20  # back-to-back throughput frames
LATENCY_FRAMES = 100  # one request at a time: p90 has 10 samples beyond it
MAP_SIZE = 64  # level-0 maps are (size/4)^2
LOOKUP_BQS = (64, 256, 1024, 4096)  # the six serving iterations' query counts, B=1
TRAIN_BATCH = 10  # per card: vox1.yaml's batch_size 80 is the global batch of 8 GPUs
TRAIN_LOOKUP_BQS = (640, 2560, 10240, 40960)  # the same, B=10
EVAL_LOOKUP_BQS = (512, 2048, 8192, 32768)  # a reconstruction chunk's, frame_batch 8
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 10
LEARN_STEPS = 20
# splats: the context and flow_w warps of all 6 pyramid levels and the coarse
# warps of the 5 levels the decode reads (kernel_times.SPLAT_SHAPES); the 11
# splats onto images of more than ops.splat.DIRECT_PIXELS pixels (32 px and
# up) bin their samples with two kernels first
PER_STEP = {"corr_lookup": 6, "corr_lookup_bwd": 6, "splat": 17, "splat_bins": 22}
PROBE_BQS = (256, 1024, 4096, 16384)  # the lookup probe's default query counts
STREAM_BQ = 4096  # the stream probe's
STREAM_QB = 16  # queries per block of the TPU probe's streaming
# the stream probe's maps in phase 1: BQ and side; 48x48 maps (rows of 192
# and 96 bytes) end each level in a partial stage of the kernel's ring
STREAM_SHAPES = ((STREAM_BQ, MAP_SIZE), (16384, MAP_SIZE), (STREAM_BQ, 48))
CHUNK = 4  # frames per animate_chunk call
BF16_MEAN_TOL = 0.02  # bf16 frames against f32, mean abs (tests/test_precision.py)
# The bf16 gate's clips: the side of the random grid each one's frames are
# upsampled from (None: white noise), and the gate on each: max abs of the
# bf16 frames against the f32 frames. The policy must pass it and its
# control (every warp's sampling coordinates rounded to bf16, the geometry
# the policy keeps in f32) must not. Readings on an H100 (PERF.md), policy /
# control: smooth 0.126 / 0.363, textured 0.063 / 0.189, noise 0.311 / 0.533;
# each gate sits near the geometric mean of its two. Noise gets no gate (the
# control moves its max only 1.7x), nor does mean abs (1.3-1.6x on each).
BF16_CLIPS = {"smooth": 8, "textured": 32, "noise": None}
BF16_CLIP_FRAMES = 4
BF16_GATE = {"smooth": 0.2, "textured": 0.11, "noise": None}
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


FAILED = []  # gates whose failure leaves the later phases meaningful


def check_later(cond: bool, msg: str) -> None:
    """A gate that fails the run at its end, after the other phases."""
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        FAILED.append(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), elementwise, in f32."""
    import torch

    a = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def close(got, want, dtype, what: str):
    """f32: within 1e-6 of the largest |value| (same terms, order and
    roundings as the plain version); bf16: within one bf16 ulp of each value.
    Returns (max abs error, tolerance)."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if dtype == torch.float32:
        tol = 1e-6 * max(float(want.float().abs().max()), 1e-30)
        ok = err <= tol
    else:
        ulp = bf16_ulp(want.float())
        tol = float(ulp.max())
        ok = bool((diff <= ulp).all())
    check(ok, f"{what}: max abs err {err:.3e} over tolerance")
    return err, tol


def phase_kernels(k, device):
    """Phase 1: each kernel against its plain version on the card."""
    import torch

    from mrfa_tpu_torch.ops.corr_lookup import (
        corr_lookup_bwd_plain,
        corr_lookup_plain,
        corr_lookup_pooled_bwd_plain,
    )
    from mrfa_tpu_torch.ops.cuda_build import find_nvcc
    from mrfa_tpu_torch.ops.splat import splat_bins_plain, splat_plain
    from mrfa_tpu_torch.ops.stream_probe import launch_plan, stream_probe_plain
    from mrfa_tpu_torch.tools.kernel_times import (
        FLOWS,
        HBM_BYTES_PER_S,
        SPLAT_SHAPES,
        TRAIN_BATCH,
        cuda_ms,
        lookup_inputs,
        make_flush,
        splat_inputs,
        stream_bytes,
        stream_levels,
    )

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst = {"corr_lookup": 0.0, "corr_lookup_bwd": 0.0, "splat": 0.0}
        # the main paths' query counts, and one that is no multiple of the
        # kernel's eight queries a block
        for i, bq in enumerate(LOOKUP_BQS + TRAIN_LOOKUP_BQS + EVAL_LOOKUP_BQS
                               + (SERVER_BQ, 4099)):
            c0, c1, coords = lookup_inputs(bq, dtype, device, seed=SEED + i)
            got = k["corr_lookup"](c0, c1, coords)
            want = corr_lookup_plain(c0, c1, coords)
            torch.cuda.synchronize()
            check(got.shape == (bq, 98) and got.dtype == dtype, f"lookup shape/dtype {got.shape}")
            err, tol = close(got, want, dtype, f"corr_lookup {name} bq={bq}")
            exact = int((got.float() != want.float()).sum())
            print(f"phase1 corr_lookup {name} bq={bq}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                  f"values not bit-equal: {exact} of {got.numel()}")
            check(torch.equal(got, want) or dtype == torch.bfloat16,
                  f"corr_lookup f32 bq={bq} not bit-exact")
            worst["corr_lookup"] = max(worst["corr_lookup"], err)
            if bq not in TRAIN_LOOKUP_BQS:
                continue
            g = torch.randn(bq, 98, device=device).to(dtype)
            got = k["corr_lookup_bwd"](c0, c1, coords, g)
            want = corr_lookup_bwd_plain(c0, c1, coords, g)
            torch.cuda.synchronize()
            for what, a, b in (("d_c0", got[0], want[0]), ("d_c1", got[1], want[1])):
                check(a.shape == b.shape and a.dtype == dtype, f"lookup bwd {what} shape/dtype")
                err, tol = close(a, b, dtype, f"corr_lookup_bwd {name} bq={bq} {what}")
                print(f"phase1 corr_lookup_bwd {name} bq={bq} {what}: max_abs_err={err:.3e} "
                      f"(tol {tol:.3e})")
                worst["corr_lookup_bwd"] = max(worst["corr_lookup_bwd"], err)
            # d_coords: f32 sums of 98 terms in another order than torch.sum
            err = float((got[2] - want[2]).abs().max())
            tol = 1e-5 * max(1.0, float(want[2].abs().max()))
            print(f"phase1 corr_lookup_bwd {name} bq={bq} d_coords: max_abs_err={err:.3e} "
                  f"(tol {tol:.3e})")
            check(err <= tol, f"corr_lookup_bwd d_coords {name} bq={bq}: {err}")
            worst["corr_lookup_bwd"] = max(worst["corr_lookup_bwd"], err)
            far = slice(2 * (bq // 8), 2 * (bq // 8) + 4)
            check(not got[0][far].any() and not got[2][far].any(),
                  "far-out centres must give zero map and coordinate gradients")
        for j, (res, c) in enumerate(SPLAT_SHAPES):
            for flow in FLOWS:
                args, _, _ = splat_inputs(res, c, dtype, device, seed=SEED + 100 + j, flow=flow)
                got = k["splat"](*args)
                want = splat_plain(*args)
                torch.cuda.synchronize()
                check(got.shape == (TRAIN_BATCH, res, res, c) and got.dtype == torch.float32,
                      f"splat shape/dtype {got.shape}")
                # f32 sums in another order than index_add_: the JAX package's
                # own hardware gate (bench.py), max |kernel - plain| / max |plain|
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                # the bins as sets per tile: sort the kernel's within each bin
                counts, members = k["splat"].bins(args[1], args[4], res, res)
                want_counts, want_members = splat_bins_plain(args[1], args[4], res, res)
                total = args[1].numel()
                bin_ids = torch.repeat_interleave(
                    torch.arange(counts.numel(), device=device), counts)
                same_bins = bool(torch.equal(counts, want_counts)) and bool(torch.equal(
                    (bin_ids * total + members).sort().values % total, want_members))
                print(f"phase1 splat {name} {flow} B={TRAIN_BATCH} n={res * res} c={c} "
                      f"h=w={res}: max_abs_err={err:.3e} rel={rel:.3e} (tol rel 1e-4); "
                      f"{members.numel()} bin entries ({members.numel() / total:.3f} a sample, "
                      f"largest bin {int(counts.max())}), equal to splat_bins_plain: {same_bins}")
                check(rel <= 1e-4, f"splat {name} {flow} res={res}: rel err {rel}")
                check(same_bins, f"splat bins {flow} res={res} differ from splat_bins_plain")
                worst["splat"] = max(worst["splat"], err)
                del args, got, want
        worst["corr_lookup_pooled_bwd"] = 0.0
        for i, bq in enumerate(PROBE_BQS):
            corr, _, coords = lookup_inputs(bq, dtype, device, seed=SEED + 200 + i)
            g = torch.randn(bq, 98, device=device).to(dtype)
            got = k["corr_lookup_pooled_bwd"](corr, coords, g)
            want = corr_lookup_pooled_bwd_plain(corr, coords, g)
            torch.cuda.synchronize()
            check(got[0].shape == corr.shape and got[0].dtype == dtype
                  and got[1].shape == (bq, 2), "pooled bwd shape/dtype")
            # d_corr depends on g and the fractions alone: bit-exact in f32,
            # one rounding of the same f32 sum in bf16
            err, tol = close(got[0], want[0], dtype, f"corr_lookup_pooled_bwd {name} bq={bq}")
            exact = bool(torch.equal(got[0], want[0]))
            check(exact or dtype == torch.bfloat16, f"pooled bwd f32 d_corr not bit-exact bq={bq}")
            # d_coords: f32 sums of 98 terms in another order than torch.sum
            dc_err = float((got[1] - want[1]).abs().max())
            dc_tol = 2e-5 * max(1.0, float(want[1].abs().max()))
            print(f"phase1 corr_lookup_pooled_bwd {name} bq={bq}: d_corr max_abs_err={err:.3e} "
                  f"(tol {tol:.3e}) bit_exact={exact}; d_coords max_abs_err={dc_err:.3e} "
                  f"(tol {dc_tol:.3e}, max |d_coords| {float(want[1].abs().max()):.3e})")
            check(dc_err <= dc_tol, f"pooled bwd d_coords {name} bq={bq}: {dc_err}")
            far = slice(2 * (bq // 8), 2 * (bq // 8) + 4)
            check(not got[0][far].any() and not got[1][far].any(),
                  "far-out centres must give zero map and coordinate gradients")
            worst["corr_lookup_pooled_bwd"] = max(worst["corr_lookup_pooled_bwd"], err, dc_err)
        errs[dtype] = worst
    # the streaming probe (f32 only): its machine code holds the bulk copy
    # (UBLKCP) and no per-thread cp.async (LDGSTS); both variants bit-exact
    # at the probes' BQs, and on 48x48 maps, whose levels end in a partial
    # stage; then its rate after an L2 flush, which above the memory rate
    # means skipped bytes
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(k["stream_probe"].library.target)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    bulk, per_thread = sass.count("UBLKCP"), sass.count("LDGSTS")
    print(f"phase1 stream_probe SASS: {bulk} UBLKCP, {per_thread} LDGSTS")
    check(bulk >= 1 and per_thread == 0, "stream_probe must stream with bulk copies alone")
    flush = make_flush(device)
    for i, (bq, size) in enumerate(STREAM_SHAPES):
        levels = stream_levels(bq, device, seed=SEED + 300 + i, size=size)
        plan = launch_plan([tuple(lv.shape) for lv in levels], 1)
        for second in (levels[1], None):
            got = k["stream_probe"](levels[0], second, bq, STREAM_QB)
            want = stream_probe_plain(levels[0], second, bq, STREAM_QB)
            torch.cuda.synchronize()
            variant = "l0+l1" if second is not None else "l0"
            err = float((got - want).abs().max())
            print(f"phase1 stream_probe float32 bq={bq} {size}x{size} qb={STREAM_QB} {variant}: "
                  f"shape={tuple(got.shape)} bit_exact={bool(torch.equal(got, want))}; last "
                  f"stage rows {[lv.last_rows for lv in plan.levels]} of "
                  f"{[lv.stage_rows for lv in plan.levels]}")
            check(torch.equal(got, want), f"stream_probe {variant} bq={bq} {size}x{size} "
                                          f"not bit-exact: {err}")
        if size == MAP_SIZE:
            ms = cuda_ms(lambda: k["stream_probe"](*levels, bq, STREAM_QB), 5, flush)
            rate = stream_bytes(bq, levels) / (ms * 1e-3)
            print(f"phase1 stream_probe float32 bq={bq}: {ms:.5f} ms after a flush, "
                  f"{rate / 1e9:.1f} GB/s")
            check(rate <= HBM_BYTES_PER_S, f"stream_probe bq={bq} streams {rate / 1e9:.1f} GB/s, "
                                           "above the memory rate: bytes were skipped")
        del levels, got, want
    errs[torch.float32]["stream_probe"] = 0.0
    return errs


def small_cfg(size=64, blocks=3, depth=1, losses=False, prior="mtia"):
    """The flagship MTIA model cut to 64 px, 3-block hourglasses and a 1-layer
    TokenPose; every width as in config/vox1.yaml. With `losses`, the
    training losses of vox1.yaml cut to scales [1, 0.25]. `prior` selects
    the FOMM or TPSM prior instead, its sections (vox1.yaml's) cut to the
    same hourglass depth."""
    cfg = {
        "train_params": {"prior_model": prior, "num_epochs": 100, "bg_start": 1000},
        "dense_motion": {
            "block_expansion": 64, "max_features": 1024, "num_blocks": blocks,
            "scale_factor": 0.25, "num_kp": 10, "num_channels": 3,
            "estimate_occlusion_map": True,
        },
        "mtia_kp_detector": {"MODEL": {
            "ESTIMATE_JACOBIAN": True, "TRANSFORMER_DEPTH": depth, "TRANSFORMER_HEADS": 8,
            "DIM": 192, "NUM_JOINTS": 10, "PATCH_SIZE": [4, 4], "IMAGE_SIZE": [size, size],
            "BASE_CHANNEL": 32, "TRANSFORMER_MLP_RATIO": 3,
        }},
        "raft_flow": {
            "prior_only": False, "num_kp": 10, "dim": 256, "size": size,
            "generator": {"num_channels": 3, "block_expansion": 64, "max_features": 512,
                          "num_up_blocks": 5},
            "driving_encoder": {"in_features": 10, "block_expansion": 32,
                                "max_features": 512, "num_blocks": blocks},
            "source_encoder": {"in_features": 13, "block_expansion": 32,
                               "max_features": 512, "num_blocks": blocks},
        },
    }
    if losses:
        cfg["train_params"].update({
            "scales": [1, 0.25],
            "loss_weights": {"perceptual": [10] * 5, "equivariance": 10,
                             "equivariance_jacobian": 10},
            "transform_params": {"sigma_affine": 0.05, "sigma_tps": 0.005, "points_tps": 5},
            "lr": 2.0e-4, "epoch_milestones": [60, 90], "clip_grad": True, "clip": 10,
        })
    full = vox1_cfg()
    for key in ("fomm_kp_detector", "tpsm_kp_detector", "tpsm_dense_motion"):
        cfg[key] = full[key]
        if "num_blocks" in cfg[key]:
            cfg[key]["num_blocks"] = blocks
    if prior == "tpsm" and losses:
        cfg["train_params"]["loss_weights"]["equivariance_jacobian"] = 0  # vox1.yaml: 0 for tpsm
    return cfg


def smooth_frames(b: int, size: int, gen, device, side: int = 8):
    """(B, size, size, 3) low-frequency frames in [0, 1]: side x side random
    images bilinearly upsampled, made on `device` from the generator."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand(b, 3, side, side, generator=gen, device=device)
    img = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=True)
    return img.permute(0, 2, 3, 1).contiguous()


def condition_prior(model, prior: str) -> None:
    """Spread the random TPSM detector's keypoints: its ResNet-18 head's
    bias, drawn from the seed, puts each keypoint at its own place in
    [-0.7, 0.7]^2 (sigmoid * 2 - 1 of the logit). Left at its random
    initialization, the head puts all 50 keypoints near the origin, some
    pairs 4e-4 apart, and the TPS fit through a group's five is then ill
    conditioned: the CPU's own f32 frame sits 3.0e-2 from its f64 frame
    (see PERF.md). The FOMM detector's keypoints are spread already (0.15
    apart or more at the training check's inputs) and stay as drawn."""
    import torch

    if prior != "tpsm":
        return
    fc = model.encoder.fg_encoder.fc
    u = torch.rand(fc.bias.shape, generator=torch.Generator().manual_seed(SEED + 70))
    u = 1.4 * u - 0.7
    with torch.no_grad():
        fc.bias.copy_(torch.log((1 + u) / (1 - u)))


def phase_gpu_vs_cpu(prior_only: bool = False, prior: str = "mtia"):
    """Phase 2: the frame step on the card against the port's CPU path (and
    phase 12a: the same under the FOMM or TPSM prior, the TPSM detector's
    keypoints spread by `condition_prior`), within 1e-4."""
    import torch

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = small_cfg(prior=prior)
    cfg["raft_flow"]["prior_only"] = prior_only
    torch.manual_seed(SEED)
    cpu_model = MRFA(cfg, device="cpu")
    condition_prior(cpu_model, prior)
    weights = cpu_model.state_dict()
    on_cpu = Animator(cpu_model, weights, device="cpu")
    on_gpu = Animator(MRFA(cfg), weights)
    rng = np.random.RandomState(SEED + 1)
    source = rng.rand(64, 64, 3).astype(np.float32)
    driving = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = on_cpu.animate_frame(on_cpu.begin(source, driving[0]), driving[1])
    got = on_gpu.animate_frame(on_gpu.begin(source, driving[0]), driving[1])
    torch.cuda.synchronize()
    tol = 1e-4  # outputs in [0, 1]; f32 on both sides, sums in other orders
    label = "phase2" if prior == "mtia" else f"phase12a {prior}"
    for name, g, w in zip(("generated", "warped", "occlusion"), got, want):
        err = float((g.cpu() - w).abs().max())
        print(f"{label} frame gpu-vs-cpu{' prior_only' * prior_only} {name}: "
              f"shape={tuple(g.shape)} max_abs_err={err:.3e} (tol {tol:.0e})")
        check(g.shape == w.shape and err <= tol, f"GPU frame step disagrees with CPU: {name}")


def module_dtypes(animator, source, driving) -> dict:
    """The output dtypes of every module of one frame step, by module name
    (dict outputs by key)."""
    import torch

    got = {}

    def record(name):
        def hook(module, args, out):
            items = out.items() if isinstance(out, dict) else enumerate(
                out if isinstance(out, (tuple, list)) else [out])
            for key, t in items:
                if torch.is_tensor(t):
                    got.setdefault(f"{name}:{key}", set()).add(str(t.dtype))
        return hook

    hooks = [m.register_forward_hook(record(n)) for n, m in animator.model.named_modules() if n]
    try:
        animator.animate_frame(animator.begin(source, driving[0]), driving[1])
    finally:
        for h in hooks:
            h.remove()
    return got


def phase_gpu_vs_cpu_bf16():
    """Phase 2b: the bf16 policy on the card against the port's CPU path, at
    the small config: every module's output dtype equal (the CPU's are held
    to the JAX package's by tests/test_torch_serving.py), and the frames
    within the policy's tolerance of each other."""
    import torch

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = small_cfg()
    torch.manual_seed(SEED)
    weights = MRFA(cfg, device="cpu").state_dict()
    on_cpu = Animator(MRFA(cfg, device="cpu", compute_dtype=torch.bfloat16), weights,
                      device="cpu")
    on_gpu = Animator(MRFA(cfg, compute_dtype=torch.bfloat16), weights)
    rng = np.random.RandomState(SEED + 1)
    source = rng.rand(64, 64, 3).astype(np.float32)
    driving = rng.rand(2, 64, 64, 3).astype(np.float32)
    want, got = (module_dtypes(a, source, driving) for a in (on_cpu, on_gpu))
    differ = {k: (want.get(k), got.get(k)) for k in set(want) | set(got) if want.get(k) != got.get(k)}
    bf16 = sum("torch.bfloat16" in v for v in got.values())
    print(f"phase2 bf16 gpu-vs-cpu: {len(got)} module outputs, {bf16} of them bf16, "
          f"{len(differ)} dtypes differ")
    check(not differ and bf16 > 100, f"bf16 module dtypes differ between card and CPU: {differ}")
    frame = [a.animate_frame(a.begin(source, driving[0]), driving[1])[0].cpu()
             for a in (on_cpu, on_gpu)]
    err = (frame[0] - frame[1]).abs()
    print(f"phase2 bf16 frame gpu-vs-cpu generated: mean_abs={float(err.mean()):.3e} "
          f"max_abs={float(err.max()):.3e} (tol mean {BF16_MEAN_TOL})")
    check(float(err.mean()) < BF16_MEAN_TOL, "bf16 frame on the card far from the CPU's")


def vox1_cfg():
    from mrfa_tpu_torch.config import load_config, model_config

    return model_config(load_config(str(Path(__file__).resolve().parent / "config" / "vox1.yaml")))


def reset(kernels):
    for k in kernels.values():
        k.launches = 0
    kernels["splat"].bin_launches = 0


def launch_counts(kernels) -> dict:
    """Launches by kernel; "splat_bins" counts the splat's binning kernels."""
    return {**{name: k.launches for name, k in kernels.items()},
            "splat_bins": kernels["splat"].bin_launches}


def serving_clip():
    """The source, the host frames and the first frames copied to the card:
    smooth images (8x8 noise upsampled), since a warp of white noise turns
    any sub-pixel change of the motion into a large change of pixels."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 2)
    n_dev = WARMUP_FRAMES + TIMED_FRAMES
    images = smooth_frames(1 + n_dev + LATENCY_FRAMES, FRAME_SIZE, gen, "cpu").numpy()
    source, frames = images[0], images[1:]
    frames_dev = [torch.from_numpy(f).cuda() for f in frames[:n_dev]]
    torch.cuda.synchronize()
    return source, frames, frames_dev


def full_width_animator(compute_dtype=None, prior_only=False, weights=None):
    """An Animator of config/vox1.yaml's MTIA model on the card, random
    weights from the seed (or `weights`); returns it and its build seconds."""
    import torch

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = vox1_cfg()
    cfg["raft_flow"]["prior_only"] = prior_only
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    model = MRFA(cfg, compute_dtype=compute_dtype)
    animator = Animator(model, model.state_dict() if weights is None else weights)
    torch.cuda.synchronize()
    return animator, time.perf_counter() - t0


def _serve(animator, clip, kernels, label: str, lookups_per_frame: int):
    """Drive one serving path: `Animator.begin`, warm-up frames and
    back-to-back frames already on the card (frames/s), then one request at
    a time from host frame to host image (latency), with the launch counts
    of this run alone. Returns (numbers, the clip state, the generated
    frames as numpy)."""
    import torch

    source, frames, frames_dev = clip
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    state = animator.begin(source, frames[0])
    torch.cuda.synchronize()
    begin_ms = (time.perf_counter() - t0) * 1e3
    outs = [animator.animate_frame(state, f)[0] for f in frames_dev[:WARMUP_FRAMES]]
    # throughput: frames already on the card, dispatched back to back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames_dev[WARMUP_FRAMES:]:
        outs.append(animator.animate_frame(state, f)[0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    # latency: one request at a time, host frame in, host image out
    lat_ms, host_outs = [], []
    for f in frames[len(frames_dev):]:
        t0 = time.perf_counter()
        host_outs.append(animator.animate_frame(state, f)[0].cpu().numpy())
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    n_frames = len(frames)
    check(launches["corr_lookup"] == lookups_per_frame * n_frames,
          f"{label}: corr_lookup launches {launches['corr_lookup']} != "
          f"{lookups_per_frame} x {n_frames} frames")
    check(all(v == 0 for name, v in launches.items() if name != "corr_lookup"),
          f"{label} launched another kernel than the lookup: {launches}")
    outs = [o.cpu().numpy() for o in outs] + host_outs
    check(outs[-1].shape == (1, FRAME_SIZE, FRAME_SIZE, 3) and outs[-1].dtype == np.float32,
          f"{label}: output shape {outs[-1].shape} {outs[-1].dtype}")
    for o in outs:
        check(bool(np.isfinite(o).all()), f"{label}: non-finite output")
        check(float(o.min()) >= 0.0 and float(o.max()) <= 1.0, f"{label}: output outside [0, 1]")
    check(float(np.abs(outs[-1] - outs[-2]).max()) > 0,
          f"{label}: frames do not depend on the driving frame")
    numbers = {
        "begin_ms": begin_ms, "frames_timed": TIMED_FRAMES, "fps": TIMED_FRAMES / elapsed,
        "ms_per_frame": elapsed / TIMED_FRAMES * 1e3, "latency_frames": len(lat_ms),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p90": float(np.percentile(lat_ms, 90)),
        "latency_ms_max": float(np.max(lat_ms)),
        "peak_memory_bytes": peak, "resident_before_bytes": resident,
        "launches": launches, "frames_total": n_frames,
    }
    return numbers, state, outs


def phase_serving(kernels, card, clip):
    """Phase 3: the f32 serving path at full width."""
    animator, build_s = full_width_animator()
    numbers, state, outs = _serve(animator, clip, kernels, "serving", 6)
    result = {"phase": "serving", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
              "batch": 1, "dtype": "float32", "tf32": False, "card": card,
              "model_build_s": build_s, **numbers}
    print("phase3 " + json.dumps(result))
    return animator, state, outs, numbers["launches"]


def phase_serving_bf16(kernels, card, clip, f32_animator, f32_outs):
    """Phase 3b: the bf16 policy at full width, from the f32 path's weights,
    its frames held against the f32 frames of the same inputs."""
    import torch

    from mrfa_tpu_torch.ops.resize import antialias_downsample

    weights = {k: v.clone() for k, v in f32_animator.model.state_dict().items()}
    animator, build_s = full_width_animator(torch.bfloat16, weights=weights)
    del weights
    numbers, state, outs = _serve(animator, clip, kernels, "serving_bf16", 6)
    diffs = [np.abs(a - b) for a, b in zip(outs, f32_outs)]
    mean = float(np.mean([d.mean() for d in diffs]))
    worst = float(max(d.max() for d in diffs))
    # the source keypoints of both (normalized coordinates in [-1, 1])
    kp = [a.encode_kp(clip[0])["kp"].float() for a in (f32_animator, animator)]
    # RaftFlow alone under the policy, from the f32 model's keypoints and
    # dense motion: the setting of the JAX package's own bf16 test
    # (tests/test_precision.py)
    with torch.inference_mode():
        m32, m16 = f32_animator.model, animator.model
        src, drv = (f32_animator._image(x) for x in (clip[0], clip[1][1]))
        kp_s, kp_d = m32.encode_kp(src), m32.encode_kp(drv)
        dm = m32.run_dense_motion(src, kp_d, kp_s)
        down = antialias_downsample(src, 0.25)
        dec = [m.decoder(m.kp_for_decoder(kp_s), m.kp_for_decoder(kp_d), dm, down, src)[0].float()
               for m in (m32, m16)]
    result = {"phase": "serving_bf16", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
              "batch": 1, "compute_dtype": "bfloat16", "tf32": False, "card": card,
              "model_build_s": build_s, **numbers,
              "vs_f32_mean_abs": mean, "vs_f32_max_abs": worst,
              "vs_f32_mean_abs_tol": BF16_MEAN_TOL,
              "source_kp_vs_f32_max_abs": float((kp[0] - kp[1]).abs().max()),
              "decoder_alone_vs_f32_mean_abs": float((dec[0] - dec[1]).abs().mean()),
              "decoder_alone_vs_f32_max_abs": float((dec[0] - dec[1]).abs().max()),
              "gate": bf16_gate(f32_animator, animator)}
    print("phase3b " + json.dumps(result))
    check_later(mean < BF16_MEAN_TOL, f"bf16 frames sit {mean} (mean abs) from the f32 frames")
    return animator, state, outs, numbers["launches"]


@contextlib.contextmanager
def bf16_sampling_coords():
    """The bf16 gate's control: every warp of the port rounds its sampling
    coordinates to bf16, the geometry stream that the policy keeps in f32."""
    from mrfa_tpu_torch.ops import sampler

    plain = sampler.warp_pixels

    def rounded(img, ix, iy, zero_oob=True):
        return plain(img, ix.bfloat16().float(), iy.bfloat16().float(), zero_oob)

    sampler.warp_pixels = rounded
    try:
        yield
    finally:
        sampler.warp_pixels = plain


def bf16_gate(f32_animator, animator) -> dict:
    """The bf16 policy's frames and the control's against the f32 frames, on
    a short clip of each texture of BF16_CLIPS (made from the seed): mean and
    max abs. Where a clip has a gate, the policy's max abs must pass it and
    the control's must not."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 3)
    readings = {}
    for kind, side in BF16_CLIPS.items():
        n = BF16_CLIP_FRAMES + 1
        frames = (torch.rand(n, FRAME_SIZE, FRAME_SIZE, 3, generator=gen) if side is None
                  else smooth_frames(n, FRAME_SIZE, gen, "cpu", side)).numpy()

        def run(a):
            state = a.begin(frames[0], frames[1])
            return np.stack([a.animate_frame(state, f)[0].cpu().numpy() for f in frames[1:]])

        f32 = run(f32_animator)
        policy = run(animator)
        with bf16_sampling_coords():
            control = run(animator)
        row = {"side": side, "frames": BF16_CLIP_FRAMES, "gate": BF16_GATE[kind]}
        for name, out in (("policy", policy), ("control", control)):
            row[f"{name}_mean_abs"] = float(np.abs(out - f32).mean())
            row[f"{name}_max_abs"] = float(np.abs(out - f32).max())
        readings[kind] = row
        gate = BF16_GATE[kind]
        if gate is not None:
            check_later(row["policy_max_abs"] <= gate < row["control_max_abs"],
                        f"bf16 gate on {kind} frames: policy {row['policy_max_abs']}, "
                        f"control {row['control_max_abs']}, gate {gate} (max abs)")
    return readings


def phase_chunk(kernels, animator, state, clip, frame_outs, label: str):
    """Phase 3c: `animate_chunk` of K=4 frames over the timed frames of
    `_serve` (a CUDA graph of the frame step, captured at the first chunk),
    equal to that run's frame-by-frame frames of the same clip state."""
    import torch

    from mrfa_tpu_torch.animate import FrameGraph

    _, _, frames_dev = clip
    stack = torch.stack(frames_dev[WARMUP_FRAMES:])  # (TIMED_FRAMES, H, W, 3)
    torch.cuda.synchronize()
    reset(kernels)
    animator.animate_chunk(state, stack[:CHUNK])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = [animator.animate_chunk(state, stack[i:i + CHUNK])
              for i in range(0, TIMED_FRAMES, CHUNK)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts(kernels)
    got = torch.cat(chunks).cpu().numpy()  # (TIMED_FRAMES, 1, H, W, 3)
    want = np.stack(frame_outs[WARMUP_FRAMES:WARMUP_FRAMES + TIMED_FRAMES])
    check(got.shape == want.shape, f"chunk shape {got.shape} != {want.shape}")
    err = float(np.abs(got - want).max())
    # frame steps: the timed and warm-up frames, and the eager steps before
    # the graph's capture (each graph replay counts its captured launches)
    n_frames = TIMED_FRAMES + CHUNK + FrameGraph.WARMUP_STEPS
    result = {"phase": label, "chunk": CHUNK, "frames_timed": TIMED_FRAMES,
              "fps": TIMED_FRAMES / elapsed, "ms_per_frame": elapsed / TIMED_FRAMES * 1e3,
              "vs_frame_by_frame_max_abs": err, "launches": launches, "frames_total": n_frames}
    print("phase3c " + json.dumps(result))
    check_later(err == 0.0, f"{label}: chunked frames differ from the frame-by-frame ones by {err}")
    check(launches["corr_lookup"] == 6 * n_frames, f"{label} lookups {launches}")
    return launches


def phase_best_frame(kernels, animator, clip):
    """Phase 3d: `make_animation_from_best_frame` over a 4-frame clip whose
    third frame is the source itself (so it is the best frame)."""
    source, frames, _ = clip
    video = np.concatenate([frames[1:3], source[None], frames[3:4]])
    reset(kernels)
    t0 = time.perf_counter()
    out = animator.make_animation_from_best_frame(source, video)
    elapsed = time.perf_counter() - t0
    launches = launch_counts(kernels)
    best = animator.find_best_frame(source, video)
    check(best == 2, f"best frame {best}, not the source's copy (2)")
    check(len(out) == len(video), f"{len(out)} frames for {len(video)}")
    for o in out:
        check(o.shape == (FRAME_SIZE, FRAME_SIZE, 3) and bool(np.isfinite(o).all()),
              "best-frame animation output")
    # frame steps: 3 backward from the best frame, 2 forward from it
    steps = (best + 1) + (len(video) - best)
    result = {"phase": "best_frame", "frames": len(video), "best": best, "seconds": elapsed,
              "launches": launches, "frame_steps": steps}
    print("phase3d " + json.dumps(result))
    check(launches["corr_lookup"] == 6 * steps, f"best-frame lookups {launches}")
    return launches


def phase_prior_only(kernels, card, clip):
    """Phase 3e: the `prior_only` model at full width: no refinement, so
    no lookup."""
    animator, build_s = full_width_animator(prior_only=True)
    numbers, _, _ = _serve(animator, clip, kernels, "prior_only", 0)
    result = {"phase": "prior_only", "config": "config/vox1.yaml mtia, prior_only",
              "size": FRAME_SIZE, "batch": 1, "dtype": "float32", "tf32": False, "card": card,
              "model_build_s": build_s, **numbers}
    print("phase3e " + json.dumps(result))
    return numbers["launches"]


def _trainer_pair_step(cfg, seed, n_gpu=1):
    """A Trainer on the CPU and `n_gpu` on the card with the same weights
    (the TPSM detector's spread by `condition_prior`), the same equivariance
    transforms and dropout masks (the same CPU generator seeds), and a
    batch."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(seed)
    on_cpu = Trainer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    condition_prior(on_cpu.model, cfg["train_params"]["prior_model"])
    if hasattr(on_cpu.model, "bg_predictor"):
        # off the identity init, so that the bg term is not zero at the first step
        with torch.no_grad():
            fc = on_cpu.model.bg_predictor.bg_encoder.fc.weight
            fc.copy_(0.01 * torch.randn(fc.shape, generator=torch.Generator().manual_seed(seed)))
    on_gpu = []
    for _ in range(n_gpu):
        weights = {k: v.clone() for k, v in on_cpu.model.state_dict().items()}
        on_gpu.append(Trainer(cfg, generator=torch.Generator().manual_seed(seed + 1),
                              weights=weights))
    batch = {k: smooth_frames(2, 64, torch.Generator().manual_seed(seed + i), "cpu")
             for i, k in enumerate(("source", "driving"), start=2)}
    return on_cpu, on_gpu, batch


def phase_train_gpu_vs_cpu(use_bg: bool = False, prior: str = "mtia"):
    """Phase 4: one training step on the card against the port's CPU path:
    loss terms (rtol 1e-4), the generated frames, every gradient (before
    Adam, after clipping) and the BatchNorm running statistics. With
    `use_bg` (phase 10c), the same with the background predictor on: its
    term among the losses, its gradients and statistics among the rest.
    With `prior` (phase 12a), the same under the FOMM or TPSM prior; under
    TPSM with the channel dropout on (p 0.1, epoch 0's), both trainers
    drawing the same masks from their dropout generators' equal seeds.

    The randomly initialized network in train mode is sensitive at f32: a
    1e-6 change of its input moves deep gradients by tens of percent (see
    PERF.md). So beside 1e-3 of each tensor's largest |g| (1e-4 and 1e-5 for
    the frames and the statistics), the card may differ from the CPU by
    twice as much as the CPU's own step moves when the input frames move by
    1e-6 (the largest of three such moves). Under a prior it may also differ
    by twice as much as the card's step moves when cuDNN is off (PyTorch's
    own convolutions on the card): under FOMM, cuDNN's convolution
    algorithms move the gradients of the decoder's keypoint hourglass, whose
    largest |g| is ~1e-4, by up to 21% of it, where the card without cuDNN
    and every 1e-6 move of the CPU's inputs or keypoints stay inside the
    floor (see PERF.md). A fault of the port's kernels or modules moves both
    card steps alike, so it still shows against the CPU."""
    import torch

    cfg = small_cfg(losses=True, prior=prior)
    if use_bg:
        cfg["train_params"]["bg_start"] = 0
    label = ("phase10c train bg" if use_bg else "phase4 train") if prior == "mtia" else (
        f"phase12a {prior} train")
    dropout = {"dropout_flag": prior == "tpsm", "dropout_p": 0.1}
    on_cpu, on_gpus, batch = _trainer_pair_step(cfg, SEED + 20, n_gpu=1 + (prior != "mtia"))
    on_gpu = on_gpus[0]
    want = on_cpu.step(batch, use_bg=use_bg, **dropout)
    got = on_gpu.step(batch, use_bg=use_bg, **dropout)
    card_twin = None
    if prior != "mtia":
        with torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            on_gpus[1].step(batch, use_bg=use_bg, **dropout)
        card_twin = dict(on_gpus[1].model.named_parameters())
    floors = []
    for i in range(3):
        noisy, _, _ = _trainer_pair_step(cfg, SEED + 20, n_gpu=0)
        gen = torch.Generator().manual_seed(SEED + 30 + i)
        moved = {k: v + 1e-6 * torch.randn(v.shape, generator=gen) for k, v in batch.items()}
        floors.append((noisy, noisy.step(moved, use_bg=use_bg, **dropout)))

    def floor(fn):
        return 2 * max(fn(trainer, out) for trainer, out in floors)

    terms = (["loss", "perceptual", "equivariance"] + ["equivariance_jacobian"] * (prior != "tpsm")
             + ["bg"] * use_bg)
    check(sorted(got) == sorted(terms + ["gen"]), f"loss terms {sorted(got)}")
    for k in terms:
        rel = abs(got[k] - want[k]) / abs(want[k])
        print(f"{label} gpu-vs-cpu {k}: gpu={got[k]:.7f} cpu={want[k]:.7f} "
              f"rel_err={rel:.3e} (tol 1e-4)")
        check(np.isfinite(got[k]) and rel <= 1e-4, f"train step loss {k} disagrees: {rel}")
    gen_err = float((got["gen"].cpu() - want["gen"]).abs().max())
    gen_tol = max(1e-4, floor(lambda t, o: float((o["gen"] - want["gen"]).abs().max())))
    print(f"{label} gpu-vs-cpu generated: max_abs_err={gen_err:.3e} (tol {gen_tol:.3e})")
    check(gen_err <= gen_tol, "train step generated frames disagree")
    cpu_p = dict(on_cpu.model.named_parameters())
    floor_p = [dict(t.model.named_parameters()) for t, _ in floors]
    worst, n_grads, n_floor, n_twin, twin_beyond = (0.0, ""), 0, 0, [], []
    widest = (0.0, "")  # the largest err / max |g|
    for name, p in on_gpu.model.named_parameters():
        if p.grad is None:
            continue
        check(bool(torch.isfinite(p.grad).all()), f"gradient of {name} not finite")
        n_grads += 1
        w = cpu_p[name].grad
        scale = max(float(w.abs().max()), 1e-30)
        err = float((p.grad.cpu() - w).abs().max())
        noise = 2 * max(float((fp[name].grad - w).abs().max()) for fp in floor_p)
        tol = max(1e-3 * scale, noise)
        if card_twin is not None:
            twin_err = float((card_twin[name].grad.cpu() - w).abs().max())
            twin_beyond += [name] * (twin_err > tol)
            if err > tol:
                tol = max(tol, 2 * float((card_twin[name].grad - p.grad).abs().max()))
                n_twin.append(name)
        check(err <= tol, f"gradient of {name}: err {err:.3e} > tol {tol:.3e}")
        worst = max(worst, (err / tol, name))
        n_floor += err > 1e-3 * scale
        if scale >= 1e-5:  # not the ~0 gradients of biases that BatchNorm follows
            widest = max(widest, (err / scale, name))
    print(f"{label} gpu-vs-cpu gradients: {n_grads} tensors, {n_floor} of them beyond "
          f"1e-3 of their max |g| and inside their floor; worst err / tol = "
          f"{worst[0]:.3e} ({worst[1]}); widest err / max |g| (max |g| >= 1e-5) = "
          f"{widest[0]:.3e} ({widest[1]})" + (
              f"; {len(n_twin)} beyond the CPU's floor, inside the cuDNN-off floor: "
              f"{n_twin[:6]}; the cuDNN-off step itself: {len(twin_beyond)} beyond the "
              f"CPU's floor {twin_beyond[:6]}" if card_twin is not None else ""))
    cpu_state = on_cpu.model.state_dict()
    floor_state = [t.model.state_dict() for t, _ in floors]
    worst = 0.0
    for key, t in on_gpu.model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            err = float((t.cpu() - cpu_state[key]).abs().max())
            noise = 2 * max(float((fs[key] - cpu_state[key]).abs().max()) for fs in floor_state)
            check(err <= max(1e-5, noise), f"BatchNorm statistic {key}: err {err:.3e}")
            worst = max(worst, err)
    print(f"{label} gpu-vs-cpu BatchNorm running statistics: max_abs_err={worst:.3e}")


def phase_train_full_width(kernels, card):
    """Phase 5: the training path at full width; returns (trainer, batch,
    launch counts, result)."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    trainer = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = [{k: smooth_frames(TRAIN_BATCH, FRAME_SIZE, gen, "cuda")
                for k in ("source", "driving")} for _ in range(n_steps)]
    before = [p.detach().clone() for p in trainer.optimizer.param_groups[0]["params"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    losses = [trainer.step(b) for b in batches[:TRAIN_WARMUP_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.step(b) for b in batches[TRAIN_WARMUP_STEPS:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    for name, per_step in PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"{name} launches {launches[name]} != {per_step} x {n_steps} steps")
    for out in losses:
        check(all(np.isfinite(out[k]) for k in out if k != "gen"), f"non-finite loss {out}")
    moved = sum(float((p.detach() - q).abs().max() > 0)
                for p, q in zip(trainer.optimizer.param_groups[0]["params"], before))
    check(moved == len(before), f"only {moved} of {len(before)} parameter tensors changed")
    result = {
        "phase": "train_full_width", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
        "batch": TRAIN_BATCH, "dtype": "float32", "tf32": False, "card": card,
        "checkpointing": False, "model_build_s": build_s,
        "steps_timed": TRAIN_TIMED_STEPS, "ms_per_step": elapsed / TRAIN_TIMED_STEPS * 1e3,
        "samples_per_s": TRAIN_BATCH * TRAIN_TIMED_STEPS / elapsed,
        "peak_memory_bytes": peak, "launches": launches, "steps_total": n_steps,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "loss_first": losses[0]["loss"], "loss_last": losses[-1]["loss"],
    }
    print("phase5 " + json.dumps(result))
    return trainer, batches[-1], launches, result


def phase_learning():
    """Phase 6: 20 steps on one fixed batch at the small config, lr 1e-3."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = small_cfg(losses=True)
    cfg["train_params"]["lr"] = 1e-3
    torch.manual_seed(SEED + 40)
    trainer = Trainer(cfg, generator=torch.Generator().manual_seed(SEED + 41))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    batch = {k: smooth_frames(2, 64, gen, "cuda") for k in ("source", "driving")}
    losses = [trainer.step(batch)["loss"] for _ in range(LEARN_STEPS)]
    check(all(np.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    start, end = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    drop = 1.0 - end / start
    print(f"phase6 learning: {LEARN_STEPS} steps, mean of first 3 {start:.5f}, of last 3 "
          f"{end:.5f}, drop {drop:.3%}; the >= 30% drop of tests/test_learning.py is "
          f"{'met' if drop >= 0.3 else 'NOT met'}; losses "
          + json.dumps([round(v, 5) for v in losses]))
    check(end < start, "the loss did not go down on a fixed batch")
    return drop


def phase_probes(kernels, device):
    """Phase 9: both probes of the pooled lookup at their default sizes, with
    the launch counts of this run alone, and their errors against the plain
    gather oracle (the CPU test's bounds)."""
    from mrfa_tpu_torch.tools import probe_lookup, probe_stream

    reset(kernels)
    rows = probe_lookup.run("both", probe_lookup.DEFAULT_BQS, device)
    stream_rows = probe_stream.run(STREAM_BQ, device)
    launches = launch_counts(kernels)
    print("phase9 " + json.dumps({"probe_lookup": rows, "probe_stream": stream_rows,
                                  "launches": launches}))
    for row in rows:
        check(all(np.isfinite(v) for k, v in row.items() if k != "fn"), f"probe row {row}")
        if row["fn"] == "fwd pooled":
            check_later(row["max_err"] <= 2e-5, f"pooled forward against the oracle: {row}")
        else:
            check_later(row["err_dcorr"] <= 1e-5 and row["err_dcoords"] <= 1e-4,
                        f"pooled backward against the oracle: {row}")
    calls = probe_lookup.N_CALLS
    # the lookup probe: a warm-up, one call per input set and one checked
    # call for each BQ; the stream probe: a warm-up and one call per set
    want = {"corr_lookup_pooled_bwd": len(probe_lookup.DEFAULT_BQS) * (calls + 2) + calls + 1,
            "stream_probe": 2 * (calls + 1)}
    for name, n in want.items():
        check(launches[name] == n, f"probe launches of {name}: {launches[name]} != {n}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the run entry point (loop, checkpoints, evals) at full width

LOOP_STEPS = 3  # steps an epoch of the celebvhq run
LOOP_CLIPS = 30  # training clips: 3 batches of 10
EVAL_FRAME_BATCH = 8
EVAL_CLIPS, EVAL_FRAMES = 2, 12  # two chunks a clip, the second padded
ANIMATE_FRAMES = 8
EPOCH_LINE = re.compile(r"^epoch (\d+): (\d+) steps in ([\d.]+)s \(([\d.]+) samples/s\)$")


class ClipDataset:
    """`FramesDataset`'s item contract over in-memory clips (the card
    machine has no image decoder, and no dataset is in the repository):
    a training item is two frames of a clip picked by `rng` (sorted), a test
    item the whole clip (its first frame with `read_first_frame`)."""

    def __init__(self, clips: np.ndarray, is_train: bool, seed: int = SEED):
        self.clips = clips  # (N, T, H, W, 3) float32 in [0, 1]
        self.videos = [f"clip{i:03d}" for i in range(len(clips))]
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        self.pairs_list = None
        self.read_first_frame = False

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int) -> dict:
        clip = self.clips[idx]
        out = {"name": self.videos[idx]}
        if self.is_train:
            i, j = np.sort(self.rng.choice(len(clip), replace=True, size=2))
            out.update(source=clip[i], driving=clip[j])
        else:
            out["video"] = clip[:1] if self.read_first_frame else clip
        return out


def smooth_clips(n: int, t: int, size: int, seed: int) -> np.ndarray:
    """(n, t, size, size, 3) clips of smooth frames made from a seed."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return smooth_frames(n * t, size, gen, "cpu").numpy().reshape(n, t, size, size, 3)


class Tee:
    """stdout that is also kept, to read the loop's own epoch lines."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def epochs(self):
        found = [EPOCH_LINE.match(line) for line in "".join(self.lines).splitlines()]
        return [tuple(float(x) for x in m.groups()) for m in found if m]


def run_config(name: str) -> dict:
    from mrfa_tpu_torch.config import load_config

    return load_config(str(Path(__file__).resolve().parent / "config" / f"{name}.yaml"))


def _run_loop(kernels, cfg, dataset, log_dir, checkpoint=None, max_steps=LOOP_STEPS):
    """`loop.train` with the counts of this run alone: (trainer, launches,
    epoch lines (epoch, steps, seconds, samples/s), peak bytes, seconds)."""
    import torch

    from mrfa_tpu_torch.train.loop import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        trainer = train(cfg, checkpoint, str(log_dir), dataset, seed=SEED,
                        max_steps_per_epoch=max_steps, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (trainer, launch_counts(kernels), tee.epochs(), torch.cuda.max_memory_allocated(),
            seconds)


def _check_launches(launches, steps: int, label: str) -> None:
    for name, per_step in PER_STEP.items():
        check(launches[name] == per_step * steps,
              f"{label}: {name} launches {launches[name]} != {per_step} x {steps} steps")


def _state_equal(got, want, path="") -> int:
    """Bit-equality of two saved states (tensors on any device); returns the
    number of tensors compared."""
    import torch

    check(type(got) is type(want), f"checkpoint {path}: {type(got)} vs {type(want)}")
    if isinstance(want, dict):
        check(list(got) == list(want), f"checkpoint {path}: keys differ")
        return sum(_state_equal(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"checkpoint {path}: lengths differ")
        return sum(_state_equal(g, w, f"{path}/{i}") for i, (g, w) in enumerate(zip(got, want)))
    if torch.is_tensor(want):
        check(got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()),
              f"checkpoint {path}: tensors differ")
        return 1
    check(got == want, f"checkpoint {path}: {got} != {want}")
    return 0


def phase_loop_celebvhq(kernels, card, work: Path):
    """Phase 10a: `loop.train` on config/celebvhq.yaml (background predictor
    on from epoch 0) at full width, batch 10, 2 epochs of 3 steps, a
    checkpoint each; the epoch-0 checkpoint restored (every saved tensor
    bit-equal) and epoch 1 run again from it. Returns (the trained trainer,
    its config, the launch counts of each run)."""
    import shutil

    import torch

    from mrfa_tpu_torch.config import model_config
    from mrfa_tpu_torch.train.trainer import Trainer
    from mrfa_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = run_config("celebvhq")
    cfg["train_params"].update(batch_size=TRAIN_BATCH, num_epochs=2, checkpoint_freq=1,
                               num_repeats=1, num_workers=1)
    clips = smooth_clips(LOOP_CLIPS, 2, FRAME_SIZE, SEED + 50)
    trainer, launches, epochs, peak, seconds = _run_loop(
        kernels, cfg, ClipDataset(clips, True), work / "celebvhq")
    steps = 2 * LOOP_STEPS
    _check_launches(launches, steps, "loop celebvhq")
    check([e[:2] for e in epochs] == [(0, LOOP_STEPS), (1, LOOP_STEPS)], f"epoch lines {epochs}")
    lines = (work / "celebvhq" / "log.txt").read_text().splitlines()
    terms = [dict(t.split(" - ") for t in line.split(") ", 1)[1].split("; ")) for line in lines]
    check(len(terms) == 2 and all("bg" in t for t in terms), f"log lines {lines}")
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()), f"log lines {lines}")
    fc = trainer.model.bg_predictor.bg_encoder.fc
    moved = float(fc.weight.detach().abs().max())
    check(moved > 0, "the bg predictor did not move from its identity init")
    ckpt = work / "celebvhq" / "ckpt"
    check(sorted(p.name for p in ckpt.iterdir()) == ["0", "1"], "checkpoints 0 and 1")
    vis = sorted(p.name for p in (work / "celebvhq" / "train-vis").iterdir())
    check(vis == ["00000000-rec.png", "00000001-rec.png"], f"train-vis {vis}")
    ms_per_step = epochs[1][2] / epochs[1][1] * 1e3  # the warm epoch

    # checkpoint save and restore times, and the restore bit-equal
    t0 = time.perf_counter()
    saved, _ = restore_checkpoint(str(ckpt), 0)
    restore_s = time.perf_counter() - t0
    fresh = Trainer(model_config(cfg), steps_per_epoch=LOOP_STEPS)
    t0 = time.perf_counter()
    fresh.load_state_dict(saved["trainer"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_tensors = _state_equal(fresh.state_dict(), saved["trainer"])
    check(fresh.steps == LOOP_STEPS and saved["epoch"] == 0, "the epoch-0 checkpoint's step")
    t0 = time.perf_counter()
    save_checkpoint(str(work / "save_timing"), {"trainer": fresh.state_dict(), "epoch": 0}, 0)
    save_s = time.perf_counter() - t0
    ckpt_bytes = (ckpt / "0" / "state.pt").stat().st_size
    del fresh, saved
    shutil.rmtree(work / "save_timing")

    # resume from the epoch-0 checkpoint alone: epoch 1 runs again
    shutil.copytree(ckpt / "0", work / "resume" / "ckpt" / "0")
    resumed, resume_launches, resume_epochs, _, _ = _run_loop(
        kernels, cfg, ClipDataset(clips, True), work / "resume", str(work / "resume" / "ckpt"))
    _check_launches(resume_launches, LOOP_STEPS, "loop celebvhq resumed")
    check([e[:2] for e in resume_epochs] == [(1, LOOP_STEPS)], f"resumed epochs {resume_epochs}")
    check(resumed.steps == 2 * LOOP_STEPS, f"resumed step count {resumed.steps}")
    straight = dict(trainer.model.named_parameters())
    resume_diff = max(float((p - straight[n]).abs().max())
                      for n, p in resumed.model.named_parameters())
    del resumed
    result = {
        "phase": "loop_celebvhq", "config": "config/celebvhq.yaml mtia, bg from epoch 0",
        "size": FRAME_SIZE, "batch": TRAIN_BATCH, "epochs": 2, "steps_per_epoch": LOOP_STEPS,
        "card": card, "tf32": False, "loop_seconds": seconds, "epoch_lines": epochs,
        "ms_per_step_epoch1": ms_per_step, "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "loss_terms": terms, "bg_fc_weight_max_abs": moved,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s, "trainer_load_s": load_s,
        "restored_tensors_bit_equal": n_tensors, "resumed_launches": resume_launches,
        "resumed_epoch_lines": resume_epochs,
        "resumed_vs_straight_params_max_abs": resume_diff,
    }
    print("phase10a " + json.dumps(result))
    return trainer, cfg, {"loop_celebvhq": launches, "loop_celebvhq_resumed": resume_launches}


def phase_loop_vox1(kernels, card, work: Path):
    """Phase 10b: `loop.train` on config/vox1.yaml (no background
    predictor), its TokenPose cut to 2 layers, one epoch of 2 steps."""
    cfg = run_config("vox1")
    cfg["mtia_kp_detector"]["MODEL"]["TRANSFORMER_DEPTH"] = 2
    cfg["train_params"].update(batch_size=TRAIN_BATCH, num_epochs=1, num_repeats=1,
                               num_workers=1)
    clips = smooth_clips(2 * TRAIN_BATCH, 2, FRAME_SIZE, SEED + 51)
    trainer, launches, epochs, peak, seconds = _run_loop(
        kernels, cfg, ClipDataset(clips, True), work / "vox1", max_steps=2)
    _check_launches(launches, 2, "loop vox1")
    check(not hasattr(trainer.model, "bg_predictor") and trainer.optimizer_bg is None,
          "vox1 builds no bg predictor")
    line = (work / "vox1" / "log.txt").read_text().splitlines()
    check(len(line) == 1 and "bg" not in line[0], f"log line {line}")
    check(sorted(p.name for p in (work / "vox1" / "ckpt").iterdir()) == ["0"], "checkpoint 0")
    result = {"phase": "loop_vox1", "config": "config/vox1.yaml mtia, TokenPose depth 2",
              "size": FRAME_SIZE, "batch": TRAIN_BATCH, "steps": 2, "card": card,
              "loop_seconds": seconds, "epoch_lines": epochs, "peak_memory_bytes": peak,
              "launches": launches, "log_line": line[0]}
    print("phase10b " + json.dumps(result))
    return launches


def _recon_config(cfg: dict) -> dict:
    cfg = dict(cfg)
    cfg["reconstruction_params"] = {"num_videos": None, "format": ".mp4",
                                    "frame_batch": EVAL_FRAME_BATCH}
    cfg["visualizer_params"] = {"draw_border": True, "colormap": "gist_rainbow"}
    return cfg


def phase_reconstruction_gpu_vs_cpu(work: Path):
    """Phase 10d (small): `evals.reconstruction` at 64 px on the card and on
    the CPU from the same weights: the generated frames (tol 1e-4, as phase
    2) and the metrics (rtol 1e-4)."""
    import torch

    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = _recon_config(small_cfg())
    torch.manual_seed(SEED)
    cpu_model = MRFA(cfg, device="cpu")
    gpu_model = MRFA(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    dataset = ClipDataset(smooth_clips(1, EVAL_FRAMES, 64, SEED + 52), False)
    frames, results = {}, {}
    for name, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, "cuda")):
        hook = model.register_forward_hook(
            lambda m, a, out, name=name: frames.setdefault(name, []).append(out[0].cpu()))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the LPIPS fallback's warning
            results[name] = evals.reconstruction(cfg, model, str(work / f"recon64_{name}"),
                                                 dataset, device=device)
        hook.remove()
    err = float((torch.cat(frames["gpu"]) - torch.cat(frames["cpu"])).abs().max())
    rel = {k: abs(results["gpu"][k] - results["cpu"][k]) / abs(results["cpu"][k])
           for k in ("l1", "lpips", "psnr")}
    print(f"phase10d reconstruction gpu-vs-cpu 64 px: frames max_abs_err={err:.3e} (tol 1e-4); "
          f"metrics rel_err " + json.dumps(rel) + " (tol 1e-4)")
    check(err <= 1e-4, f"reconstruction frames on the card differ from the CPU's: {err}")
    check(all(r <= 1e-4 for r in rel.values()), f"reconstruction metrics differ: {rel}")


def phase_reconstruction(kernels, card, work: Path):
    """Phase 10d: `evals.reconstruction` of config/vox1.yaml's model at full
    width (random weights from the seed), 2 clips of 12 frames in chunks of
    8, visualizations on: frames/s, the phase clocks, the metrics finite."""
    import torch

    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = _recon_config(run_config("vox1"))
    torch.manual_seed(SEED)
    model = MRFA(cfg)
    dataset = ClipDataset(smooth_clips(EVAL_CLIPS, EVAL_FRAMES, FRAME_SIZE, SEED + 53), False)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the LPIPS fallback's warning
        results = evals.reconstruction(cfg, model, str(work / "recon"), dataset)
    seconds = time.perf_counter() - t0
    launches = launch_counts(kernels)
    chunks = EVAL_CLIPS * -(-EVAL_FRAMES // EVAL_FRAME_BATCH)
    check(launches["corr_lookup"] == 6 * chunks, f"reconstruction lookups {launches}")
    check(all(v == 0 for k, v in launches.items() if k != "corr_lookup"),
          f"reconstruction launched another kernel than the lookup: {launches}")
    check(results["frames"] == EVAL_CLIPS * EVAL_FRAMES, f"frames {results['frames']}")
    check(all(np.isfinite(results[k]) for k in ("l1", "lpips", "psnr")), f"metrics {results}")
    out_dir = work / "recon" / "reconstruction"
    written = sorted(str(p.relative_to(out_dir)) for p in out_dir.glob("*/*"))[:6]
    result = {"phase": "reconstruction", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
              "frame_batch": EVAL_FRAME_BATCH, "clips": EVAL_CLIPS, "chunks": chunks,
              "card": card, "seconds": seconds, "frames_per_s": results["frames"] / seconds,
              # the chunks after the first (which pays the cuDNN and kernel set-up)
              "device_ms_per_chunk": results["phase_wall"]["device"] / (chunks - 1) * 1e3,
              "results": results, "launches": launches, "lookups_per_chunk": 6,
              "written": written}
    print("phase10d " + json.dumps(result))
    return model, launches


def phase_animate(kernels, card, model, work: Path):
    """Phase 10e: `evals.animate` of one pair of 8 frames at full width; its
    frames bit-equal to `Animator.make_animation` on the same pair."""
    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.data.dataset import PairedDataset

    cfg = run_config("vox1")
    cfg["animate_params"]["num_pairs"] = 1
    dataset = ClipDataset(smooth_clips(1, ANIMATE_FRAMES, FRAME_SIZE, SEED + 54), False)
    frames = []

    class Recording(Animator):
        def animate_frame(self, clip_state, driving_frame):
            out = super().animate_frame(clip_state, driving_frame)
            frames.append(out[0][0].cpu().numpy())
            return out

    plain = evals.Animator
    evals.Animator = Recording
    reset(kernels)
    t0 = time.perf_counter()
    try:
        written = evals.animate(cfg, model, str(work / "animate"), dataset)
    finally:
        evals.Animator = plain
    seconds = time.perf_counter() - t0
    launches = launch_counts(kernels)
    check(launches["corr_lookup"] == 6 * ANIMATE_FRAMES, f"animate lookups {launches}")
    pair = PairedDataset(dataset, number_of_pairs=1)[0]
    want = Animator(model, model.state_dict()).make_animation(pair["source_video"][0],
                                                              pair["driving_video"])
    same = len(frames) == len(want) == ANIMATE_FRAMES and all(
        np.array_equal(g, w) for g, w in zip(frames, want))
    result = {"phase": "animate", "config": "config/vox1.yaml mtia", "frames": len(frames),
              "card": card, "seconds": seconds, "written": written, "launches": launches,
              "bit_equal_to_make_animation": same}
    print("phase10e " + json.dumps(result))
    check(same, "evals.animate frames differ from Animator.make_animation's")
    check(len(written) == 1 and Path(written[0]).exists(), f"animate wrote {written}")
    return launches


def phase_pth_import(trainer, cfg, work: Path):
    """Phase 10f: a reference-style `.pth` written from the trained
    celebvhq model's state dict (`module.` prefix, VGG19 convolutions under
    `vgg.slice<k>.<i>`, the anti-alias buffers and VGG19 mean/std beside),
    loaded through utils/checkpoint.py into a fresh model: no key missing
    or unexpected, every tensor equal."""
    import torch

    from mrfa_tpu_torch.config import model_config
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import load_torch_weights_into

    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    path = work / "reference.pth"
    parity_helpers().reference_pth(state, path)
    torch.manual_seed(SEED + 55)
    fresh = MRFA(model_config(cfg))
    t0 = time.perf_counter()
    missing, unexpected = load_torch_weights_into(fresh, str(path), verbose=False)
    seconds = time.perf_counter() - t0
    got = fresh.state_dict()
    differ = [k for k, v in state.items() if not k.endswith("num_batches_tracked")
              and not torch.equal(got[k].cpu(), v)]
    print("phase10f " + json.dumps({
        "phase": "pth_import", "model_keys": len(state), "bytes": path.stat().st_size,
        "load_s": seconds, "missing": missing, "unexpected": unexpected,
        "tensors_differ": differ[:8]}))
    check(not missing and not unexpected and not differ,
          f".pth import: missing {missing[:4]}, unexpected {unexpected[:4]}, differ {differ[:4]}")


SERVER_STREAMS = (1, 4, 8)
SERVER_BQ = 16384  # the server's full-resolution lookup at S=4 (S=8 gives 32768)
SERVER_WARMUP = 2
SERVER_TIMED = 8  # back-to-back steps, then 2 timed chunks of CHUNK of them
SERVER_LATENCY = 20  # one call at a time: p90 has 2 samples beyond it
SERVER_ANIMATOR_TOL = 1e-4  # f32 streams against a lone Animator: outputs in [0, 1]
PRIOR_WARMUP_STEPS = 1
PRIOR_TIMED_STEPS = 3


def phase_server_gpu_vs_cpu():
    """Phase 11a: the multi-stream server on the card against the port's CPU
    path at the small config, S=3 streams with different sources, with and
    without the per-stream movement scale: the scales, `serve` and
    `serve_chunk` (K=2, a CUDA graph on the card)."""
    import torch

    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.serving import AnimationServer

    cfg = small_cfg()
    torch.manual_seed(SEED)
    cpu_model = MRFA(cfg, device="cpu")
    weights = cpu_model.state_dict()
    on_cpu = AnimationServer(cpu_model, weights, device="cpu")
    on_gpu = AnimationServer(MRFA(cfg), weights)
    gen = torch.Generator().manual_seed(SEED + 50)
    sources = smooth_frames(3, 64, gen, "cpu").numpy()
    frames = smooth_frames(9, 64, gen, "cpu").numpy().reshape(3, 3, 64, 64, 3)
    tol = 1e-4  # outputs in [0, 1]; f32 on both sides, sums in other orders
    for adapt in (False, True):
        cpu_state = on_cpu.open_streams(sources, frames[0], adapt_movement_scale=adapt)
        gpu_state = on_gpu.open_streams(sources, frames[0], adapt_movement_scale=adapt)
        scale_err = float((gpu_state.scale.cpu() - cpu_state.scale).abs().max())
        serve_err = float((on_gpu.serve(gpu_state, frames[1]).cpu()
                           - on_cpu.serve(cpu_state, frames[1])).abs().max())
        chunk = on_gpu.serve_chunk(gpu_state, frames[1:]).cpu()
        chunk_err = float((chunk - on_cpu.serve_chunk(cpu_state, frames[1:])).abs().max())
        print(f"phase11a server gpu-vs-cpu S=3 adapt_scale={adapt}: scales "
              f"{gpu_state.scale.tolist()} max_abs_err={scale_err:.3e}; serve "
              f"max_abs_err={serve_err:.3e}; serve_chunk K=2 max_abs_err={chunk_err:.3e} "
              f"(tol {tol:.0e})")
        check(chunk.shape == (2, 3, 64, 64, 3), f"serve_chunk shape {tuple(chunk.shape)}")
        check(scale_err <= 1e-5 and serve_err <= tol and chunk_err <= tol,
              "the server on the card disagrees with the CPU")


def phase_server(kernels, card, weights, compute_dtype=None):
    """Phase 11b: the multi-stream server at full width (config/vox1.yaml's
    MTIA model at 256 px, `weights`) for S in SERVER_STREAMS streams with
    different smooth sources: `open_streams`, warm-up and back-to-back
    `serve` steps on frames already on the card (stream-frames/s), one call
    at a time from host frames to host images (p50/p90), two `serve_chunk`
    calls of K=4 (the CUDA graph, after its capture; equal to `serve` frame
    by frame), the busy ms a step from a profile, each stream's first frame
    against an `Animator` that runs it alone, and 6 lookups a step. Returns
    the launch counts by path and the results by path."""
    import torch

    from mrfa_tpu_torch.animate import Animator, FrameGraph
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.serving import AnimationServer

    name = dtype_name(compute_dtype or torch.float32)
    server = AnimationServer(MRFA(vox1_cfg(), compute_dtype=compute_dtype), weights)
    animator = Animator(MRFA(vox1_cfg(), compute_dtype=compute_dtype), weights)
    paths, results = {}, {}
    for n_streams in SERVER_STREAMS:
        label = f"server_s{n_streams}_{name}"
        gen = torch.Generator().manual_seed(SEED + 60 + n_streams)
        sources = smooth_frames(n_streams, FRAME_SIZE, gen, "cpu").numpy()
        n_dev = SERVER_WARMUP + SERVER_TIMED
        frames = smooth_frames((1 + n_dev + SERVER_LATENCY) * n_streams, FRAME_SIZE, gen,
                               "cpu").numpy().reshape(-1, n_streams, FRAME_SIZE, FRAME_SIZE, 3)
        frames_dev = torch.from_numpy(frames[1:1 + n_dev]).cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        state = server.open_streams(sources, frames[0])
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t0) * 1e3
        outs = [server.serve(state, f) for f in frames_dev[:SERVER_WARMUP]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs += [server.serve(state, f) for f in frames_dev[SERVER_WARMUP:]]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        lat_ms = []
        for f in frames[1 + n_dev:]:
            t0 = time.perf_counter()
            host = server.serve(state, f).cpu().numpy()
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        check(host.shape == (n_streams, FRAME_SIZE, FRAME_SIZE, 3) and bool(np.isfinite(host).all())
              and float(host.min()) >= 0.0 and float(host.max()) <= 1.0, f"{label}: host output")
        steps = n_dev + SERVER_LATENCY
        launches = launch_counts(kernels)
        check(launches["corr_lookup"] == 6 * steps,
              f"{label}: corr_lookup launches {launches['corr_lookup']} != 6 x {steps} steps")
        check(all(v == 0 for k, v in launches.items() if k != "corr_lookup"),
              f"{label} launched another kernel than the lookup: {launches}")
        paths[label] = launches
        peak = torch.cuda.max_memory_allocated()

        # the graph: a warm-up chunk (the capture), then the timed chunks
        stack = frames_dev[SERVER_WARMUP:]
        reset(kernels)
        server.serve_chunk(state, stack[:CHUNK])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = [server.serve_chunk(state, stack[i:i + CHUNK])
                  for i in range(0, SERVER_TIMED, CHUNK)]
        torch.cuda.synchronize()
        chunk_elapsed = time.perf_counter() - t0
        chunk_steps = SERVER_TIMED + CHUNK + FrameGraph.WARMUP_STEPS
        launches = launch_counts(kernels)
        check(launches["corr_lookup"] == 6 * chunk_steps, f"{label} chunk lookups {launches}")
        paths[label + "_chunk"] = launches
        chunk_err = float((torch.cat(chunks) - torch.stack(outs[SERVER_WARMUP:])).abs().max())
        check_later(chunk_err == 0.0, f"{label}: serve_chunk differs from serve by {chunk_err}")

        _, busy_ms, idle = _profile(lambda: server.serve(state, frames_dev[0]), 2,
                                    f"phase11b {label}", f"server_{label}_trace.json",
                                    by_op=label == "server_s4_float32")

        # each stream alone through an Animator, on its first served frame
        worst_max, worst_mean = 0.0, 0.0
        for s in range(n_streams):
            clip = animator.begin(sources[s], frames[0, s])
            alone = animator.animate_frame(clip, frames_dev[0, s])[0][0]
            diff = (alone - outs[0][s]).abs()
            worst_max, worst_mean = max(worst_max, float(diff.max())), max(worst_mean,
                                                                              float(diff.mean()))
        if compute_dtype is None:
            check(worst_max <= SERVER_ANIMATOR_TOL,
                  f"{label}: a stream differs from its lone Animator by {worst_max}")
        else:
            check(worst_mean <= BF16_MEAN_TOL,
                  f"{label}: a stream differs from its lone Animator by {worst_mean} mean")
        tuned = {}
        # in f32, `serve` with cuDNN's autotuner in place of its heuristics,
        # which put the S=4 step into the FFT-tiled convolution (see
        # PERF.md), and at S=4 with PyTorch's own convolutions (cuDNN off).
        # PyTorch caches a convolution's cuDNN plan by its shapes and its
        # `deterministic` flag, not by `benchmark`: the autotuned run sets
        # `deterministic` so that it tunes afresh instead of reusing the
        # heuristics' plans (forward convolutions all are deterministic).
        variants = {"autotuned": {"enabled": True, "benchmark": True, "deterministic": True}}
        if n_streams == 4:
            variants["cudnn_off"] = {"enabled": False, "benchmark": False,
                                     "deterministic": False}
        for variant, flags in variants.items() if compute_dtype is None else ():
            with torch.backends.cudnn.flags(**flags, allow_tf32=False):
                outs_v = [server.serve(state, f) for f in frames_dev[:SERVER_WARMUP]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs_v += [server.serve(state, f) for f in frames_dev[SERVER_WARMUP:]]
                torch.cuda.synchronize()
                v_elapsed = time.perf_counter() - t0
            v_err = max(float((a - b).abs().max()) for a, b in zip(outs_v, outs))
            check(v_err <= SERVER_ANIMATOR_TOL,
                  f"{label}: the {variant} step differs from the heuristic one by {v_err}")
            tuned.update({f"{variant}_serve_ms_per_step": v_elapsed / SERVER_TIMED * 1e3,
                          f"{variant}_serve_stream_frames_per_s": n_streams * SERVER_TIMED
                          / v_elapsed, f"{variant}_vs_serve_max_abs": v_err})
            del outs_v
        result = {
            "phase": "server", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
            "streams": n_streams, "dtype": name, "tf32": False, "card": card,
            "open_streams_ms": open_ms, "steps_timed": SERVER_TIMED,
            "serve_ms_per_step": elapsed / SERVER_TIMED * 1e3,
            "serve_stream_frames_per_s": n_streams * SERVER_TIMED / elapsed,
            "latency_steps": len(lat_ms),
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p90": float(np.percentile(lat_ms, 90)),
            "latency_ms_max": float(np.max(lat_ms)),
            "chunk": CHUNK, "chunk_ms_per_step": chunk_elapsed / SERVER_TIMED * 1e3,
            "chunk_stream_frames_per_s": n_streams * SERVER_TIMED / chunk_elapsed,
            "chunk_vs_serve_max_abs": chunk_err,
            "busy_ms_per_step": busy_ms, "idle_share": idle,
            "vs_lone_animator_max_abs": worst_max, "vs_lone_animator_mean_abs": worst_mean,
            "lookup_bq_full_res": n_streams * (FRAME_SIZE // 4) ** 2,
            "lookups_per_step": paths[label]["corr_lookup"] / steps,
            "peak_memory_bytes": peak, **tuned,
        }
        print("phase11b " + json.dumps(result))
        results[label] = result
        del state, outs, chunks, frames_dev, stack
    del server, animator
    torch.cuda.empty_cache()
    return paths, results


def prior_cfg(prior: str) -> dict:
    """config/vox1.yaml with `prior_model` overridden (under TPSM the
    jacobian equivariance off, as vox1.yaml notes)."""
    cfg = vox1_cfg()
    cfg["train_params"]["prior_model"] = prior
    if prior == "tpsm":
        cfg["train_params"]["loss_weights"]["equivariance_jacobian"] = 0
    return cfg


def phase_prior(kernels, card, clip, prior: str):
    """Phase 12b: the FOMM or TPSM prior at full width (config/vox1.yaml,
    256 px, random weights from the seed): `Animator` serving as phase 3
    drives it (frames/s, latency, 6 lookups a frame), then `Trainer` steps
    at batch 10 (TPSM with the channel dropout of epoch 0, p 0.1): ms/step,
    peak memory and 6 / 6 / 17 / 22 launches a step. Returns the launch
    counts by path."""
    import torch

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.train.loop import epoch_phase
    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = prior_cfg(prior)
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    model = MRFA(cfg)
    animator = Animator(model, model.state_dict())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    numbers, _, _ = _serve(animator, clip, kernels, f"{prior} serving", 6)
    print("phase12b " + json.dumps({
        "phase": f"{prior}_serving", "config": f"config/vox1.yaml {prior}", "size": FRAME_SIZE,
        "batch": 1, "dtype": "float32", "tf32": False, "card": card, "model_build_s": build_s,
        **numbers}))
    paths = {f"{prior}_serving": numbers["launches"]}
    del animator, model
    torch.cuda.empty_cache()

    _, dropout_flag, dropout_p = epoch_phase(cfg["train_params"], 0)
    check(dropout_flag == (prior == "tpsm"), f"{prior}: epoch 0 dropout {dropout_flag}")
    torch.manual_seed(SEED)
    trainer = Trainer(cfg, generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    n_steps = PRIOR_WARMUP_STEPS + PRIOR_TIMED_STEPS
    batches = [{k: smooth_frames(TRAIN_BATCH, FRAME_SIZE, gen, "cuda")
                for k in ("source", "driving")} for _ in range(n_steps)]
    before = [p.detach().clone() for p in trainer.optimizer.param_groups[0]["params"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    kw = {"dropout_flag": dropout_flag, "dropout_p": dropout_p}
    losses = [trainer.step(b, **kw) for b in batches[:PRIOR_WARMUP_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.step(b, **kw) for b in batches[PRIOR_WARMUP_STEPS:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    for name, per_step in PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"{prior} training: {name} launches {launches[name]} != {per_step} x {n_steps}")
    for out in losses:
        check(all(np.isfinite(out[k]) for k in out if k != "gen"), f"non-finite loss {out}")
    check(("equivariance_jacobian" in losses[0]) == (prior == "fomm"),
          f"{prior}: loss terms {sorted(losses[0])}")
    moved = sum(float((p.detach() - q).abs().max() > 0)
                for p, q in zip(trainer.optimizer.param_groups[0]["params"], before))
    check(moved == len(before), f"{prior}: only {moved} of {len(before)} tensors changed")
    result = {
        "phase": f"{prior}_training", "config": f"config/vox1.yaml {prior}", "size": FRAME_SIZE,
        "batch": TRAIN_BATCH, "dtype": "float32", "tf32": False, "card": card,
        "dropout_flag": dropout_flag, "dropout_p": dropout_p,
        "steps_timed": PRIOR_TIMED_STEPS, "ms_per_step": elapsed / PRIOR_TIMED_STEPS * 1e3,
        "samples_per_s": TRAIN_BATCH * PRIOR_TIMED_STEPS / elapsed,
        "peak_memory_bytes": peak, "launches": launches, "steps_total": n_steps,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "loss_first": losses[0]["loss"], "loss_last": losses[-1]["loss"],
    }
    print("phase12b " + json.dumps(result))
    paths[f"{prior}_training"] = launches
    del trainer, batches, before
    torch.cuda.empty_cache()
    return paths


def lookup_bwd_bytes(bq: int, coords, itemsize: int) -> int:
    """Bytes the lookup backward must move: the patch values and the coords
    read, g read (f32), both whole d_maps written (each query owns its
    maps) and d_coords written."""
    from mrfa_tpu_torch.tools.kernel_times import patch_bytes

    maps = MAP_SIZE * MAP_SIZE + (MAP_SIZE // 2) ** 2
    return patch_bytes(coords, itemsize) + bq * 2 * 4 + bq * 98 * 4 + bq * maps * itemsize \
        + bq * 2 * 4


def lookup_bwd_flops(bq: int) -> int:
    """f32 operations of the lookup backward: per cotangent-patch value four
    weight products, four products and three sums (2 x 64 x 11); per window
    tap two differences, two products and a sum for each of d/dx and d/dy,
    and the product with g (98 x 12); the two sums over the taps (2 x 98);
    per level the centre, fractions and weights (2 x 12); the level
    combination (4)."""
    return bq * (2 * 64 * 11 + 98 * 12 + 2 * 98 + 2 * 12 + 4)


def library_lookup(c0, c1, coords):
    """The same lookup as two F.grid_sample calls (yardstick only)."""
    import torch
    import torch.nn.functional as F

    d = torch.arange(-3, 4, device=coords.device, dtype=torch.float32)
    outs = []
    for level, maps in enumerate((c0, c1)):
        size = maps.shape[-1]
        c = coords * (0.5 ** level)
        gx = c[:, 0, None, None] + d[None, :, None]  # x offset on the first window axis
        gy = c[:, 1, None, None] + d[None, None, :]
        gx, gy = torch.broadcast_tensors(gx, gy)
        grid = torch.stack([gx, gy], -1) * (2.0 / (size - 1)) - 1.0
        out = F.grid_sample(maps[:, None], grid.to(maps.dtype), mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        outs.append(out.reshape(maps.shape[0], -1))
    return torch.cat(outs, 1)


def phase_timing(k, device):
    """Phase 7: kernel, plain and library times at each kernel's largest
    main-path shape (the lookup also at the serving BQ=4096); then the splat
    at all six shapes (noisy and smooth flows) and the lookup at all eight
    BQs, and their per-path sums of launches x ms against launches x bound.
    Returns (rows by kernel, the sums)."""
    import torch
    import torch.nn.functional as F

    from mrfa_tpu_torch.ops.corr_lookup import (
        corr_lookup_bwd_plain,
        corr_lookup_plain,
        corr_lookup_pooled_bwd_plain,
    )
    from mrfa_tpu_torch.ops.splat import splat_plain
    from mrfa_tpu_torch.ops.stream_probe import stream_probe_plain
    from mrfa_tpu_torch.tools.kernel_times import (
        HBM_BYTES_PER_S,
        SPLAT_SHAPES,
        STREAM_BQS,
        TRAIN_BATCH,
        bound,
        cuda_ms,
        lookup_bytes,
        lookup_flops,
        lookup_inputs,
        make_flush,
        path_sums,
        splat_bytes,
        splat_flops,
        splat_inputs,
        stream_levels,
        stream_library,
        time_shapes,
        time_stream,
    )
    from mrfa_tpu_torch.tools.probe_lookup import pooled_bwd_bytes, pooled_bwd_flops

    flush = make_flush(device)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        # the training BQ last: the lookup backward below reuses its inputs
        for bq in (LOOKUP_BQS[-1], SERVER_BQ, EVAL_LOOKUP_BQS[-1], TRAIN_LOOKUP_BQS[-1]):
            c0, c1, coords = lookup_inputs(bq, dtype, device, seed=SEED + 10)
            lib_err = float((library_lookup(c0, c1, coords).float()
                             - corr_lookup_plain(c0, c1, coords).float()).abs().max())
            row = {
                "shape": f"bq={bq}",
                "ms": cuda_ms(lambda: k["corr_lookup"](c0, c1, coords), 50, flush),
                "plain_ms": cuda_ms(lambda: corr_lookup_plain(c0, c1, coords), 10, flush),
                "library_ms": cuda_ms(lambda: library_lookup(c0, c1, coords), 10, flush),
                "library_max_abs_err": lib_err,
                **bound(lookup_bytes(bq, coords, c0.element_size()), lookup_flops(bq)),
            }
            print(f"phase7 corr_lookup {name} bq={bq}: " + json.dumps(row))
            rows[("corr_lookup", dtype, bq)] = row
        # the lookup backward at the training step's full-resolution BQ
        g = torch.randn(bq, 98, device=device).to(dtype)
        leaves = [t.clone().float().requires_grad_(True) for t in (c0, c1, coords)]
        lib_out = library_lookup(*leaves)
        row = {
            "shape": f"bq={bq}",
            "ms": cuda_ms(lambda: k["corr_lookup_bwd"](c0, c1, coords, g), 20, flush),
            "plain_ms": cuda_ms(lambda: corr_lookup_bwd_plain(c0, c1, coords, g), 5, flush),
            # autograd of the two-grid_sample yardstick, in f32 (grid_sample
            # wants its grid in the map dtype, which bf16 cannot carry)
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_out, leaves, g.float(), retain_graph=True), 5, flush),
            **bound(lookup_bwd_bytes(bq, coords, c0.element_size()), lookup_bwd_flops(bq)),
        }
        print(f"phase7 corr_lookup_bwd {name} bq={bq}: " + json.dumps(row))
        rows[("corr_lookup_bwd", dtype)] = row
        del c0, c1, coords, g, leaves, lib_out
        # the splat at the largest warp: (B=10, N=65536, C=64) onto 256x256
        res, c = SPLAT_SHAPES[-1]
        args, ix, iy = splat_inputs(res, c, dtype, device, seed=SEED + 11)
        gimg = args[0].float().transpose(1, 2).reshape(TRAIN_BATCH, c, 1, res * res)
        img = torch.empty(TRAIN_BATCH, c, res, res, device=device)
        grid = torch.stack([ix * (2.0 / (res - 1)) - 1.0, iy * (2.0 / (res - 1)) - 1.0],
                           -1)[:, None]
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            gimg, img, grid, 0, 0, True, [True, False])
        lib_err = float((lib()[0].permute(0, 2, 3, 1) - splat_plain(*args)).abs().max())
        n = res * res
        row = {
            "shape": f"B={TRAIN_BATCH} n={n} c={c} h=w={res}",
            "ms": cuda_ms(lambda: k["splat"](*args), 20, flush),
            "plain_ms": cuda_ms(lambda: splat_plain(*args), 5, flush),
            # grid_sampler_2d_backward's input gradient, f32 (yardstick only)
            "library_ms": cuda_ms(lib, 10, flush), "library_max_abs_err": lib_err,
            **bound(splat_bytes(TRAIN_BATCH, n, c, res, res, args[0].element_size()),
                    splat_flops(TRAIN_BATCH, n, c)),
        }
        print(f"phase7 splat {name} {row['shape']}: " + json.dumps(row))
        rows[("splat", dtype)] = row
        del args, ix, iy, gimg, img, grid
        # the pooled lookup backward at the lookup probe's largest BQ
        bq = PROBE_BQS[-1]
        corr, _, coords = lookup_inputs(bq, dtype, device, seed=SEED + 12)
        g = torch.randn(bq, 98, device=device)
        leaves = [corr.float().clone().requires_grad_(True), coords.clone().requires_grad_(True)]
        lib_out = library_lookup(leaves[0], F.avg_pool2d(leaves[0], 2), leaves[1])
        lib_grads = torch.autograd.grad(lib_out, leaves, g, retain_graph=True)
        plain = corr_lookup_pooled_bwd_plain(corr, coords, g)
        # d_corr only: at the integer centres (kinks of the blend) grid_sample
        # takes the other one-sided coordinate derivative
        lib_err = float((lib_grads[0] - plain[0].float()).abs().max())
        row = {
            "shape": f"bq={bq} {MAP_SIZE}x{MAP_SIZE}",
            "ms": cuda_ms(lambda: k["corr_lookup_pooled_bwd"](corr, coords, g), 20, flush),
            "plain_ms": cuda_ms(lambda: corr_lookup_pooled_bwd_plain(corr, coords, g), 5, flush),
            # autograd of avg_pool2d + two grid_sample, f32 (yardstick only)
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_out, leaves, g, retain_graph=True), 5, flush),
            "library_max_abs_err_dcorr": lib_err,
            **bound(pooled_bwd_bytes(coords, MAP_SIZE, MAP_SIZE, corr.element_size()),
                    pooled_bwd_flops(bq, MAP_SIZE, MAP_SIZE)),
        }
        print(f"phase7 corr_lookup_pooled_bwd {name} {row['shape']}: " + json.dumps(row))
        rows[("corr_lookup_pooled_bwd", dtype)] = row
        del corr, coords, g, leaves, lib_out, lib_grads, plain
    # the streaming probe (f32), both levels, at the probes' BQs: the kernel,
    # the plain version and two library yardsticks after the same flush (the
    # torch.stack of the kept corners, equal output from fewer bytes, and
    # l0.sum(); l1.sum(), every byte read once, as the probe reads them);
    # at BQ 16384 also back to back without the flush
    for i, bq in enumerate(STREAM_BQS):
        l0, l1 = stream_levels(bq, device, seed=SEED + 13 + i)
        check(torch.equal(stream_library(l0, l1, bq, STREAM_QB),
                          stream_probe_plain(l0, l1, bq, STREAM_QB)), "slice copy")
        del l0, l1
        row = time_stream(k["stream_probe"], stream_probe_plain, bq, device, seed=SEED + 13 + i,
                          qb=STREAM_QB, flush=flush)
        print(f"phase7 stream_probe float32 {row['shape']}: " + json.dumps(row))
        check(row["gb_per_s"] * 1e9 <= HBM_BYTES_PER_S,
              f"stream_probe {row['shape']} above the memory rate: bytes were skipped")
        rows[("stream_probe", torch.float32, bq)] = row
    del flush
    shape_rows = time_shapes(k["splat"], k["corr_lookup"], device, (torch.float32, torch.bfloat16))
    for row in shape_rows:
        print("phase7 shape " + json.dumps(row))
    sums = path_sums(shape_rows)
    for key, s in sums.items():
        print(f"phase7 sum {key}: {s['launches']} launches, {s['ms']:.6f} ms against "
              f"{s['bound_ms']:.6f} ms bound ({s['bound_ms'] / s['ms']:.3f} of it)")
    return rows, sums


def _profile(fn, n: int, label: str, trace_name: str, by_op: bool = False):
    """Device kernel time by name over `n` runs of `fn` (torch.profiler trace
    written to build/), and the device's idle share of the window from the
    first kernel's start to the last one's end. With `by_op`, also the ATen
    operators with the most device time, by input shape. Returns (time and
    count by kernel name, busy ms a run, the idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_op) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    trace = Path(__file__).resolve().parent / "build" / trace_name
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(bool(kernels), "the profiler recorded no device kernels")
    busy = sum(e["dur"] for e in kernels)
    window = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], c + 1)
    print(f"{label} profile: {len(kernels) / n:.0f} device ops/{trace_name.split('_')[0]}, "
          f"busy {busy / n / 1e3:.3f} ms, window {window / n / 1e3:.3f} ms, "
          f"idle share {1 - busy / window:.4f}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{label}   {t / n / 1e3:8.3f} ms {c // n:5d}x  {name[:100]}")
    for name, (t, c) in by_name.items():
        if name.startswith(("void (anonymous namespace)::", "(anonymous namespace)::",
                            "corr_lookup", "splat")) and ("corr_lookup" in name or "splat" in name):
            print(f"{label}   port kernel {t / n / 1e3:8.3f} ms {c // n:5d}x  {name[:100]}")
    if by_op:
        from mrfa_tpu_torch.tools.kernel_times import SPLAT_SHAPES, TRAIN_BATCH

        ops = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key.startswith("aten::")]
        self_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
        for e in sorted(ops, key=self_us, reverse=True)[:8]:
            print(f"{label}   op {self_us(e) / n / 1e3:8.3f} ms {e.count // n:5d}x  {e.key} "
                  f"{str(e.input_shapes)[:120]}")
        # the copies of the warps' (B, C, N) cotangents into the splat's
        # (B, N, C) layout (ops/sampler.py), by their source's shape
        shapes = {str([TRAIN_BATCH, res * res, c]) for res, c in SPLAT_SHAPES}
        moved = [e for e in ops if e.key == "aten::copy_" and e.input_shapes
                 and str(e.input_shapes[1]) in shapes]
        print(f"{label}   splat-layout copies {sum(map(self_us, moved)) / n / 1e3:8.3f} ms "
              f"{sum(e.count for e in moved) // n:5d}x  aten::copy_ of (B, N, C) views "
              f"at the splat shapes")
    return by_name, busy / n / 1e3, 1 - busy / window


def phase_profile(served, frames_dev, trainer, batch):
    """Phase 8: profiles of 3 frames of each serving (label, animator,
    state), of one `animate_chunk` call of each, and of one training step.
    A chunk replays the frame step's CUDA graph, whose launch counts are the
    launches captured once, times the replays: the lookup kernels the
    profiler sees in the call must match that count."""
    import torch

    for label, animator, state in served:
        frames = iter(frames_dev)
        _profile(lambda: animator.animate_frame(state, next(frames)), 3, f"phase8 {label}",
                 f"frame_{label}_trace.json")
        stack = torch.stack(frames_dev[:CHUNK])
        animator.animate_chunk(state, stack)  # the clip's graph, captured if it is not
        by_name, _, _ = _profile(lambda: animator.animate_chunk(state, stack), 1,
                                 f"phase8 chunk {label}", f"chunk_{label}_trace.json")
        seen = sum(c for name, (_, c) in by_name.items() if "corr_lookup_kernel" in name)
        counted = CHUNK * animator._graph.launches["corr_lookup"]
        print(f"phase8 chunk {label}: {seen} lookup kernels traced in {CHUNK} replays, "
              f"{counted} counted")
        check(seen == counted == 6 * CHUNK,
              f"chunk {label}: {seen} lookups traced, {counted} counted, want {6 * CHUNK}")
    by_name, _, _ = _profile(lambda: trainer.step(batch), 1, "phase8 training",
                             "step_trace.json", by_op=True)
    share = fft_share(by_name)
    print(f"phase8 training: cuDNN FFT-convolution share of busy time {share:.4f}")
    return share


# ---------------------------------------------------------------------------
# Phases 13-16: bf16 training, the data path from files, the CLIs, profiling

# how far the card's bf16 step may sit from the CPU's bf16 step, in units of
# the CPU's own bf16-to-f32 distance measured in the same run (the random
# 64 px step is ill conditioned: bf16 rounding alone moves a gradient tensor
# by tens of percent of its max |g|, tests/test_torch_bf16_train.py)
BF16_STEP_FACTOR = 2.0
# the bf16 learning check: the mean loss of the last 10 of 20 steps within
# this relative distance of the f32 run's, from the same weights and batch.
# CPU readings at seeds 40 and 60: 0.017 and 0.076 (the last 3 steps alone:
# 0.026 and 0.111, each step's loss moving with its random transform)
BF16_LEARN_GATE = 0.15
LEARN_TAIL = 10
DATA_CLIPS, DATA_FRAMES, DATA_TEST_CLIPS = 32, 16, 4
DATA_STEPS = 3  # loop steps an epoch from files
DEMO_FRAMES = 32
HEADERS = ("/usr/include/png.h", "/usr/include/jpeglib.h", "/usr/include/zlib.h")


def parity_helpers():
    """tests/torch_parity.py, loaded from its file (an installed package
    named `tests` may shadow the repository's test directory)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_parity.py"
    spec = importlib.util.spec_from_file_location("smoke_torch_parity", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_grads(trainer, batch):
    """One step; returns (loss terms, generated, {name: pre-clip grad on the CPU})."""
    import mrfa_tpu_torch.train.trainer as trainer_mod

    grads, clip = {}, trainer_mod.clip_inf_norm_subtrees

    def spy(model, max_norm):
        grads.update({n: p.grad.detach().float().cpu().clone()
                      for n, p in model.named_parameters() if p.grad is not None})
        return clip(model, max_norm)

    trainer_mod.clip_inf_norm_subtrees = spy
    try:
        out = trainer.step(batch)
    finally:
        trainer_mod.clip_inf_norm_subtrees = clip
    return {k: v for k, v in out.items() if k != "gen"}, out["gen"].float().cpu(), grads


def phase_train_bf16_gpu_vs_cpu():
    """Phase 13a: one bf16 training step on the card against the CPU's bf16
    step at phase 4's setup, within a tolerance measured on the CPU in this
    run: the CPU's own bf16 step against its f32 step, times
    BF16_STEP_FACTOR (loss terms, at least one bf16 rounding of each;
    generated frames; each gradient tensor's max |dg| over its max |g|, by
    median and 90th percentile over the tensors). Every gradient finite and
    f32."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = small_cfg(losses=True)
    on_cpu, _, batch = _trainer_pair_step(cfg, SEED + 20, n_gpu=0)
    weights = {k: v.clone() for k, v in on_cpu.model.state_dict().items()}

    def trainer(device, dtype):
        return Trainer(cfg, device=device, generator=torch.Generator().manual_seed(SEED + 21),
                       weights={k: v.clone() for k, v in weights.items()}, compute_dtype=dtype)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random VGG19's warning
        cpu32 = _step_grads(trainer("cpu", None), batch)
        cpu16 = _step_grads(trainer("cpu", torch.bfloat16), batch)
        gpu_trainer = trainer("cuda", torch.bfloat16)
        gpu16 = _step_grads(gpu_trainer, batch)
    check(all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
              for p in gpu_trainer.model.parameters()), "bf16 masters or grads not f32")
    check(all(torch.isfinite(g).all() for g in gpu16[2].values()), "a bf16 gradient not finite")

    # the tensors whose f32 gradient is not ~0 (not the biases BatchNorm follows)
    names = [n for n, w in cpu32[2].items() if float(w.abs().max()) >= 1e-5]

    def rel_errs(got, want):
        return {n: float((got[n] - want[n]).abs().max()) / float(want[n].abs().max())
                for n in names}

    terms = {}
    for k, want in cpu16[0].items():
        # the CPU's own bf16-to-f32 distance, or one bf16 rounding of the
        # term where that distance is smaller by chance
        tol = max(BF16_STEP_FACTOR * abs(want - cpu32[0][k]), 2.0 ** -8 * abs(want))
        err = abs(gpu16[0][k] - want)
        terms[k] = (gpu16[0][k], want, cpu32[0][k], err, tol)
        check(np.isfinite(gpu16[0][k]) and err <= tol, f"bf16 step loss {k}: {terms[k]}")
    gen_err = float((gpu16[1] - cpu16[1]).abs().max())
    gen_tol = BF16_STEP_FACTOR * float((cpu16[1] - cpu32[1]).abs().max())
    check(gen_err <= gen_tol, f"bf16 step generated frames: {gen_err} > {gen_tol}")
    card, policy = rel_errs(gpu16[2], cpu16[2]), rel_errs(cpu16[2], cpu32[2])

    def summary(errs):
        v = list(errs.values())
        return {"median": float(np.median(v)), "p90": float(np.percentile(v, 90)),
                "max": [max(v), max(errs, key=errs.get)]}

    stats = {"card_vs_cpu_bf16": summary(card), "cpu_bf16_vs_f32": summary(policy)}
    print("phase13a train bf16 gpu-vs-cpu 64 px: " + json.dumps({
        "terms (gpu, cpu bf16, cpu f32, err, tol)": terms, "generated": [gen_err, gen_tol],
        "grad max|dg|/max|g| over tensors": stats, "tensors": len(names)}))
    # a single tensor's distance is noise-dominated under bf16 (see above):
    # the gate is on the median and the 90th percentile over tensors
    for what in ("median", "p90"):
        check(stats["card_vs_cpu_bf16"][what]
              <= BF16_STEP_FACTOR * stats["cpu_bf16_vs_f32"][what],
              f"bf16 gradients on the card, {what} over tensors: {stats}")


def phase_train_bf16_full_width(kernels, card):
    """Phase 13b: `Trainer(vox1, compute_dtype=bf16)` at full width, batch
    10, phase 5's warm-up and timed steps: ms/step, samples/s, peak memory,
    the launches a step (PER_STEP); every parameter moves and its gradient
    and Adam moments are f32. Returns (trainer, a batch, launches, result)."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random VGG19's warning
        trainer = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED),
                          compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = [{k: smooth_frames(TRAIN_BATCH, FRAME_SIZE, gen, "cuda")
                for k in ("source", "driving")} for _ in range(n_steps)]
    params = trainer.optimizer.param_groups[0]["params"]
    before = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    losses = [trainer.step(b) for b in batches[:TRAIN_WARMUP_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.step(b) for b in batches[TRAIN_WARMUP_STEPS:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts(kernels)
    for name, per_step in PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"bf16 {name} launches {launches[name]} != {per_step} x {n_steps} steps")
    for out in losses:
        check(all(np.isfinite(out[k]) for k in out if k != "gen"), f"non-finite loss {out}")
    moved = sum(float((p.detach() - q).abs().max() > 0) for p, q in zip(params, before))
    check(moved == len(before), f"bf16: only {moved} of {len(before)} parameter tensors moved")
    check(all(p.dtype == torch.float32 for p in trainer.model.parameters()), "masters not f32")
    check(all(p.grad.dtype == torch.float32 for p in trainer.model.parameters()
              if p.grad is not None), "bf16 training: a gradient is not f32")
    check(all(v.dtype == torch.float32 for st in trainer.optimizer.state.values()
              for v in st.values() if torch.is_tensor(v) and v.dim() > 0),
          "bf16 training: an Adam moment is not f32")
    result = {
        "phase": "train_bf16_full_width", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
        "batch": TRAIN_BATCH, "dtype": "bfloat16 policy, f32 masters", "tf32": False,
        "card": card, "steps_timed": TRAIN_TIMED_STEPS,
        "ms_per_step": elapsed / TRAIN_TIMED_STEPS * 1e3,
        "samples_per_s": TRAIN_BATCH * TRAIN_TIMED_STEPS / elapsed,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "loss_first": losses[0]["loss"], "loss_last": losses[-1]["loss"],
    }
    print("phase13b " + json.dumps(result))
    return trainer, batches[-1], launches, result


def phase_learning_bf16(card):
    """Phase 13c: phase 6's 20 steps on one fixed batch, f32 and bf16 from
    the same weights: both losses fall, and the bf16 run's mean loss over
    its last LEARN_TAIL steps within BF16_LEARN_GATE of the f32 run's."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = small_cfg(losses=True)
    cfg["train_params"]["lr"] = 1e-3
    torch.manual_seed(SEED + 40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        weights = Trainer(cfg, device="cpu").model.state_dict()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
        batch = {k: smooth_frames(2, 64, gen, "cuda") for k in ("source", "driving")}
        runs = {}
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            trainer = Trainer(cfg, generator=torch.Generator().manual_seed(SEED + 41),
                              weights={k: v.clone() for k, v in weights.items()},
                              compute_dtype=dtype)
            runs[label] = [trainer.step(batch)["loss"] for _ in range(LEARN_STEPS)]
    drops = {k: 1.0 - float(np.mean(v[-3:])) / float(np.mean(v[:3])) for k, v in runs.items()}
    tail = {k: float(np.mean(v[-LEARN_TAIL:])) for k, v in runs.items()}
    gap = abs(tail["bf16"] - tail["f32"]) / tail["f32"]
    print("phase13c learning f32 vs bf16: " + json.dumps(
        {"card": card, "drop": drops, "tail_mean": tail, "tail_rel_gap": gap, "gate": BF16_LEARN_GATE,
         "losses": {k: [round(x, 5) for x in v] for k, v in runs.items()}}))
    for label, losses in runs.items():
        check(all(np.isfinite(v) for v in losses), f"{label}: non-finite loss")
        check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"{label}: the loss did not fall")
    check(gap <= BF16_LEARN_GATE, f"bf16 learning: tail loss {gap:.3f} from f32's")


FFT_CONV = re.compile(r"fft|_cf32|_cbf16|_cf16")  # the transforms, and their complex GEMMs


def fft_share(by_name) -> float:
    """The share of device time in cuDNN's FFT-based convolution: its
    transforms (`fft` in the name) and the complex GEMMs between them (the
    tiled `..._cf32cf32_...` kernels; no other path runs a complex GEMM)."""
    busy = sum(t for t, _ in by_name.values())
    return sum(t for name, (t, _) in by_name.items() if FFT_CONV.search(name)) / max(busy, 1e-9)


def phase_profiling(trainer, batch, work: Path, f32_fft: float, card: str):
    """Phase 16: `utils.profiling` on the card: `StepTimer` against CUDA
    events over 3 bf16 training steps (one warm-up): within 5%; then `trace`
    around 2 steps, each in an `annotate("train_step")` span (the trace must
    hold the spans and the port's kernels, in bf16), and the FFT-convolution
    share of the bf16 step's busy time beside the f32 step's (phase 8). The
    timer runs first: timed after the trace, with its ~115 MB of parsed
    events alive, the host-bound steps ran 1.8-6x slower (PERF.md)."""
    import torch

    from mrfa_tpu_torch.utils import profiling

    timer = profiling.StepTimer(warmup=1, device="cuda")
    event_ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timer:
            start.record()
            trainer.step(batch)
            end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    events_mean = float(np.mean(event_ms[1:])) / 1e3
    rel = abs(timer.mean_step_time - events_mean) / events_mean
    print(f"phase16 StepTimer: {timer.steps_timed} steps, mean {timer.mean_step_time * 1e3:.3f} "
          f"ms, CUDA events {events_mean * 1e3:.3f} ms, rel {rel:.4f} (tol 0.05); "
          f"{timer.throughput(TRAIN_BATCH):.3f} samples/s; {card}")
    check(timer.steps_timed == 2 and rel <= 0.05, f"StepTimer vs CUDA events: {rel}")

    logdir = work / "trace"
    with profiling.trace(str(logdir)):
        for _ in range(2):
            with profiling.annotate("train_step"):
                trainer.step(batch)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_step"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], c + 1)
    names = list(by_name)
    ported = {k: [n for n in names if f"{k}<" in n]
              for k in ("corr_lookup_kernel", "corr_lookup_bwd_kernel", "splat_accumulate_kernel")}
    in_bf16 = {k: any("bfloat16" in n for n in v) for k, v in ported.items()}
    share = fft_share(by_name)
    busy = sum(t for t, _ in by_name.values())
    window = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    print("phase16 trace: " + json.dumps({
        "card": card, "train_step_spans": len(spans), "kernel_events": len(kernels),
        "port_kernels": ported, "port_kernels_in_bf16": in_bf16,
        "busy_ms_per_step": busy / 2 / 1e3, "window_ms_per_step": window / 2 / 1e3,
        "idle_share": 1 - busy / window,
        "fft_share_bf16": share, "fft_share_f32_phase8": f32_fft,
        "trace_bytes": (logdir / "trace.json").stat().st_size}))
    check(len(spans) >= 2, f"the trace holds {len(spans)} train_step spans")
    check(all(ported.values()), f"the trace lacks a port kernel: {ported}")
    check(all(in_bf16.values()), f"a port kernel did not run in bf16: {ported}")
    return share


class WaitTimed:
    """A BatchLoader whose epochs record the seconds the consumer waited for
    each batch (the loop's time blocked on the data path)."""

    def __init__(self, loader_cls, waits):
        self.loader_cls, self.waits = loader_cls, waits

    def __call__(self, *args, **kwargs):
        loader = self.loader_cls(*args, **kwargs)
        epoch, waits = loader.epoch, self.waits

        def timed(*a, **k):
            batches = epoch(*a, **k)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                batches.close()

        loader.epoch = timed
        return loader


def write_png_dataset(root: Path) -> float:
    """train/ and test/ of PNG frame directories at 256 px (smooth frames
    from the seed), written by the port's writer; returns the seconds."""
    from mrfa_tpu_torch.utils.video import save_image

    t0 = time.perf_counter()
    for split, n, seed in (("train", DATA_CLIPS, SEED + 80), ("test", DATA_TEST_CLIPS, SEED + 81)):
        clips = smooth_clips(n, DATA_FRAMES, FRAME_SIZE, seed)
        for i, clip in enumerate(clips):
            d = root / split / f"id{i:03d}#{i}"
            d.mkdir(parents=True)
            for t, frame in enumerate(clip):
                save_image(str(d / f"{t:04d}.png"), (255 * frame).round().astype(np.uint8))
    return time.perf_counter() - t0


def phase_data_from_files(kernels, card, work: Path):
    """Phase 14: the data path from files. The host codec's build (or why it
    does not build), a PNG dataset written by the port, `FramesDataset` +
    `BatchLoader` samples/s with the config's workers, then `loop.train` on
    vox1 (TokenPose cut to 2 layers, as phase 10b) with `compute_dtype:
    bf16`, 2 epochs of DATA_STEPS steps from the files: ms/step and the
    seconds a step waits on the loader, beside one epoch on in-memory clips
    in the same call; the decoder counts; and a resume of epoch 1 from the
    epoch-0 checkpoint. Returns the launch counts of each run."""
    import shutil

    import torch

    from mrfa_tpu_torch import native
    from mrfa_tpu_torch.data import dataset as data
    from mrfa_tpu_torch.train import loop

    import importlib.util

    headers = {h: Path(h).exists() for h in HEADERS}
    t0 = time.perf_counter()
    available = native.available()
    print("phase14 codec: " + json.dumps({
        "headers": headers, "available": available, "load_or_build_s": time.perf_counter() - t0,
        "build_error": native.build_error(),
        "host_image_packages": {m: importlib.util.find_spec(m) is not None
                                for m in ("imageio", "cv2", "PIL")}}))
    if not available:
        print("phase14 codec: not built on this machine; PNG frames are decoded by "
              "utils.video.decode_png (native decode on the card: not measured)")
    root = work / "pngdata"
    write_s = write_png_dataset(root)
    cfg = run_config("vox1")
    cfg["mtia_kp_detector"]["MODEL"]["TRANSFORMER_DEPTH"] = 2
    cfg["dataset_params"]["root_dir"] = str(root)
    cfg["train_params"].update(batch_size=TRAIN_BATCH, num_epochs=2, num_repeats=1,
                               checkpoint_freq=1, compute_dtype="bf16")
    workers = cfg["train_params"].get("num_workers", 4)  # the loop's default, as in vox1.yaml
    dataset = data.FramesDataset(is_train=True, seed=SEED, **cfg["dataset_params"])
    loader = data.BatchLoader(dataset, TRAIN_BATCH, seed=SEED, num_workers=workers)
    data.DECODED.reset()
    t0 = time.perf_counter()
    n = sum(len(b["name"]) for b in loader.epoch(0))
    load_s = time.perf_counter() - t0
    decoded = data.DECODED.counts()
    check(n == (DATA_CLIPS // TRAIN_BATCH) * TRAIN_BATCH, f"loader gave {n} samples")
    check(sum(decoded.values()) == 2 * n, f"decoder counts {decoded} for {n} samples")
    loader_result = {"samples": n, "seconds": load_s, "samples_per_s": n / load_s,
                     "num_workers": workers, "decoded": decoded, "write_s": write_s,
                     "frames_written": (DATA_CLIPS + DATA_TEST_CLIPS) * DATA_FRAMES}
    print("phase14 loader " + json.dumps(loader_result))

    waits, plain = [], loop.BatchLoader
    loop.BatchLoader = WaitTimed(plain, waits)
    runs = {}
    try:
        for label, ds, log, ckpt, steps in (
            ("files", lambda: data.FramesDataset(is_train=True, seed=SEED,
                                                 **cfg["dataset_params"]), "files", None, 2),
            ("memory", lambda: ClipDataset(smooth_clips(DATA_CLIPS, 2, FRAME_SIZE, SEED + 82),
                                           True), "memory", None, 1),
        ):
            run_cfg = json.loads(json.dumps(cfg))
            run_cfg["train_params"]["num_epochs"] = steps
            waits.clear()
            data.DECODED.reset()
            trainer, launches, epochs, peak, seconds = _run_loop(
                kernels, run_cfg, ds(), work / log, max_steps=DATA_STEPS)
            _check_launches(launches, steps * DATA_STEPS, f"loop from {label}")
            check(trainer.model.compute_dtype == torch.bfloat16, "the loop did not train in bf16")
            runs[label] = {"epoch_lines": epochs, "ms_per_step_last_epoch":
                           epochs[-1][2] / epochs[-1][1] * 1e3, "loader_wait_s": list(waits),
                           "loader_wait_s_per_step_after_first": float(np.mean(waits[1:])),
                           "peak_memory_bytes": peak, "seconds": seconds,
                           "decoded": data.DECODED.counts(), "launches": launches}
            if label == "files":
                straight = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
            del trainer
            torch.cuda.empty_cache()
        shutil.copytree(work / "files" / "ckpt" / "0", work / "resume" / "ckpt" / "0")
        data.DECODED.reset()
        resumed, resume_launches, resume_epochs, _, _ = _run_loop(
            kernels, cfg, data.FramesDataset(is_train=True, seed=SEED, **cfg["dataset_params"]),
            work / "resume", str(work / "resume" / "ckpt"), max_steps=DATA_STEPS)
    finally:
        loop.BatchLoader = plain
    _check_launches(resume_launches, DATA_STEPS, "loop from files, resumed")
    check([e[:2] for e in resume_epochs] == [(1, DATA_STEPS)], f"resumed {resume_epochs}")
    check(resumed.steps == 2 * DATA_STEPS, f"resumed step count {resumed.steps}")
    diff = max(float((p.detach() - straight[n]).abs().max())
               for n, p in resumed.model.named_parameters())
    check(np.isfinite(diff), "the resumed parameters are not finite")
    decoded = runs["files"]["decoded"]
    want = {"native": 2 * TRAIN_BATCH * 2 * DATA_STEPS} if available else {
        "png": 2 * TRAIN_BATCH * 2 * DATA_STEPS}
    check({k: v for k, v in decoded.items() if v} == want, f"decoders {decoded}, want {want}")
    result = {"phase": "data_from_files", "config": "config/vox1.yaml mtia, TokenPose depth 2, "
              "compute_dtype bf16", "card": card, "batch": TRAIN_BATCH, "codec": available,
              "loader": loader_result, "runs": runs, "resumed_epochs": resume_epochs,
              "resumed_vs_straight_params_max_abs": diff}
    print("phase14 " + json.dumps(result))
    del resumed
    torch.cuda.empty_cache()
    return {"loop_files_bf16": runs["files"]["launches"],
            "loop_memory_bf16": runs["memory"]["launches"],
            "loop_files_bf16_resumed": resume_launches}


def phase_clis(kernels, card, work: Path):
    """Phase 15: the CLIs at full width. `cli/convert_backbones` on random
    torchvision-shaped VGG19 / VGG16 / LPIPS state dicts, the files read
    back by `weights/` (the VGG19 overlay and LPIPS); `cli/convert` on a
    reference-format `.pth` of config/vox1.yaml's model (tests/torch_parity's
    writer, random weights from the seed); `cli/demo` from the converted
    checkpoint on a 512 px PNG source and a PNG strip of DEMO_FRAMES driving
    frames at 256 px, with `--relative --adapt_scale`, then with
    `--find_best_frame`: frames/s, 6 lookups a frame, the frames equal to
    `Animator.make_animation`'s on the same inputs, the video written (a PNG
    frame directory where no video writer is installed). Returns the launch
    counts of each demo run."""
    import torch

    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch import weights as W
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.cli import convert, convert_backbones, demo
    from mrfa_tpu_torch.data.dataset import read_image, read_video
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import restore_checkpoint
    from mrfa_tpu_torch.utils.video import save_image

    # convert_backbones, and the weights module reading its files
    helpers = parity_helpers()
    paths = helpers.torchvision_backbone_files(str(work), seed=SEED + 90)
    t0 = time.perf_counter()
    convert_backbones.main([f"--{k}={v}" for k, v in paths.items()]
                           + [f"--out_dir={work / 'weights'}"])
    backbones_s = time.perf_counter() - t0
    files = (W.VGG19_FILE, W.LPIPS_FILE)
    W.VGG19_FILE = str(work / "weights" / Path(files[0]).name)
    W.LPIPS_FILE = str(work / "weights" / Path(files[1]).name)
    try:
        torch.manual_seed(SEED)
        model = MRFA(vox1_cfg())
        check(W.overlay_vgg19(model), "weights/ did not read the converted VGG19")
        vgg19 = torch.load(paths["vgg19"], weights_only=True)
        check(torch.equal(model.vgg.features_28.weight.cpu(), vgg19["features.28.weight"]),
              "the overlaid VGG19 differs from the torchvision state dict")
        lpips = evals._lpips_module(W.lpips_variables(), torch.device("cuda"))
        x = torch.rand(1, 3, 64, 64, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        lpips_value = float(lpips(x, x.flip(-1)).mean())
        check(np.isfinite(lpips_value), "LPIPS on the converted weights is not finite")
    finally:
        W.VGG19_FILE, W.LPIPS_FILE = files
    del model

    # convert, then the demo on the converted checkpoint
    cfg = run_config("vox1")
    config_path, pth, _ = helpers.write_cli_inputs(str(work), cfg=cfg, seed=SEED)
    t0 = time.perf_counter()
    missing, unexpected = convert.main([f"--config={config_path}", f"--checkpoint={pth}",
                                        f"--out={work / 'converted'}"])
    convert_s = time.perf_counter() - t0
    check(not missing and not unexpected, f"convert: missing {missing}, unused {unexpected}")
    gen = torch.Generator().manual_seed(SEED + 91)
    source = (255 * smooth_frames(1, 2 * FRAME_SIZE, gen, "cpu")[0].numpy()).round()
    save_image(str(work / "source.png"), source.astype(np.uint8))
    driving = (255 * smooth_clips(1, DEMO_FRAMES, FRAME_SIZE, SEED + 92)[0]).round()
    save_image(str(work / "driving.png"), np.concatenate(list(driving.astype(np.uint8)), axis=1))
    args = [f"--config={config_path}", f"--checkpoint={work / 'converted'}",
            f"--source_image={work / 'source.png'}", f"--driving_video={work / 'driving.png'}",
            "--relative", "--adapt_scale"]
    runs, launches = {}, {}
    for label, extra in (("demo", []), ("demo_best_frame", ["--find_best_frame"])):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames, written = demo.main(args + extra + [f"--result_video={work / label}.mp4"])
        seconds = time.perf_counter() - t0
        launches[label] = launch_counts(kernels)
        n_frames = DEMO_FRAMES + (label == "demo_best_frame")  # the best frame twice
        check(len(frames) == DEMO_FRAMES, f"{label}: {len(frames)} frames")
        check(launches[label]["corr_lookup"] == 6 * n_frames,
              f"{label}: {launches[label]['corr_lookup']} lookups for {n_frames} frame steps")
        out = Path(written)
        check(out.exists(), f"{label} wrote nothing at {written}")
        runs[label] = {"frames": len(frames), "seconds": seconds,
                       "frames_per_s": len(frames) / seconds, "written": out.name,
                       "written_png_frames": len(list(out.glob("*.png"))) if out.is_dir() else None,
                       "written_bytes": out.stat().st_size if out.is_file() else None,
                       "lookups": launches[label]["corr_lookup"]}
        if label == "demo":
            state, _ = restore_checkpoint(str(work / "converted"))
            model = MRFA(cfg)
            animator = Animator(model, state["trainer"]["model"])
            want = animator.make_animation(
                demo.resize_frame(read_image(str(work / "source.png")), (FRAME_SIZE,) * 2),
                np.stack(list(read_video(str(work / "driving.png")))), adapt_movement_scale=True)
            err = max(float(np.abs(g - w).max()) for g, w in zip(frames, want))
            runs[label]["max_abs_vs_make_animation"] = err
            check(err <= 1e-5, f"demo frames differ from Animator.make_animation's: {err}")
            del animator, model
        check(all(np.isfinite(f).all() and f.shape == (FRAME_SIZE, FRAME_SIZE, 3)
                  for f in frames), f"{label}: frames not finite or of another shape")
    result = {"phase": "clis", "config": "config/vox1.yaml mtia", "card": card,
              "convert_backbones_s": backbones_s, "lpips_on_converted": lpips_value,
              "convert_s": convert_s, "pth_bytes": Path(pth).stat().st_size, "runs": runs}
    print("phase15 " + json.dumps(result))
    torch.cuda.empty_cache()
    return launches



MESH_WARMUP_STEPS = 2
MESH_TIMED_STEPS = 3  # a turn; two turns of each Trainer
MESH_COLLECTIVE_CALLS = 5  # timed calls of each collective in the one-rank world
GLOO_RANKS = 2  # two ranks share the one card: NCCL refuses that, gloo does not
GLOO_BATCH = 5  # a rank's rows of the 256 px global batch of 10
GLOO_WARMUP_STEPS = 1
GLOO_TIMED_STEPS = 3
SPLIT_DEVICES = ("cuda:0", "cuda:0")
MODEL_RANKS = 2  # phase 18: a 1x2 mesh, each rank half of each sample's queries
MODEL_AXIS_WARMUP_STEPS = 1
MODEL_AXIS_TIMED_STEPS = 3
MODEL_AXIS_PLAIN_STEPS = 2  # the one-process bf16 steps beside them (peak memory)
# each sample's queries at the six refinement iterations, at 64 and 256 px
QUERIES = {64: (4, 16, 64, 256, 256, 256), FRAME_SIZE: (64, 256, 1024, 4096, 4096, 4096)}
# the sharded f32 eval forward against the one-process forward (frames in
# [0, 1]); the JAX package holds its sharded forward to 2e-5
# (tests/test_model_axis.py)
MODEL_AXIS_FORWARD_TOL = {64: 1e-5, FRAME_SIZE: 1e-4}
SPLIT_STREAMS = 8
SPLIT_CHUNK_STREAMS = 4  # the f32 serve_chunk's: 2 streams a share
# the bf16 split server against the one-device bf16 server: both bf16 on the
# same weights, their convolutions over batches of 4 and of 8 (read on an
# H100 80GB HBM3 at 700 W: 6.9e-6 mean, 0.0078 max, 2 bf16 ulps below 1);
# a stale or misrouted share moves the mean by orders of magnitude more
SPLIT_BF16_MEAN_TOL = 1e-4
SPLIT_BF16_MAX_TOL = 2.0 ** -6


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params_and_grads(trainer) -> dict:
    """{name: (the parameter, its gradient)} on the CPU in f32, for the
    parameters the last step gave a gradient."""
    return {n: (p.detach().float().cpu(), p.grad.float().cpu())
            for n, p in trainer.model.named_parameters() if p.grad is not None}


# a bf16 gradient moved by one rounding step at most 2^-7 of its tensor's
# largest gradient: the gap between two draws of the same bf16 step on the
# card, where the splat adds each bin's samples in the order their slots
# were claimed (csrc/splat.cu), so an f32 sum near a bf16 tie can round
# either way and carry that upstream
BF16_STEP = 2.0 ** -7


def _step_distance(ref: dict, other: dict, lr: float, label: str) -> dict:
    """One first step from the same weights against another (`_params_and_
    grads` snapshots): each tensor's gradient within BF16_STEP of its max
    |g|; a tensor whose (clipped) gradient is bit-equal updates to
    bit-equal weights (Adam is elementwise); the others within 2 lr (Adam's
    first update moves an element by less than lr). Returns the readings."""
    import torch

    check(sorted(other) == sorted(ref), f"{label}: other parameters got gradients")
    out = {"grads_max_err_over_max_g": 0.0, "grad_tensors_differing": 0,
           "grad_elements_differing": 0, "weights_max_abs": 0.0, "worst": []}
    for name, (w, g) in ref.items():
        w_o, g_o = other[name]
        moved = (g_o - g).abs()
        if not bool((moved > 0).any()):
            check(torch.equal(w_o, w), f"{label}: {name} has the same gradient but "
                                       f"other weights after the step")
            continue
        rel = float(moved.max()) / max(float(g.abs().max()), float(g_o.abs().max()))
        out["grads_max_err_over_max_g"] = max(out["grads_max_err_over_max_g"], rel)
        out["grad_tensors_differing"] += 1
        out["grad_elements_differing"] += int((moved > 0).sum())
        out["weights_max_abs"] = max(out["weights_max_abs"], float((w_o - w).abs().max()))
        out["worst"].append((rel, name))
        check(rel <= BF16_STEP, f"{label} gradient {name}: err / max |g| {rel:.3e} > "
                                f"{BF16_STEP:.3e}")
    out["worst"] = sorted(out["worst"], reverse=True)[:3]
    check(out["weights_max_abs"] < 2 * lr,
          f"{label} weights after the step: err {out['weights_max_abs']:.3e} >= 2 lr")
    return out


def phase_mesh_nccl(kernels, card, bf16_train):
    """Phase 17a: a one-rank NCCL world in this process and its data mesh.
    config/vox1.yaml's model at 256 px, batch 10, under the bf16 policy: one
    step of the mesh `Trainer` against a plain `Trainer` from the same
    weights, generators and batch: the loss terms and BatchNorm buffers
    bit-equal (the forward is deterministic on the card), the gradients
    and weights by `_step_distance`. A second plain step (the twin) is held
    to the same gates: the card's own run-to-run spread, which they must
    cover. A data group of one rank takes the plain step (nothing to sync or average), so
    the collectives a larger world adds run here on their own, over this
    NCCL group and on the mesh step's gradients and loss terms: each leaves
    them bit-equal (a sum over one rank, divided by 1), and each is timed
    (ms a call, the mean of MESH_COLLECTIVE_CALLS). Then both Trainers timed
    in turns, plain, mesh, mesh, plain (ms/step, beside phase 13b's too;
    peak memory over the turns; 6 / 6 / 17 / 22 launches a mesh step).
    Returns the mesh steps' launch counts."""
    import torch
    import torch.distributed as dist

    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.parallel.mesh import (
        DATA_AXIS, average_gradients, average_scalars, make_mesh, replicated,
    )
    from mrfa_tpu_torch.train.trainer import Trainer

    bf16 = torch.bfloat16
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device_type="cuda")
        torch.manual_seed(SEED)
        weights = MRFA(vox1_cfg()).state_dict()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
        batches = [{k: smooth_frames(TRAIN_BATCH, FRAME_SIZE, gen, "cuda")
                    for k in ("source", "driving")}
                   for _ in range(1 + MESH_WARMUP_STEPS + 4 * MESH_TIMED_STEPS)]

        def first_step(mesh_):
            trainer = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED),
                              weights=weights, compute_dtype=bf16, mesh=mesh_)
            out = trainer.step(batches[0])
            buffers = {n: b.detach().cpu() for n, b in trainer.model.named_buffers()}
            return trainer, {k: v for k, v in out.items() if k != "gen"}, \
                _params_and_grads(trainer), buffers

        plain, want, ref, ref_buffers = first_step(None)
        lr = plain.optimizer.param_groups[0]["lr"]
        twin_trainer, twin_terms, twin, twin_buffers = first_step(None)
        del twin_trainer
        trainer, got, snap, buffers = first_step(mesh)
        errs = {}
        for label, terms, step, bufs in (("twin", twin_terms, twin, twin_buffers),
                                         ("mesh", got, snap, buffers)):
            check(all(np.isfinite(terms[k]) for k in want),
                  f"phase17a {label} loss terms not finite")
            check(terms == want, f"phase17a {label} loss terms: {terms} != {want}")
            check(all(torch.equal(bufs[n], b) for n, b in ref_buffers.items()),
                  f"phase17a {label}: BatchNorm buffers differ from the plain step's")
            errs[label] = _step_distance(ref, step, lr, f"phase17a {label}")
        print(f"phase17a against the plain step: mesh {errs['mesh']}; the plain twin "
              f"{errs['twin']}", flush=True)
        del ref, twin, snap, ref_buffers, twin_buffers, buffers
        check(trainer.group is None, "phase17a: a one-rank mesh Trainer took the synced path")
        group = mesh.get_group(DATA_AXIS)
        model = trainer.model
        grads = [p.grad.clone() for p in model.parameters() if p.grad is not None]
        weights_before = [t.clone() for t in (*model.parameters(), *model.buffers())]
        terms = {k: torch.tensor(v, device="cuda") for k, v in got.items()}
        collectives = {
            "replicated": lambda: replicated(model),
            "average_gradients": lambda: average_gradients(model.parameters(), group),
            "average_scalars": lambda: average_scalars(terms, group),
        }
        collective_ms = {}
        for name, call in collectives.items():
            call()  # NCCL sets up its communicator at the first call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_COLLECTIVE_CALLS):
                call()
            torch.cuda.synchronize()
            collective_ms[name] = (time.perf_counter() - t0) / MESH_COLLECTIVE_CALLS * 1e3
        averaged = average_scalars(terms, group)
        check(all(torch.equal(averaged[k], v) for k, v in terms.items()),
              "phase17a: average_scalars over one rank moved the loss terms")
        check(all(torch.equal(p.grad, g) for p, g in
                  zip([p for p in model.parameters() if p.grad is not None], grads)),
              "phase17a: average_gradients over one rank moved the gradients")
        check(all(torch.equal(a, b) for a, b in
                  zip((*model.parameters(), *model.buffers()), weights_before)),
              "phase17a: replicated over one rank moved the weights")
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        del grads, weights_before, terms, averaged
        # the mesh and the plain Trainer timed in turns (plain, mesh, mesh,
        # plain), MESH_TIMED_STEPS steps a turn, after MESH_WARMUP_STEPS each
        trainers = {"plain": plain, "mesh": trainer}
        batches = batches[1:]
        losses = [t.step(b) for t in trainers.values() for b in batches[:MESH_WARMUP_STEPS]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds = {"plain": [], "mesh": []}
        launches = dict.fromkeys(PER_STEP, 0)
        for i, label in enumerate(("plain", "mesh", "mesh", "plain")):
            turn = batches[MESH_WARMUP_STEPS + i * MESH_TIMED_STEPS:][:MESH_TIMED_STEPS]
            reset(kernels)
            t0 = time.perf_counter()
            losses += [trainers[label].step(b) for b in turn]
            torch.cuda.synchronize()
            seconds[label].append(time.perf_counter() - t0)
            if label == "mesh":
                launches = {k: launches.get(k, 0) + v for k, v in launch_counts(kernels).items()}
        n_steps = 2 * MESH_TIMED_STEPS
        for name, per_step in PER_STEP.items():
            check(launches[name] == per_step * n_steps,
                  f"phase17a {name} launches {launches[name]} != {per_step} x {n_steps}")
        check(all(np.isfinite(o[k]) for o in losses for k in o if k != "gen"), "phase17a loss")
        ms = {k: [t / MESH_TIMED_STEPS * 1e3 for t in v] for k, v in seconds.items()}
        result = {
            "phase": "mesh_nccl", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
            "world": 1, "backend": dist.get_backend(), "batch_per_rank": TRAIN_BATCH,
            "dtype": "bfloat16 policy, f32 masters", "tf32": False, "card": card,
            "steps_timed": n_steps, "ms_per_step": sum(ms["mesh"]) / 2,
            "samples_per_s": TRAIN_BATCH * 2e3 / sum(ms["mesh"]),
            "ms_per_step_by_turn": ms, "plain_ms_per_step": sum(ms["plain"]) / 2,
            "phase13b_ms_per_step": bf16_train["ms_per_step"],
            "collectives_one_rank_ms": collective_ms, "gradient_bytes": grad_bytes,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": {k: v / n_steps for k, v in launches.items()},
            "vs_plain_step": {"terms_and_buffers": "bit-equal", "lr": lr,
                              "grad_tol_over_max_g": BF16_STEP,
                              **{f"{label}_{k}": v for label, e in errs.items()
                                 for k, v in e.items() if k != "worst"}},
        }
        print("phase17a " + json.dumps(result))
        del trainer, plain, trainers, losses, batches, weights
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _moments_batch_norm():
    """BatchNorm's training statistics in one process from E[x] and
    E[x^2], in the arithmetic of its synced path (nn/norm.py), in place of
    `F.batch_norm`'s."""
    import torch

    from mrfa_tpu_torch.nn.norm import BatchNorm

    plain = BatchNorm.forward

    def forward(self, x):
        if not self.training:
            return plain(self, x)
        xc = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, mean2 = xc.mean((0, 2, 3)), (xc * xc).mean((0, 2, 3))
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var * (n / (n - 1)))
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        y = (xc - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)

    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = plain


def _hold_to_one_process(label: str, cfg, weights, batch, meshed, got, result) -> None:
    """Phase 17b's and 18a's gates, on rank 0: the mesh Trainer `meshed`'s
    first step `got` on the global `batch` against a one-process card step
    from `weights` (loss terms rtol 1e-4; each gradient and BatchNorm
    statistic within 1e-3 of the tensor's max |g| (1e-5 for the statistics)
    or twice (four times where that move exceeds the tensor's max |g|: a
    gradient of rounding noise) what the one-process step moves when its
    input frames move by 1e-6, when its BatchNorm takes the synced path's
    arithmetic (`_moments_batch_norm`: the 64 px f32 step is ill
    conditioned, and that rounding alone moves a few gradients past the
    input floor on the CPU) or, as phase 12a's second floor, when cuDNN is
    off). The readings go into `result`."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    def plain(b):
        trainer = Trainer(cfg, generator=torch.Generator().manual_seed(SEED + 21),
                          weights={k: v.clone() for k, v in weights.items()})
        return trainer, trainer.step(b)

    on_one, want = plain(batch)
    floors = []
    for i in range(3):
        noise = torch.Generator().manual_seed(SEED + 30 + i)
        floors.append(plain({k: v + 1e-6 * torch.randn(v.shape, generator=noise)
                             for k, v in batch.items()})[0])
    with _moments_batch_norm():
        floors.append(plain(batch)[0])
    with torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        floors.append(plain(batch)[0])
    for k in (k for k in want if k != "gen"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        check(np.isfinite(got[k]) and rel <= 1e-4, f"{label} loss {k}: rel {rel}")
        result[f"rel_err_{k}"] = rel
    mine = dict(meshed.model.named_parameters())
    floor_p = [dict(t.model.named_parameters()) for t in floors]
    ratios = []  # (err / tol, name, err, the floors' moves, 1e-3 max |g|)
    noise_class = []  # (err / the largest move, name, max |g|) of the 4x class
    for name, p in on_one.model.named_parameters():
        if p.grad is None:
            continue
        scale = max(float(p.grad.abs().max()), 1e-30)
        err = float((mine[name].grad - p.grad).abs().max())
        moves = [float((fp[name].grad - p.grad).abs().max()) for fp in floor_p]
        # a gradient that the floors move by more than its own size
        # is rounding noise (the conv biases that BatchNorm follows,
        # 0 in exact arithmetic): held within 4x the largest move
        noise = (4 if max(moves) >= scale else 2) * max(moves)
        ratios.append((err / max(1e-3 * scale, noise), name, err, moves, 1e-3 * scale))
        if max(moves) >= scale:
            noise_class.append((err / max(moves), name, scale))
    ratios.sort(reverse=True)
    noise_class.sort(reverse=True)
    result["grads_worst_err_over_tol"] = ratios[:5]
    # the readings behind the 4x rule: err over the largest move is
    # what 2x would hold to 2 and 4x holds to 4
    result["noise_class_grads"] = {"count": len(noise_class),
                                   "worst_err_over_largest_move": noise_class[:5]}
    print(f"{label} rank 0: {len(noise_class)} gradients moved by the floors beyond "
          f"their max |g|; worst err / largest move (name, max |g|): {noise_class[:5]}",
          flush=True)
    print(f"{label} rank 0 gradients: {len(ratios)} tensors; worst err / tol "
          f"(name, err, floors' moves: 3 inputs, moments BatchNorm, cuDNN off): "
          f"{ratios[:5]}", flush=True)
    for ratio, name, err, _, _ in ratios:
        check(ratio <= 1.0, f"{label} gradient of {name}: err / tol {ratio:.3f}")
    state, want_state = meshed.model.state_dict(), on_one.model.state_dict()
    floor_state = [t.model.state_dict() for t in floors]
    stat_err = 0.0
    for key, t in want_state.items():
        if key.endswith(("running_mean", "running_var")):
            err = float((state[key] - t).abs().max())
            noise = 2 * max(float((fs[key] - t).abs().max()) for fs in floor_state)
            check(err <= max(1e-5, noise), f"{label} statistic {key}: err {err:.3e}")
            stat_err = max(stat_err, err)
    result["bn_stats_max_abs_err"] = stat_err


def _gloo_rank(rank: int, port: int, out_dir: str) -> None:
    """Phase 17b, one rank of a gloo world of GLOO_RANKS on the one card
    (started by `torch.multiprocessing.spawn`): at phase 4's setup, one mesh
    step on this rank's rows of a global batch, held on rank 0 against a
    one-process card step on the global batch with phase 4's tolerances
    (`_hold_to_one_process`), the ranks' weights equal after the
    update; then config/vox1.yaml at 256 px
    under the bf16 policy, GLOO_BATCH rows a rank: ms/step and the launches
    a step. Writes its numbers to out_dir/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from mrfa_tpu_torch.ops import launches as launch_registry
    from mrfa_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, shard_batch
    from mrfa_tpu_torch.train.trainer import Trainer

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {k.name: k for k in launch_registry.kernels()}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=GLOO_RANKS)
    try:
        mesh = make_mesh(device_type="cuda")
        group = mesh.get_group(DATA_AXIS)
        result = {"rank": rank}
        cfg = small_cfg(losses=True)
        torch.manual_seed(SEED + 20)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random VGG19's warning
            meshed = Trainer(cfg, generator=torch.Generator().manual_seed(SEED + 21), mesh=mesh)
        weights = {k: v.clone() for k, v in meshed.model.state_dict().items()}
        batch = {k: smooth_frames(2 * GLOO_RANKS, 64, torch.Generator().manual_seed(SEED + i),
                                  "cpu") for i, k in enumerate(("source", "driving"), start=22)}
        reset(kernels)
        got = meshed.step(shard_batch(batch, mesh))
        counts = launch_counts(kernels)
        for name, per_step in PER_STEP.items():  # at 64 px fewer splats bin their samples
            check(counts[name] == per_step or name == "splat_bins",
                  f"phase17b rank {rank}: {name} launches {counts}")
        result["launches_64px"] = counts
        flat = torch.cat([p.detach().reshape(-1) for p in meshed.model.parameters()])
        first = flat.clone()
        dist.broadcast(first, src=0, group=group)
        result["weights_spread_64px"] = float((flat - first).abs().max())
        check(result["weights_spread_64px"] == 0.0, f"phase17b rank {rank}: weights differ")
        del flat, first
        if rank == 0:
            _hold_to_one_process("phase17b", cfg, weights, batch, meshed, got, result)
        del meshed, weights
        torch.cuda.empty_cache()

        torch.manual_seed(SEED)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED),
                              compute_dtype=torch.bfloat16, mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        n_steps = GLOO_WARMUP_STEPS + GLOO_TIMED_STEPS
        batches = [shard_batch({k: smooth_frames(GLOO_BATCH * GLOO_RANKS, FRAME_SIZE, gen, "cuda")
                                for k in ("source", "driving")}, mesh) for _ in range(n_steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        losses = [trainer.step(b) for b in batches[:GLOO_WARMUP_STEPS]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [trainer.step(b) for b in batches[GLOO_WARMUP_STEPS:]]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = launch_counts(kernels)
        for name, per_step in PER_STEP.items():
            check(counts[name] == per_step * n_steps,
                  f"phase17b rank {rank} 256 px: {name} launches {counts[name]}")
        check(all(np.isfinite(o[k]) for o in losses for k in o if k != "gen"), "phase17b loss")
        result.update({"launches_256px": counts, "ms_per_step": elapsed / GLOO_TIMED_STEPS * 1e3,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "steps_timed": GLOO_TIMED_STEPS, "loss_last": losses[-1]["loss"]})
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(result, f)
    except BaseException:
        # spawn reports the first rank to exit, and a rank that fails closes
        # the other's connections: print each rank's own failure
        import traceback

        print(f"phase17b rank {rank} failed:\n{traceback.format_exc()}", flush=True)
        raise
    finally:
        dist.destroy_process_group()


def phase_mesh_gloo(card, work: Path) -> dict:
    """Phase 17b: GLOO_RANKS processes on the one card over gloo
    (`_gloo_rank`). gloo moves CUDA tensors through the host, so its ms/step
    measures gloo over PCIe and the host, not NCCL between cards; a run over
    several GPUs is not verified here. Returns each rank's launch counts."""
    import gc

    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved()}
    out_dir = work / "gloo"
    out_dir.mkdir()
    mp.spawn(_gloo_rank, args=(_free_port(), str(out_dir)), nprocs=GLOO_RANKS, join=True)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(GLOO_RANKS)]
    result = {
        "phase": "mesh_gloo", "config": "config/vox1.yaml mtia", "size": FRAME_SIZE,
        "world": GLOO_RANKS, "backend": "gloo (one card, collectives through the host)",
        "batch_per_rank": GLOO_BATCH, "global_batch": GLOO_BATCH * GLOO_RANKS,
        "dtype": "bfloat16 policy, f32 masters", "tf32": False, "card": card,
        "ms_per_step_by_rank": [r["ms_per_step"] for r in ranks],
        "samples_per_s": GLOO_BATCH * GLOO_RANKS / (max(r["ms_per_step"] for r in ranks) / 1e3),
        "ranks": ranks, "parent_process_card_bytes": parent,
        "multi_gpu": "not verified (one card)",
    }
    print("phase17b " + json.dumps(result))
    return {f"mesh_gloo_rank{r['rank']}": {k: r["launches_64px"][k] + r["launches_256px"][k]
                                           for k in r["launches_64px"]} for r in ranks}


@contextlib.contextmanager
def _recorded_query_counts(seen: dict):
    """Append the BQ of every call of the lookup and its backward wrappers
    to seen["corr_lookup"] and seen["corr_lookup_bwd"]."""
    from mrfa_tpu_torch.ops.corr_lookup import CorrLookup, CorrLookupBwd

    calls = {cls: cls.__call__ for cls in (CorrLookup, CorrLookupBwd)}

    def recording(cls):
        def record(self, c0, *args):
            seen.setdefault(cls.name, []).append(c0.shape[0])
            return calls[cls](self, c0, *args)
        return record

    for cls in calls:
        cls.__call__ = recording(cls)
    try:
        yield
    finally:
        for cls, call in calls.items():
            cls.__call__ = call


def _check_query_counts(seen: dict, rows: int, size: int, steps: int, label: str,
                        backward: bool) -> None:
    """The lookups (and their backwards) of `steps` forwards of `rows` rows
    at `size` px each took half of each sample's queries."""
    want = [rows * nq // MODEL_RANKS for nq in QUERIES[size]]
    expect = {"corr_lookup": want * steps}
    if backward:
        expect["corr_lookup_bwd"] = want[::-1] * steps
    check(seen == expect, f"{label}: query counts {seen} != {expect}")


def _generated(model, source, driving):
    """The generated frames of an eval-mode `model` on (B, H, W, 3) frames
    on the card."""
    import torch

    with torch.no_grad():
        return model(source.permute(0, 3, 1, 2), driving.permute(0, 3, 1, 2),
                     compute_loss=False)[0]


def _forward_gate(got, want, label: str) -> float:
    """Max abs of the sharded forward's frames against the one-process
    forward's, gated by MODEL_AXIS_FORWARD_TOL."""
    import torch

    err = float((got - want).abs().max())
    tol = MODEL_AXIS_FORWARD_TOL[got.shape[-1]]
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{label} sharded eval forward: max abs {err:.3e} > {tol:.0e}")
    return err


def _spread(module) -> float:
    """The largest distance of this rank's parameters and buffers from
    global rank 0's."""
    import torch.distributed as dist

    worst = 0.0
    for t in module.state_dict().values():
        first = t.detach().clone()
        dist.broadcast(first, src=0)
        if t.numel():
            worst = max(worst, float((t.detach().double() - first.double()).abs().max()))
    return worst


def _model_axis_rank(rank: int, port: int, out_dir: str) -> None:
    """Phase 18, one rank of a 1x2 ("data", "model") mesh on the one card
    over gloo (started by `torch.multiprocessing.spawn`): both ranks hold
    the whole batch and half of each sample's correlation queries. (a) At
    phase 4's setup, f32: the sharded eval forward against a one-process
    forward from the same weights (MODEL_AXIS_FORWARD_TOL), one sharded
    `Trainer` step held on rank 0 to the one-process card step
    (`_hold_to_one_process`), the ranks' weights and buffers bit-equal.
    (b) config/vox1.yaml at 256 px: the sharded f32 eval forward at B=1
    against the one-process forward, then bf16 `Trainer` steps at batch
    TRAIN_BATCH (ms/step, peak memory, launches a step, the weights and
    buffers bit-equal after them) and, on rank 0, one-process bf16 steps
    (ms/step, peak memory). The lookups' query counts are read at the
    wrappers. Writes its numbers to out_dir/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.models.raft import shard_queries
    from mrfa_tpu_torch.ops import launches as launch_registry
    from mrfa_tpu_torch.parallel.mesh import data_shard, make_mesh, model_shard
    from mrfa_tpu_torch.train.trainer import Trainer

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {k.name: k for k in launch_registry.kernels()}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=MODEL_RANKS)
    try:
        mesh = make_mesh(1, MODEL_RANKS, device_type="cuda")
        check(data_shard(mesh) == (0, 1) and model_shard(mesh) == (rank, MODEL_RANKS),
              f"phase18 rank {rank}: mesh coordinates {data_shard(mesh)}, {model_shard(mesh)}")
        result = {"rank": rank, "launches": dict.fromkeys(launch_counts(kernels), 0)}

        def count(fn):  # fn() with its launches added to this rank's path
            reset(kernels)
            out = fn()
            for k, v in launch_counts(kernels).items():
                result["launches"][k] += v
            return out

        # (a) phase 4's setup, f32
        cfg = small_cfg(losses=True)
        torch.manual_seed(SEED + 20)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random VGG19's warning
            meshed = Trainer(cfg, generator=torch.Generator().manual_seed(SEED + 21), mesh=mesh)
        weights = {k: v.clone() for k, v in meshed.model.state_dict().items()}
        batch = {k: smooth_frames(2, 64, torch.Generator().manual_seed(SEED + i), "cpu")
                 for i, k in enumerate(("source", "driving"), start=22)}
        frames = [batch[k].cuda() for k in ("source", "driving")]
        meshed.model.eval()
        seen: dict = {}
        with _recorded_query_counts(seen):
            got = count(lambda: _generated(meshed.model, *frames))
        _check_query_counts(seen, 2, 64, 1, "phase18a eval", backward=False)
        plain = MRFA(cfg)
        plain.load_state_dict(weights)
        result["forward_64px_max_abs"] = _forward_gate(got, _generated(plain.eval(), *frames),
                                                       "phase18a")
        del plain, frames
        meshed.model.train()
        seen = {}
        with _recorded_query_counts(seen):
            got = count(lambda: meshed.step(batch))
        _check_query_counts(seen, 2, 64, 1, "phase18a step", backward=True)
        result["step_64px_bq"] = seen
        if rank == 0:
            _hold_to_one_process("phase18a", cfg, weights, batch, meshed, got, result)
        result["weights_spread_64px"] = _spread(meshed.model)
        check(result["weights_spread_64px"] == 0.0,
              f"phase18a rank {rank}: weights or buffers differ between the ranks")
        del meshed, weights
        torch.cuda.empty_cache()

        # (b) config/vox1.yaml at full width, 256 px
        torch.manual_seed(SEED)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED),
                              compute_dtype=torch.bfloat16, mesh=mesh)
        state = trainer.model.state_dict()  # f32 masters, replicated from rank 0
        sharded, plain = MRFA(vox1_cfg()), MRFA(vox1_cfg())
        for m in (sharded, plain):
            m.load_state_dict(state)
            m.eval()
        shard_queries(sharded, mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
        frames = [smooth_frames(1, FRAME_SIZE, gen, "cuda") for _ in range(2)]
        seen = {}
        with _recorded_query_counts(seen):
            got = count(lambda: _generated(sharded, *frames))
        _check_query_counts(seen, 1, FRAME_SIZE, 1, "phase18b eval", backward=False)
        result["forward_256px_max_abs"] = _forward_gate(got, _generated(plain, *frames),
                                                        "phase18b")
        del sharded, plain, frames, state, got
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        n_steps = MODEL_AXIS_WARMUP_STEPS + MODEL_AXIS_TIMED_STEPS
        batches = [{k: smooth_frames(TRAIN_BATCH, FRAME_SIZE, gen, "cuda")
                    for k in ("source", "driving")} for _ in range(n_steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        seen = {}
        with _recorded_query_counts(seen):
            losses = [trainer.step(b) for b in batches[:MODEL_AXIS_WARMUP_STEPS]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [trainer.step(b) for b in batches[MODEL_AXIS_WARMUP_STEPS:]]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        counts = launch_counts(kernels)
        for name, per_step in PER_STEP.items():
            check(counts[name] == per_step * n_steps,
                  f"phase18b rank {rank}: {name} launches {counts[name]} over {n_steps} steps")
            result["launches"][name] += counts[name]
        _check_query_counts(seen, TRAIN_BATCH, FRAME_SIZE, n_steps, "phase18b steps",
                            backward=True)
        check(all(np.isfinite(o[k]) for o in losses for k in o if k != "gen"), "phase18b loss")
        result.update({
            "ms_per_step": elapsed / MODEL_AXIS_TIMED_STEPS * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step_256px": {k: v / n_steps for k, v in counts.items()},
            "lookup_bq_per_step": seen["corr_lookup"][:6],
            "lookup_bwd_bq_per_step": seen["corr_lookup_bwd"][:6],
            "steps_timed": MODEL_AXIS_TIMED_STEPS, "loss_last": losses[-1]["loss"],
        })
        result["weights_spread_256px"] = _spread(trainer.model)
        check(result["weights_spread_256px"] == 0.0,
              f"phase18b rank {rank}: weights or buffers differ between the ranks after "
              f"{n_steps} bf16 steps")
        del trainer, losses
        torch.cuda.empty_cache()
        if rank == 0:  # the one-process bf16 step beside them, in this process alone
            torch.manual_seed(SEED)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                one = Trainer(vox1_cfg(), generator=torch.Generator().manual_seed(SEED),
                              compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            one.step(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[1:1 + MODEL_AXIS_PLAIN_STEPS]:
                one.step(b)
            torch.cuda.synchronize()
            result["one_process_ms_per_step"] = ((time.perf_counter() - t0)
                                                 / MODEL_AXIS_PLAIN_STEPS * 1e3)
            result["one_process_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            del one
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(result, f)
    except BaseException:
        import traceback

        print(f"phase18 rank {rank} failed:\n{traceback.format_exc()}", flush=True)
        raise
    finally:
        dist.destroy_process_group()


def phase_model_axis(card, work: Path) -> dict:
    """Phase 18: MODEL_RANKS processes on the one card over gloo, a 1x2
    ("data", "model") mesh (`_model_axis_rank`). gloo moves CUDA tensors
    through the host, so its ms/step measures gloo over PCIe and the host,
    not NCCL between cards. Returns each rank's launch counts."""
    import gc

    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = work / "model_axis"
    out_dir.mkdir()
    mp.spawn(_model_axis_rank, args=(_free_port(), str(out_dir)), nprocs=MODEL_RANKS, join=True)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(MODEL_RANKS)]
    result = {
        "phase": "model_axis", "config": "config/vox1.yaml mtia; phase 4's 64 px model",
        "size": FRAME_SIZE, "mesh": [1, MODEL_RANKS],
        "backend": "gloo (one card, collectives through the host)",
        "batch_per_rank": TRAIN_BATCH, "queries_per_rank": f"1/{MODEL_RANKS} of each sample's",
        "dtype": "f32 forwards; bfloat16 policy steps, f32 masters", "tf32": False, "card": card,
        "ms_per_step_by_rank": [r["ms_per_step"] for r in ranks],
        "peak_memory_bytes_by_rank": [r["peak_memory_bytes"] for r in ranks],
        "one_process_ms_per_step": ranks[0]["one_process_ms_per_step"],
        "one_process_peak_memory_bytes": ranks[0]["one_process_peak_memory_bytes"],
        "ranks": ranks, "multi_gpu": "not verified (one card)",
    }
    print("phase18 " + json.dumps(result))
    return {f"model_axis_rank{r['rank']}": r["launches"] for r in ranks}


def _check_replica_graphs(split, name: str) -> None:
    """Each replica of a split server holds a CUDA graph captured on its own
    device whose replay launches the frame step's 6 lookups."""
    for i, r in enumerate(split.replicas):
        graph = r._graph
        check(graph is not None and graph.input.device == r.device
              and graph.output.device == r.device,
              f"phase17c {name}: replica {i} has no graph on {r.device}")
        check(graph.launches["corr_lookup"] == 6,
              f"phase17c {name}: replica {i}'s graph replays {graph.launches}")


def _split_chunk_f32(kernels, split, one, sources, frames, frames_dev) -> dict:
    """Phase 17c's f32 `serve_chunk`: K=CHUNK frames of SPLIT_CHUNK_STREAMS
    streams over the split server's replicas, against the one-device
    server's eager `serve` of each share's streams, frame by frame
    (bit-equal); the replicas' graphs checked; frames that differ give
    frames that differ (a stale replay gives the capture's frame)."""
    import torch

    from mrfa_tpu_torch.animate import FrameGraph

    n, parts = SPLIT_CHUNK_STREAMS, len(SPLIT_DEVICES)
    stack = frames_dev[:CHUNK, :n]
    state = split.open_streams(sources[:n], frames[0][:n])
    reset(kernels)
    got = split.serve_chunk(state, stack)
    counts = launch_counts(kernels)
    check(counts["corr_lookup"] == 6 * parts * (FrameGraph.WARMUP_STEPS + CHUNK),
          f"phase17c f32 serve_chunk: {counts['corr_lookup']} lookups")
    _check_replica_graphs(split, "float32")
    check(all(float((got[k] - got[0]).abs().max()) > 0 for k in range(1, CHUNK)),
          "phase17c f32 serve_chunk: frames that differ gave equal frames")
    want = []
    for i in range(parts):
        rows = slice(i * n // parts, (i + 1) * n // parts)
        st = one.open_streams(sources[rows], frames[0][rows])
        want.append(torch.stack([one.serve(st, f[rows]) for f in stack]))
    err = float((got - torch.cat(want, dim=1)).abs().max())
    check(err == 0.0, f"phase17c f32 split serve_chunk differs from the shares' serve by {err}")
    return {"chunk_streams": n, "chunk_max_abs_vs_one_device_shares": err}


def phase_split_server(kernels, card, server_results) -> dict:
    """Phase 17c: `AnimationServer(devices=SPLIT_DEVICES)` at
    SPLIT_STREAMS streams (config/vox1.yaml's model, 256 px, random weights
    from the seed) against a one-device server of the same streams: in f32
    one `serve` step (max abs 1e-4, SERVER_ANIMATOR_TOL), and a K=CHUNK
    `serve_chunk` of SPLIT_CHUNK_STREAMS streams (each share small enough
    to stay out of cuDNN's FFT-tiled convolution) bit-equal to the
    one-device server's eager `serve` on each share's streams (the same
    kernels at the same shapes, as phase 3c holds a graph to its eager
    frames); under the bf16 policy `serve` and `serve_chunk` (K=CHUNK) at
    S=SPLIT_STREAMS within SPLIT_BF16_MEAN_TOL mean and SPLIT_BF16_MAX_TOL
    max, timed (stream-frames/s beside phase 11b's S=8). Each replica's
    graph is captured on its own device and replays 6 lookups; 6 lookups a
    step on each device. Returns the launch counts by path."""
    import torch

    from mrfa_tpu_torch.animate import FrameGraph
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.serving import AnimationServer

    torch.manual_seed(SEED)
    weights = MRFA(vox1_cfg()).state_dict()
    gen = torch.Generator().manual_seed(SEED + 90)
    sources = smooth_frames(SPLIT_STREAMS, FRAME_SIZE, gen, "cpu").numpy()
    n_steps = SERVER_WARMUP + SERVER_TIMED
    frames = smooth_frames((1 + n_steps) * SPLIT_STREAMS, FRAME_SIZE, gen, "cpu").numpy()
    frames = frames.reshape(-1, SPLIT_STREAMS, FRAME_SIZE, FRAME_SIZE, 3)
    frames_dev = torch.from_numpy(frames[1:]).cuda()
    paths, result = {}, {"phase": "split_server", "config": "config/vox1.yaml mtia",
                         "size": FRAME_SIZE, "streams": SPLIT_STREAMS,
                         "devices": list(SPLIT_DEVICES), "tf32": False, "card": card,
                         "multi_gpu": "not verified (one card)"}
    for compute_dtype in (None, torch.bfloat16):
        name = dtype_name(compute_dtype or torch.float32)
        one = AnimationServer(MRFA(vox1_cfg(), compute_dtype=compute_dtype), weights)
        split = AnimationServer(MRFA(vox1_cfg(), compute_dtype=compute_dtype), weights,
                                devices=list(SPLIT_DEVICES))
        want_state = one.open_streams(sources, frames[0])
        state = split.open_streams(sources, frames[0])
        reset(kernels)
        got = split.serve(state, frames_dev[0])
        counts = launch_counts(kernels)
        check(counts["corr_lookup"] == 6 * len(SPLIT_DEVICES),
              f"phase17c {name}: {counts['corr_lookup']} lookups, not 6 on each device")
        want = one.serve(want_state, frames_dev[0])
        diff = (got - want).abs()
        entry = {"serve_max_abs": float(diff.max()), "serve_mean_abs": float(diff.mean())}
        if compute_dtype is None:
            check(entry["serve_max_abs"] <= SERVER_ANIMATOR_TOL,
                  f"phase17c f32 split serve differs by {entry['serve_max_abs']}")
            entry.update(_split_chunk_f32(kernels, split, one, sources, frames, frames_dev))
            result[name] = entry
            del one, split, state, want_state
            continue
        check(entry["serve_mean_abs"] <= SPLIT_BF16_MEAN_TOL
              and entry["serve_max_abs"] <= SPLIT_BF16_MAX_TOL,
              f"phase17c bf16 split serve differs by {entry['serve_mean_abs']} mean, "
              f"{entry['serve_max_abs']} max")
        reset(kernels)
        for f in frames_dev[:SERVER_WARMUP]:
            split.serve(state, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames_dev[SERVER_WARMUP:]:
            split.serve(state, f)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stack = frames_dev[SERVER_WARMUP:]
        split.serve_chunk(state, stack[:CHUNK])  # the captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = [split.serve_chunk(state, stack[i:i + CHUNK])
                  for i in range(0, SERVER_TIMED, CHUNK)]
        torch.cuda.synchronize()
        chunk_elapsed = time.perf_counter() - t0
        paths["split_server_bf16"] = launch_counts(kernels)
        # each replica's steps: serve's, its graph's warm-up and capture
        # chunk, the timed chunks
        steps = n_steps + FrameGraph.WARMUP_STEPS + CHUNK + SERVER_TIMED
        check(paths["split_server_bf16"]["corr_lookup"] == 6 * len(SPLIT_DEVICES) * steps,
              f"phase17c bf16: {paths['split_server_bf16']} over {steps} steps on each device")
        _check_replica_graphs(split, name)
        want_chunk = torch.cat([one.serve_chunk(want_state, stack[i:i + CHUNK])
                                for i in range(0, SERVER_TIMED, CHUNK)])
        chunk_diff = (torch.cat(chunks) - want_chunk).abs()
        check(float(chunk_diff.mean()) <= SPLIT_BF16_MEAN_TOL
              and float(chunk_diff.max()) <= SPLIT_BF16_MAX_TOL,
              f"phase17c bf16 split serve_chunk differs by {float(chunk_diff.mean())} mean, "
              f"{float(chunk_diff.max())} max")
        s8 = server_results[f"server_s{SPLIT_STREAMS}_{name}"]
        entry.update({
            "serve_stream_frames_per_s": SPLIT_STREAMS * SERVER_TIMED / elapsed,
            "chunk_stream_frames_per_s": SPLIT_STREAMS * SERVER_TIMED / chunk_elapsed,
            "phase11b_serve_stream_frames_per_s": s8["serve_stream_frames_per_s"],
            "phase11b_chunk_stream_frames_per_s": s8["chunk_stream_frames_per_s"],
            "chunk_max_abs": float(chunk_diff.max()), "chunk_mean_abs": float(chunk_diff.mean()),
            "lookups_per_step_per_device": 6,
        })
        result[name] = entry
        del one, split, state, want_state, chunks, want_chunk
    print("phase17c " + json.dumps(result))
    torch.cuda.empty_cache()
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    from mrfa_tpu_torch.ops import launches
    from mrfa_tpu_torch.ops.cuda_build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    kernels = {k.name: k for k in launches.kernels()}

    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"elapsed {time.perf_counter() - t_start:.1f} s: {what}", flush=True)

    build_all([k.library for k in kernels.values()])
    for name, k in kernels.items():
        k.library.load()
        print(f"build {name}: {k.library.build_seconds} s (None = already built)")
        for line in k.library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    stamp("kernels built")

    errs = phase_kernels(kernels, device)
    stamp("phase 1")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    # phases 17b and 18 now, while this process holds little of the card's
    # memory: their two ranks share the card with it
    work = Path(tempfile.mkdtemp(prefix="smoke_run_", dir=build))
    try:
        gloo_paths = phase_mesh_gloo(card, work)
        stamp("phase 17b")
        gloo_paths.update(phase_model_axis(card, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stamp("phase 18")
    phase_gpu_vs_cpu()
    phase_gpu_vs_cpu(prior_only=True)
    phase_gpu_vs_cpu_bf16()
    stamp("phase 2")
    clip = serving_clip()
    animator, state, f32_outs, serve_launches = phase_serving(kernels, card, clip)
    paths = {"serving": serve_launches}
    bf16_animator, bf16_state, bf16_outs, paths["serving_bf16"] = phase_serving_bf16(
        kernels, card, clip, animator, f32_outs)
    paths["chunk"] = phase_chunk(kernels, animator, state, clip, f32_outs, "chunk")
    paths["chunk_bf16"] = phase_chunk(kernels, bf16_animator, bf16_state, clip, bf16_outs,
                                      "chunk_bf16")
    paths["best_frame"] = phase_best_frame(kernels, animator, clip)
    paths["prior_only"] = phase_prior_only(kernels, card, clip)
    del f32_outs, bf16_outs
    stamp("phase 3")
    phase_train_gpu_vs_cpu()
    stamp("phase 4")
    trainer, batch, paths["training"], _ = phase_train_full_width(kernels, card)
    stamp("phase 5")
    phase_learning()
    stamp("phase 6")
    paths["probes"] = phase_probes(kernels, device)
    stamp("phase 9")
    times, sums = phase_timing(kernels, device)
    stamp("phase 7")
    f32_fft = phase_profile([("serving", animator, state),
                             ("serving_bf16", bf16_animator, bf16_state)], clip[2], trainer, batch)
    stamp("phase 8")
    del trainer, batch, animator, state, bf16_animator, bf16_state
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="smoke_run_", dir=build))
    try:
        celeb, celeb_cfg, loop_paths = phase_loop_celebvhq(kernels, card, work)
        paths.update(loop_paths)
        stamp("phase 10a")
        phase_pth_import(celeb, celeb_cfg, work)
        del celeb
        torch.cuda.empty_cache()
        paths["loop_vox1"] = phase_loop_vox1(kernels, card, work)
        stamp("phase 10b")
        phase_train_gpu_vs_cpu(use_bg=True)
        stamp("phase 10c")
        phase_reconstruction_gpu_vs_cpu(work)
        model, paths["reconstruction"] = phase_reconstruction(kernels, card, work)
        paths["animate"] = phase_animate(kernels, card, model, work)
        del model
        stamp("phase 10")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_server_gpu_vs_cpu()
    stamp("phase 11a")
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(SEED)
    weights = MRFA(vox1_cfg()).state_dict()
    server_results = {}
    for compute_dtype in (None, torch.bfloat16):
        server_paths, results = phase_server(kernels, card, weights, compute_dtype)
        paths.update(server_paths)
        server_results.update(results)
    del weights
    stamp("phase 11b")
    for prior in ("fomm", "tpsm"):
        phase_gpu_vs_cpu(prior=prior)
        phase_train_gpu_vs_cpu(prior=prior)
    stamp("phase 12a")
    for prior in ("fomm", "tpsm"):
        paths.update(phase_prior(kernels, card, clip, prior))
    stamp("phase 12b")
    del clip
    torch.cuda.empty_cache()
    phase_train_bf16_gpu_vs_cpu()
    stamp("phase 13a")
    trainer, batch, paths["training_bf16"], bf16_train = phase_train_bf16_full_width(kernels,
                                                                                      card)
    stamp("phase 13b")
    work = Path(tempfile.mkdtemp(prefix="smoke_run_", dir=build))
    try:
        phase_profiling(trainer, batch, work, f32_fft, card)
        del trainer, batch
        torch.cuda.empty_cache()
        stamp("phase 16")
        phase_learning_bf16(card)
        stamp("phase 13c")
        paths.update(phase_data_from_files(kernels, card, work))
        stamp("phase 14")
        paths.update(phase_clis(kernels, card, work))
        stamp("phase 15")
        paths["mesh_nccl"] = phase_mesh_nccl(kernels, card, bf16_train)
        stamp("phase 17a")
        paths.update(gloo_paths)
        paths.update(phase_split_server(kernels, card, server_results))
        stamp("phase 17c")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    f32, bf16 = torch.float32, torch.bfloat16
    big = TRAIN_LOOKUP_BQS[-1]
    entries = []
    for name, source, replaces, also, key in (
        ("corr_lookup", "corr_lookup.cu", "mrfa_tpu/ops/pallas_kernels.py:755",
         "mrfa_tpu/ops/pallas_kernels.py:89", ("corr_lookup", big)),
        ("corr_lookup_bwd", "corr_lookup_bwd.cu", "mrfa_tpu/ops/pallas_kernels.py:432",
         "mrfa_tpu/ops/pallas_kernels.py:574", ("corr_lookup_bwd",)),
        ("splat", "splat.cu", "mrfa_tpu/ops/pallas_splat.py:72", None, ("splat",)),
        ("corr_lookup_pooled_bwd", "corr_lookup_pooled_bwd.cu",
         "mrfa_tpu/ops/pallas_kernels.py:247", None, ("corr_lookup_pooled_bwd",)),
        ("stream_probe", "stream_probe.cu", "tools/probe_stream.py:61",
         "tools/probe_stream.py:90", ("stream_probe", STREAM_BQ)),
    ):
        row = times[(key[0], f32, *key[1:])]
        by_path = {path: counts[name] for path, counts in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": f"mrfa_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": errs[f32][name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "launches_by_path": by_path,
        }
        row16 = times.get((key[0], bf16, *key[1:]))
        if row16 is not None:
            entry.update({
                "max_abs_err_bf16": errs[bf16][name], "ms_bf16": row16["ms"],
                "plain_ms_bf16": row16["plain_ms"], "bound_ms_bf16": row16["bound_ms"],
                "library_ms_bf16": row16["library_ms"],
            })
        if also:
            entry["also_replaces"] = also
        if name == "splat":
            entry["bin_launches_by_path"] = {path: c["splat_bins"] for path, c in paths.items()}
        if name == "stream_probe":
            # library_ms: the torch.stack of the kept corners (equal output,
            # fewer bytes); library_same_bytes_ms: l0.sum(); l1.sum()
            entry["library_same_bytes_ms"] = row["library_same_bytes_ms"]
            entry["bq16384"] = {k: v for k, v in times[("stream_probe", f32, 16384)].items()
                                if k != "shape"}
        if name == "corr_lookup":
            for label, bq in (("serving_bq4096", LOOKUP_BQS[-1]),
                              ("server_bq16384", SERVER_BQ),
                              ("eval_bq32768", EVAL_LOOKUP_BQS[-1])):
                at = times[("corr_lookup", f32, bq)]
                entry[label] = {k: at[k] for k in
                                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        entries.append(entry)
    # the splat and lookup forward summed over each path's shapes (phase 7)
    print(json.dumps({"kernels": entries, "sums": sums}))
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} gate(s) failed: " + "; ".join(FAILED), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
