#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every hand-written CUDA kernel of the port from the sources in
`mrfa_tpu_torch/csrc/` (nvcc, sm_90a, one process per source, all at once)
and runs these phases; any failure exits non-zero:

  1. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, in f32 and bf16: the lookup forward at the serving and
     the training query counts (bit-exact in f32) and at one count that is
     no multiple of its block's eight queries, the lookup backward at the
     training ones, the splat at the shapes of the training step's feature
     warps on noisy, smooth, wild and collapsing flows (its bins equal to
     `splat_bins_plain`'s as sets), the pooled lookup backward at the
     probes' query counts, the streaming probe (f32, both variants) at the
     stream probe's;
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
     of bytes over the memory rate and operations over the f32 rate); the
     splat at all six shapes and the lookup at all eight query counts, with
     the sums of launches x ms against launches x bound, training per step
     and serving per frame (`mrfa_tpu_torch/tools/kernel_times.py`);
  8. a torch.profiler breakdown of a few frames (f32 and bf16), of one
     `animate_chunk` call of each (its traced lookup kernels equal to the
     graph's counted launches) and of one training step;
  9. the probes of the pooled lookup (`mrfa_tpu_torch.tools.probe_lookup`
     and `probe_stream`, at their default sizes), with the launch counts of
     the pooled backward and the streaming kernels read from them alone.

Stdout ends with a `{"kernels": [...], "sums": {...}}` line, the card's name and power limit
(as nvidia-smi reports them) and, last, `{"ok": true, "device": {...}}`.
TF32 is off throughout (cuDNN and matmul): the port runs at f32.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
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
    from mrfa_tpu_torch.ops.splat import splat_bins_plain, splat_plain
    from mrfa_tpu_torch.ops.stream_probe import stream_probe_plain
    from mrfa_tpu_torch.tools.kernel_times import (
        FLOWS,
        SPLAT_SHAPES,
        TRAIN_BATCH,
        lookup_inputs,
        splat_inputs,
    )

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst = {"corr_lookup": 0.0, "corr_lookup_bwd": 0.0, "splat": 0.0}
        # the main paths' query counts, and one that is no multiple of the
        # kernel's eight queries a block
        for i, bq in enumerate(LOOKUP_BQS + TRAIN_LOOKUP_BQS + (4099,)):
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
    # the streaming probe (f32 only), both variants, bit-exact
    c0, c1, _ = lookup_inputs(STREAM_BQ, torch.float32, device, seed=SEED + 300)
    levels = (c0.reshape(-1, MAP_SIZE), c1.reshape(-1, MAP_SIZE // 2))
    for second in (levels[1], None):
        got = k["stream_probe"](levels[0], second, STREAM_BQ, STREAM_QB)
        want = stream_probe_plain(levels[0], second, STREAM_BQ, STREAM_QB)
        torch.cuda.synchronize()
        variant = "l0+l1" if second is not None else "l0"
        err = float((got - want).abs().max())
        print(f"phase1 stream_probe float32 bq={STREAM_BQ} qb={STREAM_QB} {variant}: "
              f"shape={tuple(got.shape)} bit_exact={bool(torch.equal(got, want))}")
        check(torch.equal(got, want), f"stream_probe {variant} not bit-exact: {err}")
    errs[torch.float32]["stream_probe"] = 0.0
    return errs


def small_cfg(size=64, blocks=3, depth=1, losses=False):
    """The flagship MTIA model cut to 64 px, 3-block hourglasses and a 1-layer
    TokenPose; every width as in config/vox1.yaml. With `losses`, the
    training losses of vox1.yaml cut to scales [1, 0.25]."""
    cfg = {
        "train_params": {"prior_model": "mtia", "num_epochs": 100, "bg_start": 1000},
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
    return cfg


def smooth_frames(b: int, size: int, gen, device, side: int = 8):
    """(B, size, size, 3) low-frequency frames in [0, 1]: side x side random
    images bilinearly upsampled, made on `device` from the generator."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand(b, 3, side, side, generator=gen, device=device)
    img = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=True)
    return img.permute(0, 2, 3, 1).contiguous()


def phase_gpu_vs_cpu(prior_only: bool = False):
    """Phase 2: the frame step on the card against the port's CPU path."""
    import torch

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = small_cfg()
    cfg["raft_flow"]["prior_only"] = prior_only
    torch.manual_seed(SEED)
    cpu_model = MRFA(cfg, device="cpu")
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
    for name, g, w in zip(("generated", "warped", "occlusion"), got, want):
        err = float((g.cpu() - w).abs().max())
        print(f"phase2 frame gpu-vs-cpu{' prior_only' * prior_only} {name}: "
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


def _trainer_pair_step(cfg, seed, with_gpu=True):
    """A Trainer on the CPU and one on the card with the same weights and
    equivariance transforms (the same CPU generator seed), and a batch."""
    import torch

    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(seed)
    on_cpu = Trainer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    on_gpu = None
    if with_gpu:
        weights = {k: v.clone() for k, v in on_cpu.model.state_dict().items()}
        on_gpu = Trainer(cfg, generator=torch.Generator().manual_seed(seed + 1), weights=weights)
    batch = {k: smooth_frames(2, 64, torch.Generator().manual_seed(seed + i), "cpu")
             for i, k in enumerate(("source", "driving"), start=2)}
    return on_cpu, on_gpu, batch


def phase_train_gpu_vs_cpu():
    """Phase 4: one training step on the card against the port's CPU path:
    loss terms (rtol 1e-4), the generated frames, every gradient (before
    Adam, after clipping) and the BatchNorm running statistics.

    The randomly initialized network in train mode is sensitive at f32: a
    1e-6 change of its input moves deep gradients by tens of percent (see
    PERF.md). So beside 1e-3 of each tensor's largest |g| (1e-4 and 1e-5 for
    the frames and the statistics), the card may differ from the CPU by
    twice as much as the CPU's own step moves when the input frames move by
    1e-6 (the largest of three such moves)."""
    import torch

    cfg = small_cfg(losses=True)
    on_cpu, on_gpu, batch = _trainer_pair_step(cfg, SEED + 20)
    want = on_cpu.step(batch)
    got = on_gpu.step(batch)
    floors = []
    for i in range(3):
        noisy, _, _ = _trainer_pair_step(cfg, SEED + 20, with_gpu=False)
        gen = torch.Generator().manual_seed(SEED + 30 + i)
        moved = {k: v + 1e-6 * torch.randn(v.shape, generator=gen) for k, v in batch.items()}
        floors.append((noisy, noisy.step(moved)))

    def floor(fn):
        return 2 * max(fn(trainer, out) for trainer, out in floors)

    for k in ("loss", "perceptual", "equivariance", "equivariance_jacobian"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        print(f"phase4 train gpu-vs-cpu {k}: gpu={got[k]:.7f} cpu={want[k]:.7f} "
              f"rel_err={rel:.3e} (tol 1e-4)")
        check(np.isfinite(got[k]) and rel <= 1e-4, f"train step loss {k} disagrees: {rel}")
    gen_err = float((got["gen"].cpu() - want["gen"]).abs().max())
    gen_tol = max(1e-4, floor(lambda t, o: float((o["gen"] - want["gen"]).abs().max())))
    print(f"phase4 train gpu-vs-cpu generated: max_abs_err={gen_err:.3e} (tol {gen_tol:.3e})")
    check(gen_err <= gen_tol, "train step generated frames disagree")
    cpu_p = dict(on_cpu.model.named_parameters())
    floor_p = [dict(t.model.named_parameters()) for t, _ in floors]
    worst, n_grads, n_floor = (0.0, ""), 0, 0
    for name, p in on_gpu.model.named_parameters():
        if p.grad is None:
            continue
        n_grads += 1
        w = cpu_p[name].grad
        scale = max(float(w.abs().max()), 1e-30)
        err = float((p.grad.cpu() - w).abs().max())
        noise = 2 * max(float((fp[name].grad - w).abs().max()) for fp in floor_p)
        tol = max(1e-3 * scale, noise)
        check(err <= tol, f"gradient of {name}: err {err:.3e} > tol {tol:.3e}")
        worst = max(worst, (err / tol, name))
        n_floor += err > 1e-3 * scale
    print(f"phase4 train gpu-vs-cpu gradients: {n_grads} tensors, {n_floor} of them beyond "
          f"1e-3 of their max |g| and inside the input-1e-6 floor; worst err / tol = "
          f"{worst[0]:.3e} ({worst[1]})")
    cpu_state = on_cpu.model.state_dict()
    floor_state = [t.model.state_dict() for t, _ in floors]
    worst = 0.0
    for key, t in on_gpu.model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            err = float((t.cpu() - cpu_state[key]).abs().max())
            noise = 2 * max(float((fs[key] - cpu_state[key]).abs().max()) for fs in floor_state)
            check(err <= max(1e-5, noise), f"BatchNorm statistic {key}: err {err:.3e}")
            worst = max(worst, err)
    print(f"phase4 train gpu-vs-cpu BatchNorm running statistics: max_abs_err={worst:.3e}")


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
        SPLAT_SHAPES,
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
        time_shapes,
    )
    from mrfa_tpu_torch.tools.probe_lookup import pooled_bwd_bytes, pooled_bwd_flops

    flush = make_flush(device)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for bq in (LOOKUP_BQS[-1], TRAIN_LOOKUP_BQS[-1]):
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
    # the streaming probe (f32) at the stream probe's BQ, both levels
    c0, c1, _ = lookup_inputs(STREAM_BQ, torch.float32, device, seed=SEED + 13)
    l0, l1 = c0.reshape(-1, MAP_SIZE), c1.reshape(-1, MAP_SIZE // 2)
    nb, n = STREAM_BQ // STREAM_QB, 8 * STREAM_QB
    views = [lv.view(nb, lv.shape[0] // nb, lv.shape[1])[:, :n, :8] for lv in (l0, l1)]
    lib = lambda: torch.stack(views).view(2, STREAM_BQ * 8, 8)  # noqa: E731
    check(torch.equal(lib(), stream_probe_plain(l0, l1, STREAM_BQ, STREAM_QB)), "slice copy")
    row = {
        "shape": f"bq={STREAM_BQ} {MAP_SIZE}x{MAP_SIZE} qb={STREAM_QB}",
        "ms": cuda_ms(lambda: k["stream_probe"](l0, l1, STREAM_BQ, STREAM_QB), 20, flush),
        "plain_ms": cuda_ms(lambda: stream_probe_plain(l0, l1, STREAM_BQ, STREAM_QB), 10, flush),
        # one torch.stack of the two strided views (yardstick only); it reads
        # only the kept corners, where the probe reads every byte
        "library_ms": cuda_ms(lib, 10, flush),
        # the probe's function is to read every byte of both levels
        **bound((l0.numel() + l1.numel()) * 4 + 2 * STREAM_BQ * 8 * 8 * 4, 0),
    }
    print(f"phase7 stream_probe float32 {row['shape']}: " + json.dumps(row))
    rows[("stream_probe", torch.float32)] = row
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
    operators with the most device time, by input shape."""
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
    return by_name


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
        by_name = _profile(lambda: animator.animate_chunk(state, stack), 1,
                           f"phase8 chunk {label}", f"chunk_{label}_trace.json")
        seen = sum(c for name, (_, c) in by_name.items() if "corr_lookup_kernel" in name)
        counted = CHUNK * animator._graph.launches["corr_lookup"]
        print(f"phase8 chunk {label}: {seen} lookup kernels traced in {CHUNK} replays, "
              f"{counted} counted")
        check(seen == counted == 6 * CHUNK,
              f"chunk {label}: {seen} lookups traced, {counted} counted, want {6 * CHUNK}")
    _profile(lambda: trainer.step(batch), 1, "phase8 training", "step_trace.json", by_op=True)


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
    phase_profile([("serving", animator, state), ("serving_bf16", bf16_animator, bf16_state)],
                  clip[2], trainer, batch)
    stamp("phase 8")

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
         "tools/probe_stream.py:90", ("stream_probe",)),
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
        if name == "corr_lookup":
            serve = times[("corr_lookup", f32, LOOKUP_BQS[-1])]
            entry["serving_bq4096"] = {k: serve[k] for k in
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
