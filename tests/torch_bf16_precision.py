"""How far the bf16 serving policy's outputs sit from the f32 outputs, in the
port and in the JAX package, on the setup of tests/test_torch_serving.py
(MTIA, 3-block hourglasses, 1-layer TokenPose, every width the flagship's).

Run from the repository root (CPU; ~10 minutes at 64 px, ~25 at 128 px):

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_precision [--size 64] [--seeds 0 3]

It prints one line per reading, each distance a (max abs, mean abs) pair of
the bf16 output against the f32 output of the same input, and the port's
over the JAX package's:
  - each module fed the f32 outputs of the modules before it (keypoints,
    dense motion, RaftFlow), on a white-noise frame;
  - whole frames through `Animator`, driving frames 0-4 of a white-noise and
    of a smooth clip, for each weight seed, and the range of the ratios;
  - the JAX package's own spread: one white-noise frame through its
    `Animator` (begin and frame step as separate jitted programs) and
    through one jitted program of the same step, beside the port.
"""
from __future__ import annotations

import tests.conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mrfa_tpu import precision as jprecision
from mrfa_tpu.animate import normalize_kp as jnormalize_kp
from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.ops.resize import AntiAliasParams
from mrfa_tpu.ops.resize import antialias_downsample as jdownsample
from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.models.mrfa import MRFA
from tests.test_torch_serving import (
    OUTPUTS,
    _dist,
    _frame,
    _variables,
    bf16_frame_distances,
    bf16_module_distances,
    jax_policy,
)
from tests.torch_parity import image, mtia_cfg, smooth_image

FRAMES = (0, 1, 2, 3, 4)


def _pair(port, jax_) -> str:
    return (f"port ({port[0]:.3e}, {port[1]:.3e}) jax ({jax_[0]:.3e}, {jax_[1]:.3e}) "
            f"ratio mean {port[1] / jax_[1]:.2f} max {port[0] / jax_[0]:.2f}")


def jax_one_program(cfg, variables, source, driving, t: int, dtype):
    """The generated frame of driving[t] through one jitted program of the
    Animator's whole step: keypoints, relative motion, source cache, dense
    motion, RaftFlow."""
    jmodel = JMRFA(cfg)

    def step(m, s, d0, d):
        kps, kd0, kpd = m.encode_kp(s), m.encode_kp(d0), m.encode_kp(d)
        kpn = jnormalize_kp(kps, kpd, kd0, adapt_movement_scale=1.0,
                            use_relative_movement=True, use_relative_jacobian=True)
        down = jdownsample(s, AntiAliasParams.create(0.25))
        cache = m.encode_source_cache(s, kps, down)
        dm = m.run_dense_motion(s, kpn, kps, None, False, 0.0, False)
        return m.decoder(m.kp_for_decoder(kps), m.kp_for_decoder(kpn), dm, img=down,
                         img_full=s, train=False, source_cache=cache)[0]

    with jax_policy(dtype):
        v = variables if dtype is None else jprecision.cast_params_for_inference(variables)
        out = jax.jit(lambda v: jmodel.apply(
            v, jnp.asarray(source[None]), jnp.asarray(driving[:1]), jnp.asarray(driving[t:t + 1]),
            method=step))(v)
    return np.asarray(out[0], dtype=np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 3])
    args = parser.parse_args(argv)
    cfg = mtia_cfg(args.size, blocks=3, depth=1)
    noise = image(1, args.size, seed=1)[0], image(5, args.size, seed=2)
    smooth = smooth_image(1, args.size, seed=1)[0], smooth_image(5, args.size, seed=2)

    variables = _variables(cfg, seed=args.seeds[0])
    for k, (port, jax_, f32) in bf16_module_distances(cfg, variables, noise[0],
                                                      noise[1][1]).items():
        print(f"module {k}: {_pair(port, jax_)} (f32 port vs jax {f32:.1e})", flush=True)

    ratios = {}
    for seed in args.seeds:
        variables = _variables(cfg, seed=seed)
        distances = bf16_frame_distances(cfg, variables, {"noise": noise, "smooth": smooth},
                                         FRAMES)
        for (kind, t, name), (port, jax_, f32) in distances.items():
            print(f"frame seed {seed} {kind} t{t} {name}: {_pair(port, jax_)} "
                  f"(f32 port vs jax {f32:.1e})", flush=True)
            ratios.setdefault(kind, []).append((port[1] / jax_[1], port[0] / jax_[0]))
    for kind, r in ratios.items():
        mean, worst = np.array(r).T
        print(f"frames {kind} at {args.size} px: ratio mean {mean.min():.2f}-{mean.max():.2f}, "
              f"max {worst.min():.2f}-{worst.max():.2f} over {len(r)} readings")

    variables = _variables(cfg, seed=args.seeds[0])
    source, driving = noise
    whole = [jax_one_program(cfg, variables, source, driving, 1, d) for d in (None, jnp.bfloat16)]
    port = [_frame(Animator(MRFA(cfg, device="cpu", compute_dtype=d), variables, device="cpu"),
                   source, driving)[0] for d in (None, torch.bfloat16)]
    split = bf16_frame_distances(cfg, variables, {"noise": noise})["noise", 1, OUTPUTS[0]]
    print(f"JAX spread, noise t1 generated, bf16 vs f32 mean abs: Animator "
          f"{split[1][1]:.3e}, one jitted program {_dist(whole[1], whole[0])[1]:.3e}; "
          f"port {_dist(port[1], port[0])[1]:.3e}")


if __name__ == "__main__":
    main()
