"""How far the port's f32 frame and training step sit from their own f64
values under each prior, on the CPU, at the setup of `chip_smoke.py`'s
phases 2, 4 and 12a (64 px, 3-block hourglasses, the same seeds), with and
without `chip_smoke.condition_prior` (which spreads the random TPSM
detector's keypoints).

Run from the repository root (CPU, ~2 minutes; no JAX):

    python -m tests.torch_prior_precision [--priors mtia fomm tpsm]

It prints one line per prior and setting:
  - the smallest distance between two keypoints of the frame's source;
  - the frame (generated, warped, occlusion): f32 against f64, max abs;
  - one training step: the widest f32-against-f64 gradient error relative
    to its tensor's largest |g| (over tensors whose largest |g| >= 1e-5),
    and how many tensors lie beyond 1e-3 of their largest |g|.
"""
from __future__ import annotations

import argparse
import json
import warnings

import numpy as np
import torch

import chip_smoke
import mrfa_tpu_torch.train.trainer as trainer_mod
from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.ops.tps import RandomTransformParams
from mrfa_tpu_torch.train.trainer import Trainer

SEED = chip_smoke.SEED


def frame(prior: str, conditioned: bool) -> dict:
    """Phase 2's frame step in f32 and in f64 from the same weights."""
    cfg = chip_smoke.small_cfg(prior=prior)
    torch.manual_seed(SEED)
    model = MRFA(cfg, device="cpu")
    if conditioned:
        chip_smoke.condition_prior(model, prior)
    weights = model.state_dict()
    f32 = Animator(model, weights, device="cpu")
    f64 = Animator(MRFA(cfg, device="cpu"), weights, device="cpu")
    f64.model.double()
    f64._image = lambda x: (torch.as_tensor(np.asarray(x, np.float64)).reshape(-1, 64, 64, 3)
                            .permute(0, 3, 1, 2).contiguous())
    rng = np.random.RandomState(SEED + 1)
    source = rng.rand(64, 64, 3).astype(np.float32)
    driving = rng.rand(2, 64, 64, 3).astype(np.float32)
    out32 = f32.animate_frame(f32.begin(source, driving[0]), driving[1])
    out64 = f64.animate_frame(f64.begin(source, driving[0]), driving[1])
    kp = f64.encode_kp(source)["kp"][0]
    apart = torch.cdist(kp, kp) + 9 * torch.eye(len(kp), dtype=kp.dtype)
    return {"kp_min_distance": float(apart.min()),
            "frame_f32_vs_f64": [float((a.double() - b).abs().max())
                                 for a, b in zip(out32, out64)]}


def step_grads(cfg, weights, batch, dtype, prior: str) -> dict:
    """Phase 4's training step (pre-clip gradients) in `dtype`."""
    draw = trainer_mod.random_transform_params
    grads = {}
    clip = trainer_mod.clip_inf_norm_subtrees

    def spy(model, max_norm):
        grads.update({n: p.grad.detach().double().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return clip(model, max_norm)

    def draw_in_dtype(*args, **kwargs):
        params = draw(*args, **kwargs)
        return RandomTransformParams(*(None if t is None else t.to(dtype) for t in params))

    trainer = Trainer(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 21),
                      weights={k: v.clone() for k, v in weights.items()})
    if dtype == torch.float64:
        trainer.model.double()
        trainer._frames = lambda x: x.double().permute(0, 3, 1, 2).contiguous()
    try:
        trainer_mod.clip_inf_norm_subtrees = spy
        trainer_mod.random_transform_params = draw_in_dtype
        trainer.step(batch, dropout_flag=prior == "tpsm", dropout_p=0.1)
    finally:
        trainer_mod.clip_inf_norm_subtrees = clip
        trainer_mod.random_transform_params = draw
    return grads


def training(prior: str, conditioned: bool) -> dict:
    cfg = chip_smoke.small_cfg(losses=True, prior=prior)
    torch.manual_seed(SEED + 20)
    base = Trainer(cfg, device="cpu")
    if conditioned:
        chip_smoke.condition_prior(base.model, prior)
    weights = base.model.state_dict()
    batch = {k: chip_smoke.smooth_frames(2, 64, torch.Generator().manual_seed(SEED + 20 + i),
                                         "cpu")
             for i, k in enumerate(("source", "driving"), start=2)}
    g32 = step_grads(cfg, weights, batch, torch.float32, prior)
    g64 = step_grads(cfg, weights, batch, torch.float64, prior)
    rel = {n: float((g32[n] - w).abs().max()) / float(w.abs().max())
           for n, w in g64.items() if float(w.abs().max()) >= 1e-5}
    widest = max(rel, key=rel.get)
    return {"grad_widest_f32_vs_f64": [rel[widest], widest],
            "grads_beyond_1e-3": sum(r > 1e-3 for r in rel.values()), "grads": len(rel)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--priors", nargs="+", default=["mtia", "fomm", "tpsm"])
    args = parser.parse_args()
    warnings.simplefilter("ignore")  # the random VGG19's warning
    for prior in args.priors:
        for conditioned in ([False, True] if prior == "tpsm" else [False]):
            row = {"prior": prior, "conditioned": conditioned,
                   **frame(prior, conditioned), **training(prior, conditioned)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
