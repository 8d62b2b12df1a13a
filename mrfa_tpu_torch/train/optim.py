"""The optimizers of the reference training recipe.

Counterpart of mrfa_tpu/train/optim.py (reference train.py): two Adam groups
with betas (0.5, 0.999) and eps 1e-8, {encoder, decoder, dense_motion} and
{bg_predictor}, each with a MultiStep learning rate (x0.1 at each epoch
milestone times the steps per epoch), and per-subtree inf-norm gradient
clipping at `clip` on the encoder, the dense motion network and the
background predictor (the decoder is not clipped). The frozen VGG19 takes
no part.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

MAIN_SUBTREES = ("encoder", "decoder", "dense_motion")
BG_SUBTREES = ("bg_predictor",)
CLIP_SUBTREES = ("encoder", "dense_motion", "bg_predictor")


def make_optimizer(
    model: nn.Module, lr: float, milestones_epochs: Iterable[int], steps_per_epoch: int,
    subtrees: Tuple[str, ...] = MAIN_SUBTREES,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    """Adam on `subtrees` and its MultiStep schedule, stepped once per update
    of the group (update t runs at lr * 0.1^(milestones <= t))."""
    params = [p for name in subtrees for p in getattr(model, name).parameters()]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)
    milestones = [int(m) * steps_per_epoch for m in milestones_epochs]
    return opt, torch.optim.lr_scheduler.MultiStepLR(opt, milestones, gamma=0.1)


def clip_inf_norm_subtrees(model: nn.Module, max_norm: float) -> None:
    """torch `clip_grad_norm_(norm_type=inf)` applied to each clipped subtree."""
    for name in CLIP_SUBTREES:
        if not hasattr(model, name):
            continue
        params = [p for p in getattr(model, name).parameters() if p.grad is not None]
        if params:
            torch.nn.utils.clip_grad_norm_(params, max_norm, norm_type=float("inf"))
