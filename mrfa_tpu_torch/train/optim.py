"""The optimizer of the reference training recipe.

Counterpart of mrfa_tpu/train/optim.py (reference train.py): Adam with
betas (0.5, 0.999) and eps 1e-8 on {encoder, decoder, dense_motion}, a
MultiStep learning rate (x0.1 at each epoch milestone times the steps per
epoch), and per-subtree inf-norm gradient clipping at `clip` on the encoder
and the dense motion network only (the decoder is not clipped). The frozen
VGG19 takes no part.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

MAIN_SUBTREES = ("encoder", "decoder", "dense_motion")
CLIP_SUBTREES = ("encoder", "dense_motion")


def make_optimizer(
    model: nn.Module, lr: float, milestones_epochs: Iterable[int], steps_per_epoch: int
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    """Adam on the main subtrees and its MultiStep schedule, stepped once per
    training step (update t runs at lr * 0.1^(milestones <= t))."""
    params = [p for name in MAIN_SUBTREES for p in getattr(model, name).parameters()]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)
    milestones = [int(m) * steps_per_epoch for m in milestones_epochs]
    return opt, torch.optim.lr_scheduler.MultiStepLR(opt, milestones, gamma=0.1)


def clip_inf_norm_subtrees(model: nn.Module, max_norm: float) -> None:
    """torch `clip_grad_norm_(norm_type=inf)` applied to each clipped subtree."""
    for name in CLIP_SUBTREES:
        params = [p for p in getattr(model, name).parameters() if p.grad is not None]
        if params:
            torch.nn.utils.clip_grad_norm_(params, max_norm, norm_type=float("inf"))
