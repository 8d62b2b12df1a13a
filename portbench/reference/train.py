"""The reference training step: the equivariance transform and the TPSM
channel-dropout mask drawn from the same seeded CPU generators the program
is handed, the training forward with its losses, backward, per-subtree
inf-norm clipping of the encoder and the dense motion network, Adam
(betas 0.5, 0.999, eps 1e-8) on the encoder, the decoder and the dense
motion network, and the MultiStep learning rate."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference.models.dense_motion import dropout_keep
from portbench.reference.models.mrfa import MRFA
from portbench.reference.ops.tps import random_transform_params

MAIN_SUBTREES = ("encoder", "decoder", "dense_motion")
CLIP_SUBTREES = ("encoder", "dense_motion")


class Trainer:
    """The model on `device` loaded with `weights` (a state_dict), in
    training mode, and its optimizer."""

    def __init__(self, cfg, weights, device, generator: torch.Generator,
                 dropout_generator: torch.Generator, dropout_p: Optional[float] = None,
                 steps_per_epoch: int = 1000):
        self.cfg = cfg
        self.tp = cfg["train_params"]
        self.model = MRFA(cfg, device)
        self.model.load_state_dict(weights)
        self.model.train()
        params = [p for name in MAIN_SUBTREES for p in getattr(self.model, name).parameters()]
        self.params = params
        self.optimizer = torch.optim.Adam(params, lr=self.tp["lr"], betas=(0.5, 0.999),
                                          eps=1e-8, foreach=False)
        milestones = [int(m) * steps_per_epoch for m in self.tp.get("epoch_milestones", [])]
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(self.optimizer, milestones, 0.1)
        self.clip = self.tp.get("clip", 10.0) if self.tp.get("clip_grad", True) else None
        self.generator = generator
        self.dropout_generator = dropout_generator
        self.dropout_p = dropout_p
        self.device = torch.device(device)

    def step(self, source: torch.Tensor, driving: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on (B, 3, H, W) frames -> the loss terms and "loss", their
        sum. The clipped gradients stay on the parameters until the next step."""
        tp, model = self.tp, self.model
        b = source.shape[0]
        transform = keep = None
        if tp["loss_weights"].get("equivariance", 0) != 0:
            transform = random_transform_params(self.generator, b, **tp["transform_params"],
                                                device=self.device)
        dropout = self.dropout_p is not None
        if dropout:
            keep = dropout_keep(b, model.dense_motion.motions, self.dropout_p,
                                self.dropout_generator, self.device)
        _, _, losses, _, _ = model(source, driving, compute_loss=True, transform=transform,
                                   dropout_flag=dropout, dropout_p=self.dropout_p or 0.0,
                                   dropout_keep=keep)
        total = sum(losses.values())
        model.zero_grad(set_to_none=True)
        total.backward()
        if self.clip is not None:
            for name in CLIP_SUBTREES:
                ps = [p for p in getattr(model, name).parameters() if p.grad is not None]
                if ps:
                    torch.nn.utils.clip_grad_norm_(ps, self.clip, norm_type=float("inf"))
        self.optimizer.step()
        self.scheduler.step()
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
