"""The MTIA training step.

Counterpart of mrfa_tpu/train/trainer.py::make_train_step (reference
train.py): forward in train mode (BatchNorm on batch statistics, running
statistics updated), the loss terms summed, backward, per-subtree inf-norm
clipping, Adam and the MultiStep learning rate. f32 throughout; the caller
sets the TF32 policy (the port runs with TF32 off).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from mrfa_tpu_torch.animate import JAX_ONLY_MODULES
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.ops.tps import random_transform_params
from mrfa_tpu_torch.train.optim import clip_inf_norm_subtrees, make_optimizer
from mrfa_tpu_torch.utils.convert import load_jax_variables
from mrfa_tpu_torch.utils.device import resolve_device


class Trainer:
    """One MRFA model and its optimizer, on CUDA unless the caller passes
    another device.

    `weights` is a port `state_dict()` or the JAX package's variables
    {'params', 'batch_stats'}; without it the model keeps the initializers'
    values drawn under the caller's RNG state, VGG19 included. The ImageNet
    VGG19 values are not in the repository, so a run on a random VGG19 warns:
    its perceptual loss is not the reference's. `generator` draws the
    equivariance transforms (a CPU generator seeded 0 when None).
    """

    def __init__(
        self,
        cfg: Dict[str, Any],
        device: Optional[Union[str, torch.device]] = None,
        steps_per_epoch: int = 1000,
        generator: Optional[torch.Generator] = None,
        weights: Optional[Mapping[str, Any]] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        tp = cfg["train_params"]
        if tp.get("bg_start", 0) < tp.get("num_epochs", 0):
            raise NotImplementedError(
                "the background predictor is not ported yet: set bg_start >= num_epochs"
            )
        self.model = MRFA(cfg, device=self.device)
        if weights is not None and "params" in weights:
            load_jax_variables(self.model, weights, skip=JAX_ONLY_MODULES)
        elif weights is not None:
            self.model.load_state_dict(weights)
        if hasattr(self.model, "vgg") and weights is None:
            warnings.warn(
                "the perceptual loss runs on a RANDOMLY INITIALIZED VGG19, not the "
                "reference's ImageNet VGG19 (its values are not in the repository)",
                stacklevel=2,
            )
        self.model.train()
        self.optimizer, self.scheduler = make_optimizer(
            self.model, tp["lr"], tp.get("epoch_milestones", []), steps_per_epoch
        )
        self.clip = tp.get("clip", 10.0) if tp.get("clip_grad", True) else None
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def _frames(self, x) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1], numpy or tensor -> (B, 3, H, W) f32 on the device."""
        x = torch.as_tensor(np.ascontiguousarray(x) if not torch.is_tensor(x) else x)
        return x.to(device=self.device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()

    def step(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One training step on {"source", "driving"} -> the loss terms as
        Python floats ("loss" is their sum) and the generated frames "gen"
        (B, H, W, 3)."""
        source = self._frames(batch["source"])
        driving = self._frames(batch["driving"])
        tp = self.cfg["train_params"]
        transform = None
        if tp["loss_weights"].get("equivariance", 0) != 0:
            transform = random_transform_params(
                self.generator, source.shape[0], **tp["transform_params"], device=self.device
            )
        gen, _, losses, _, _ = self.model(source, driving, compute_loss=True, transform=transform)
        total = sum(losses.values())
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if self.clip is not None:
            clip_inf_norm_subtrees(self.model, self.clip)
        self.optimizer.step()
        self.scheduler.step()
        out = {"loss": float(total.detach())}
        out.update({k: float(v.detach()) for k, v in losses.items()})
        out["gen"] = gen.detach().permute(0, 2, 3, 1)
        return out
