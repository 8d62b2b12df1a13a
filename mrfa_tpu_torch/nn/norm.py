"""Normalization layers.

Counterpart of mrfa_tpu/nn/norm.py. torch's own layers have the semantics the
JAX package reproduces (eps 1e-5, momentum 0.1; in eval mode BatchNorm
normalizes with its running statistics), and their parameter names (`weight`,
`bias`, `running_mean`, `running_var`) are what utils/convert.py maps to the
JAX `scale`, `bias`, `mean` and `var`.

`BatchNorm` is `nn.BatchNorm2d` until `sync_batch_norm` gives it a process
group of more than one rank: its training-mode statistics are then those of
the global batch, as the JAX BatchNorm's with `axis_name` (the reference's
SyncBatchNorm). `torch.nn.SyncBatchNorm` refuses CPU tensors, so the gloo
runs on the CPU could not use it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from mrfa_tpu_torch.parallel.mesh import all_reduce_sum

LayerNorm = nn.LayerNorm


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d`, with batch statistics over `process_group` in
    training mode when the group holds more than one rank: each rank's mean
    and mean square (in f32 at least) are averaged over the group, the input
    is normalized with the biased variance, and the running variance takes
    the unbiased one over the global count (mrfa_tpu/nn/norm.py:40-58). The
    output keeps the input's dtype."""

    process_group = None  # set by `sync_batch_norm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.process_group
        if not self.training or group is None or dist.get_world_size(group) == 1:
            return super().forward(x)
        world = dist.get_world_size(group)
        xc = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        local = torch.stack([xc.mean(dims), (xc * xc).mean(dims)])
        mean, mean2 = all_reduce_sum(local, group) / world
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        n = x.numel() // x.shape[1] * world
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
            self.running_var.mul_(1 - m).add_(
                m * (var * (n / max(n - 1, 1))).to(self.running_var.dtype))
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        y = (xc - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def sync_batch_norm(model: nn.Module, process_group) -> nn.Module:
    """Every `BatchNorm` of `model` takes its training statistics over
    `process_group` (None: each rank's own batch again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = process_group
    return model
