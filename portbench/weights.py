"""Model weights made from the seed, on the device, in one draw.

The parameter names and shapes are the frozen reference's (which keeps the
port's names), read from a copy built on the meta device, so nothing of the
program is consulted. Every float parameter is drawn from one uniform draw
of a generator on the device and scaled to torch's default range for its
layer, U(-1/sqrt(fan_in), 1/sqrt(fan_in)); normalization layers get scale 1
and shift 0, and BatchNorm's running statistics their initial 0 and 1. The
configuration's `init` rules then set what a layer's own initializer sets
(a zero head, an identity bias, a small embedding). The same seed gives the
same weights; the program and the reference are both handed them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

NORMS = (nn.BatchNorm2d, nn.LayerNorm)


def reference_layout(model_cfg: dict) -> nn.Module:
    """The reference model on the meta device: its names, shapes and layers."""
    from portbench.reference.models.mrfa import MRFA

    with torch.device("meta"):
        return MRFA(model_cfg, "meta")


def _apply_rule(u: torch.Tensor, rule) -> torch.Tensor:
    """One `init` rule on a leaf, from its share `u` of the uniform draw:
    "zeros", a list tiled over the leaf, or
    {"uniform": a} (U(-a, a)) or
    {"logit_spread": a} (the logit of U(-a, a) mapped through (1 + u)/(1 - u),
    which puts sigmoid * 2 - 1 of the leaf uniformly in (-a, a))."""
    if rule == "zeros":
        return torch.zeros_like(u)
    if isinstance(rule, list):
        v = torch.tensor(rule, dtype=u.dtype, device=u.device)
        return v.repeat(u.numel() // v.numel()).reshape(u.shape)
    if "uniform" in rule:
        return (2 * u - 1) * float(rule["uniform"])
    if "logit_spread" in rule:
        v = (2 * u - 1) * float(rule["logit_spread"])
        return torch.log((1 + v) / (1 - v))
    raise ValueError(f"unknown init rule {rule!r}")


def make_weights(model_cfg: dict, seed: int, device, init_rules: Dict[str, object] = None
                 ) -> Dict[str, torch.Tensor]:
    """The state_dict of the reference (and the port) from `seed`: f32, on
    `device`. `init_rules` maps a parameter-name suffix to a rule."""
    layout = reference_layout(model_cfg)
    norm_params = {f"{m_name}.{p_name}" if m_name else p_name
                   for m_name, m in layout.named_modules() if isinstance(m, NORMS)
                   for p_name, _ in m.named_parameters(recurse=False)}
    params = dict(layout.named_parameters())
    total = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    draw = torch.rand(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, p in params.items():
        u = draw[offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
        rule = next((r for suffix, r in (init_rules or {}).items() if name.endswith(suffix)),
                    None)
        if rule is not None:
            out[name] = _apply_rule(u, rule)
        elif name in norm_params:
            out[name] = (torch.ones_like(u) if name.endswith("weight") else torch.zeros_like(u))
        else:
            weight = params.get(name[:-len("bias")] + "weight") if name.endswith("bias") else p
            fan_in = math.prod(weight.shape[1:]) if weight is not None and weight.dim() > 1 \
                else p.shape[-1]
            out[name] = (2 * u - 1) / math.sqrt(fan_in)
    for name, b in layout.named_buffers():
        if name.endswith("running_mean"):
            out[name] = torch.zeros(b.shape, device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones(b.shape, device=device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    return out
