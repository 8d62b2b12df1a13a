"""The controls of the correctness check: the reference computed in the
precision just below the one a configuration states.

- "tf32" (for float32 with TF32 off): on CUDA, TF32 switched on for cuBLAS
  and cuDNN; elsewhere, every convolution's and dense layer's operands
  (input and weight) rounded to TF32's 10-bit mantissa, the sum in f32.
- "fp8" (for the bf16 policy): float8 e4m3 with a per-tensor scale (amax
  onto 448) where the policy puts bf16: every convolution's and dense
  layer's operands and its result (the policy keeps a layer's result in
  bf16, except the f32 heads', `F32_HEADS`), the pixels and features every
  warp samples, and the correlation maps the lookup reads; the sums in f32.
Each rounding passes the gradient straight through, and the weights stay
f32 masters, so a training step runs as a lower-precision step would.
"""
from __future__ import annotations

import contextlib
import types

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
# layers whose result the bf16 policy keeps in f32 (the geometry heads), by
# a component of the layer's name in the reference model
F32_HEADS = frozenset({"fc", "jacobian", "mlp_head_jacobian"})


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"tf32": _tf32, "fp8": _fp8}


def straight_through(rnd, x: torch.Tensor) -> torch.Tensor:
    """`rnd(x)` forward, the identity's gradient backward."""
    return x + (rnd(x).to(x.dtype) - x).detach()


def _conv_forward(rnd, out):
    def forward(self, x):
        y = self._conv_forward(straight_through(rnd, x), straight_through(rnd, self.weight),
                               self.bias)
        return straight_through(out, y) if out else y
    return forward


def _linear_forward(rnd, out):
    def forward(self, x):
        y = F.linear(straight_through(rnd, x), straight_through(rnd, self.weight), self.bias)
        return straight_through(out, y) if out else y
    return forward


@contextlib.contextmanager
def lower_precision(model: nn.Module, kind: str):
    """`model` computing at `kind` ("tf32" or "fp8") inside the block."""
    device = next(model.parameters()).device
    if kind == "tf32" and device.type == "cuda":
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return
    from portbench.reference.models import raft
    from portbench.reference.ops import sampler

    rnd = ROUND[kind]
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    for name, m in layers:
        make = _conv_forward if isinstance(m, nn.Conv2d) else _linear_forward
        out = rnd if kind == "fp8" and not F32_HEADS & set(name.split(".")) else None
        m.forward = types.MethodType(make(rnd, out), m)
    plain_warp, plain_lookup = sampler.warp_pixels, raft.CorrLookupFn
    if kind == "fp8":
        def warp(img, ix, iy, zero_oob=True):
            return plain_warp(straight_through(rnd, img), ix, iy, zero_oob)

        class Lookup:
            @staticmethod
            def apply(c0, c1, coords):
                return plain_lookup.apply(straight_through(rnd, c0), straight_through(rnd, c1),
                                          coords)

        sampler.warp_pixels, raft.CorrLookupFn = warp, Lookup
    try:
        yield
    finally:
        for _, m in layers:
            del m.forward
        sampler.warp_pixels, raft.CorrLookupFn = plain_warp, plain_lookup
