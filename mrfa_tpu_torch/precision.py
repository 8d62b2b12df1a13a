"""Selective mixed precision for serving.

Counterpart of mrfa_tpu/precision.py, with the policy an explicit argument of
the model (`MRFA(cfg, compute_dtype=torch.bfloat16)`) rather than a
process-wide setting; None, the default, is f32 throughout. Under the bf16
policy:
  - every convolution and dense layer computes in bf16 (input, weight and
    bias cast to it, the result kept in it), except the f32 heads below,
    which compute in the promoted dtype of input and weight, as the JAX
    package's raw flax layers do;
  - BatchNorm normalizes in f32 and returns its input's dtype;
  - the source pixels that dense motion warps and the image of the final warp
    are cast to bf16 (their sampling coordinates stay f32); the correlation
    maps carry bf16 into the lookup;
  - the geometry stream stays f32 wherever the JAX package's dtype promotion
    keeps it so (flows accumulate bf16 deltas in f32).
`apply_compute_dtype` installs the policy on a built model by giving its
convolutions and dense layers a casting forward; without it (the f32
default) they stay plain `nn.Conv2d` and `nn.Linear`.
`cast_params_for_inference` casts the same parameters the JAX function
casts, once, so that the per-call cast of each weight is a no-op.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrfa_tpu_torch.utils.convert import flax_path

# JAX parameter-path names that deliberately stay f32 under the policy (the
# geometry heads), matched against any component of a parameter's path
F32_PARAM_NAMES = frozenset(
    {"fc", "jacobian", "mlp_head_jacobian_1", "pos_embedding", "keypoint_token"}
)


def keeps_f32(key: str) -> bool:
    """Whether a state_dict key lies under an f32 head (its JAX path names one)."""
    _, path = flax_path(key, 2)
    return bool(F32_PARAM_NAMES & set(path))


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class CastConv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype`, or in the promoted dtype of
    input and weight when it is None, as a flax layer does: input, weight and
    bias are cast to that dtype and the result stays in it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class CastLinear(nn.Linear):
    """nn.Linear with the dtype rule of `CastConv2d`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


_CASTING = {nn.Conv2d: CastConv2d, nn.Linear: CastLinear}


def apply_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Install the policy on `model`: every convolution and dense layer gets
    the casting forward, computing in `dtype` outside the f32 heads and in
    the promoted dtype inside them (they then meet bf16 inputs)."""
    for name, module in model.named_modules():
        cls = _CASTING.get(type(module))
        if cls is not None:
            module.__class__ = cls
            module.compute_dtype = None if keeps_f32(f"{name}.weight") else dtype


def cast_params_for_inference(model: nn.Module, dtype=torch.bfloat16) -> List[str]:
    """Cast, in place and once, the float32 parameters of ndim >= 2 outside the
    f32 heads to `dtype` (convolution and dense kernels); biases, norm
    scales, running statistics and the f32 heads stay f32. Inference only.
    Returns the state_dict keys cast."""
    cast = []
    with torch.no_grad():
        for key, p in model.named_parameters():
            if p.dim() >= 2 and p.dtype == torch.float32 and not keeps_f32(key):
                p.data = p.data.to(dtype)
                cast.append(key)
    return cast
