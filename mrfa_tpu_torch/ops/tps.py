"""The random affine + thin-plate-spline warp of the equivariance losses.

Counterpart of mrfa_tpu/ops/tps.py::random_transform_* (the reference
equivariance `Transform`): an affine map plus an L1-distance TPS bump,
U(r) = r^2 log(r + 1e-6) with r = |dx| + |dy|, added to both coordinates.
Randomness enters only through an explicit `torch.Generator`. Frames are
NCHW; keypoint coordinates (B, M, 2) xy in [-1, 1].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mrfa_tpu_torch.ops.grid import make_coordinate_grid
from mrfa_tpu_torch.ops.sampler import grid_sample
from mrfa_tpu_torch.utils.device import to_device


class RandomTransformParams(NamedTuple):
    theta: torch.Tensor  # (B, 2, 3)
    control_points: Optional[torch.Tensor]  # (1, P^2, 2)
    control_params: Optional[torch.Tensor]  # (B, 1, P^2)


def random_transform_params(
    generator: Optional[torch.Generator],
    bs: int,
    sigma_affine: float,
    sigma_tps: Optional[float] = None,
    points_tps: Optional[int] = None,
    device=None,
) -> RandomTransformParams:
    """Sample a random affine (+ TPS) warp, drawn on the generator's device
    (the default generator when None) and moved to `device` (None: stays)."""
    gen_dev = generator.device if generator is not None else torch.device("cpu")
    noise = torch.randn(bs, 2, 3, generator=generator, device=gen_dev)
    theta = torch.eye(2, 3, device=gen_dev) + sigma_affine * noise
    if sigma_tps is None or points_tps is None:
        return RandomTransformParams(to_device(theta, device), None, None)
    cps = make_coordinate_grid(points_tps, points_tps).reshape(1, points_tps**2, 2)
    cpar = sigma_tps * torch.randn(bs, 1, points_tps**2, generator=generator, device=gen_dev)
    return RandomTransformParams(*(to_device(t, device) for t in (theta, cps, cpar)))


def _bump(params: RandomTransformParams, coords: torch.Tensor) -> torch.Tensor:
    """The TPS bump sum_p c_p U(|x - x_p| + |y - y_p|): (B, M)."""
    d = coords[:, :, None, :] - params.control_points[:, None, :, :]  # (B, M, P, 2)
    r = torch.where(d >= 0, d, -d).sum(-1)  # L1, with JAX's derivative of |0| (+1)
    u = (r * r) * torch.log(r + 1e-6)
    return torch.einsum("bmp,bp->bm", u, params.control_params[:, 0, :])


def random_transform_warp(params: RandomTransformParams, coords: torch.Tensor) -> torch.Tensor:
    """Warp coordinates (B or 1, M, 2) -> (B, M, 2)."""
    theta = params.theta
    coords = coords.expand(theta.shape[0], *coords.shape[1:])
    out = torch.einsum("bij,bmj->bmi", theta[:, :, :2], coords) + theta[:, None, :, 2]
    if params.control_points is not None:
        out = out + _bump(params, coords)[:, :, None]
    return out


def random_transform_frame(params: RandomTransformParams, frame: torch.Tensor) -> torch.Tensor:
    """Warp a (B, C, H, W) frame by the random transform (reflection padding)."""
    b, _, h, w = frame.shape
    grid = make_coordinate_grid(h, w, dtype=frame.dtype, device=frame.device)
    warped = random_transform_warp(params, grid.reshape(1, h * w, 2)).reshape(b, h, w, 2)
    return grid_sample(frame, warped, align_corners=False, padding_mode="reflection")


def random_transform_jacobian(params: RandomTransformParams, coords: torch.Tensor) -> torch.Tensor:
    """d(warp)/d(coords) at each point, (B, M, 2, 2), by forward-mode autodiff
    (`torch.func.jacfwd`), differentiable with respect to the coordinates."""
    from torch.func import jacfwd, vmap

    b = params.theta.shape[0]
    coords = coords.expand(b, *coords.shape[1:])
    has_tps = params.control_points is not None
    cps = params.control_points[0] if has_tps else None
    cpar = params.control_params[:, 0, :] if has_tps else coords.new_zeros(b, 0)

    def warp_point(xy, theta, c):
        out = theta[:, :2] @ xy + theta[:, 2]
        if has_tps:
            d = xy[None, :] - cps
            r = torch.where(d >= 0, d, -d).sum(-1)
            out = out + ((r * r) * torch.log(r + 1e-6) * c).sum()
        return out

    per_point = vmap(jacfwd(warp_point), in_dims=(0, None, None))
    return vmap(per_point, in_dims=(0, 0, 0))(coords, params.theta, cpar)
