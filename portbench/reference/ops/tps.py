"""Thin-plate-spline transforms.

Counterpart of mrfa_tpu/ops/tps.py, both of its flavours:
  - `tps_fit` / `tps_warp_coordinates` / `tps_transform_grid`: the TPSM
    prior's exact TPS through K groups of 5 keypoint pairs, with the radial
    basis U(s) = s log(s + 1e-9) of the squared L2 distance s and the
    (N+3)^2 system regularized by 0.01 I, solved per (batch, group);
  - `random_transform_*`: the random affine + TPS warp of the equivariance
    losses (the reference equivariance `Transform`): an affine map plus an
    L1-distance TPS bump, U(r) = r^2 log(r + 1e-6) with r = |dx| + |dy|,
    added to both coordinates.
Randomness enters only through an explicit `torch.Generator`. Frames are
NCHW; keypoint coordinates (B, M, 2) xy in [-1, 1].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from portbench.reference.ops.grid import make_coordinate_grid
from portbench.reference.ops.sampler import grid_sample
from portbench.reference.utils.device import to_device


class TpsParams(NamedTuple):
    """A fitted TPS for G groups: x -> A x + b + sum_i w_i U(|x - c_i|^2)."""

    theta: torch.Tensor  # (B, G, 2, 3) affine part
    control_points: torch.Tensor  # (B, G, N, 2)
    control_params: torch.Tensor  # (B, G, N, 2)


def _radial(s: torch.Tensor) -> torch.Tensor:
    """U(s) = s log(s + 1e-9) of a squared distance (0 at s = 0, the
    diagonal of the fit's kernel matrix)."""
    return s * torch.log(s + 1e-9)


def tps_fit(kp_1: torch.Tensor, kp_2: torch.Tensor) -> TpsParams:
    """Fit the per-group TPS that maps the (B, G, N, 2) control points
    `kp_1` (the driving keypoints in the prior) onto `kp_2`."""
    b, g, n, _ = kp_1.shape
    d = kp_1[:, :, :, None, :] - kp_1[:, :, None, :, :]  # (B, G, N, N, 2)
    k = _radial((d * d).sum(-1))
    p = torch.cat([kp_1, torch.ones_like(kp_1[..., :1])], dim=3)  # (B, G, N, 3)
    top = torch.cat([k, p.transpose(2, 3)], dim=2)  # (B, G, N+3, N)
    right = torch.cat([p, kp_1.new_zeros(b, g, 3, 3)], dim=2)  # (B, G, N+3, 3)
    l_mat = torch.cat([top, right], dim=3)
    l_mat = l_mat + 0.01 * torch.eye(n + 3, dtype=kp_1.dtype, device=kp_1.device)
    y = torch.cat([kp_2, kp_1.new_zeros(b, g, 3, 2)], dim=2)  # (B, G, N+3, 2)
    param = torch.linalg.solve(l_mat, y)
    return TpsParams(param[:, :, n:, :].transpose(2, 3), kp_1, param[:, :, :n, :])


def tps_warp_coordinates(params: TpsParams, coords: torch.Tensor) -> torch.Tensor:
    """Apply the fitted TPS to (B or 1, M, 2) coordinates -> (B, G, M, 2)."""
    theta, cps, cpar = params
    coords = coords.expand(theta.shape[0], *coords.shape[1:])
    aff = torch.einsum("bgij,bmj->bgmi", theta[..., :2], coords) + theta[:, :, None, :, 2]
    d = coords[:, None, None, :, :] - cps[:, :, :, None, :]  # (B, G, N, M, 2)
    u = _radial((d * d).sum(-1))  # (B, G, N, M)
    return aff + torch.einsum("bgnm,bgnc->bgmc", u, cpar)


def tps_transform_grid(params: TpsParams, h: int, w: int) -> torch.Tensor:
    """The dense warp of a whole (h, w) frame: (B, G, h, w, 2)."""
    theta = params.theta
    grid = make_coordinate_grid(h, w, dtype=theta.dtype, device=theta.device)
    warped = tps_warp_coordinates(params, grid.reshape(1, h * w, 2))
    return warped.reshape(*warped.shape[:2], h, w, 2)


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
    """Warp coordinates (B or 1, M, 2) -> (B, M, 2), in the promoted dtype of
    coordinates and transform (bf16 keypoints are warped in f32, as JAX's
    promotion does)."""
    theta = params.theta
    coords = coords.expand(theta.shape[0], *coords.shape[1:])
    coords = coords.to(torch.promote_types(coords.dtype, theta.dtype))
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
    coords = coords.to(torch.promote_types(coords.dtype, params.theta.dtype))
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
