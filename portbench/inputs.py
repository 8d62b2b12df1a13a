"""The one generator of the benchmark's inputs, driven by a traffic file's
parameters and the seed. Everything is drawn on the device from a
generator seeded by the run's seed (and a stream number), so the same seed
gives the same inputs, and then copied once into pinned host memory, where
the program's callers hold their frames.

Frames are smooth textures (a `texture_side` x `texture_side` random grid
upsampled bilinearly: a warp of white noise turns any sub-pixel change of
the motion into a large change of pixels) moved by a smooth affine motion
over time: translation, rotation and zoom, each a sinusoid of its own
period and phase. A driving clip is one texture in motion; a source is
another texture, so source and driver differ as two faces do. A training
pair is two poses of one texture.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = 64  # frames warped on the device at a time


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of draws of the run's seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))


def textures(n: int, size: int, side: int, gen, device) -> torch.Tensor:
    """(n, 3, size, size) smooth images in [0, 1]."""
    coarse = torch.rand(n, 3, side, side, generator=gen, device=device)
    return F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=True)


def _affine(tx, ty, rot, zoom) -> torch.Tensor:
    """(N, 2, 3) affine matrices from (N,) parameters."""
    c, s = torch.cos(rot) * zoom, torch.sin(rot) * zoom
    return torch.stack([torch.stack([c, -s, tx], -1), torch.stack([s, c, ty], -1)], -2)


def _warp(tex: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Textures (N, 3, H, W) under (N, 2, 3) affines -> (N, H, W, 3) in [0, 1]."""
    grid = F.affine_grid(theta, list(tex.shape), align_corners=False)
    out = F.grid_sample(tex, grid, mode="bilinear", padding_mode="reflection",
                        align_corners=False)
    return out.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def _pinned(shape, device) -> torch.Tensor:
    return torch.empty(shape, pin_memory=torch.device(device).type == "cuda")


def motion_params(n: int, motion: dict, gen, device) -> dict:
    """Per clip: amplitudes drawn up to the traffic's limits, periods in its
    range (frames) and phases, for translation x, y, rotation and zoom."""
    lo, hi = motion["period_frames"]
    def draw(k):
        return torch.rand(n, k, generator=gen, device=device)
    amp = draw(4) * torch.tensor([motion["translate"], motion["translate"], motion["rotate"],
                                  motion["zoom"]], device=device)
    period = lo + draw(4) * (hi - lo)
    phase = draw(4) * 2 * math.pi
    return {"amp": amp, "period": period, "phase": phase}


def _pose(p: dict, t: torch.Tensor) -> torch.Tensor:
    """(N, 2, 3) affines of each clip at (N,) times t."""
    v = p["amp"] * torch.sin(2 * math.pi * t[:, None] / p["period"] + p["phase"])
    return _affine(v[:, 0], v[:, 1], v[:, 2], 1.0 + v[:, 3])


def driving_clips(n: int, frames: int, size: int, motion: dict, seed: int, device
                  ) -> torch.Tensor:
    """(frames, n, size, size, 3) pinned host frames: n clips in smooth motion."""
    gen = generator(seed, 1, device)
    tex = textures(n, size, motion["texture_side"], gen, device)
    params = motion_params(n, motion, gen, device)
    out = _pinned((frames, n, size, size, 3), device)
    for t0 in range(0, frames, BLOCK):
        ts = torch.arange(t0, min(t0 + BLOCK, frames), device=device, dtype=torch.float32)
        k = len(ts)
        theta = _pose({key: v.repeat(k, 1) for key, v in params.items()},
                      ts.repeat_interleave(n))
        warped = _warp(tex.repeat(k, 1, 1, 1), theta)
        out[t0:t0 + k].copy_(warped.reshape(k, n, size, size, 3))
    return out


def sources(rounds: int, n: int, size: int, motion: dict, seed: int, device) -> torch.Tensor:
    """(rounds, n, size, size, 3) pinned host source images: a new texture for
    every stream of every round."""
    gen = generator(seed, 2, device)
    tex = textures(rounds * n, size, motion["texture_side"], gen, device)
    out = _pinned((rounds, n, size, size, 3), device)
    out.copy_(tex.permute(0, 2, 3, 1).reshape(rounds, n, size, size, 3))
    return out


def training_pairs(batches: int, batch: int, size: int, motion: dict, seed: int, device):
    """(batches, batch, size, size, 3) pinned host sources and drivers: each
    pair two poses of one texture, at two random times of its motion; every
    row of every batch differs."""
    gen = generator(seed, 3, device)
    n = batches * batch
    tex = textures(n, size, motion["texture_side"], gen, device)
    params = motion_params(n, motion, gen, device)
    hi = motion["period_frames"][1]
    out = []
    for _ in range(2):
        t = torch.rand(n, generator=gen, device=device) * hi
        host = _pinned((batches, batch, size, size, 3), device)
        for r0 in range(0, n, BLOCK):
            r1 = min(r0 + BLOCK, n)
            part = {k: v[r0:r1] for k, v in params.items()}
            host.view(n, size, size, 3)[r0:r1].copy_(_warp(tex[r0:r1], _pose(part, t[r0:r1])))
        out.append(host)
    return out[0], out[1]
