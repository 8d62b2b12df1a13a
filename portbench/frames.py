"""What the serving entries share: the sample of served frames kept for the
check, the reference's frames for them, and their comparison.

The sample is drawn from the seed as the window runs (reservoir sampling
over the frame steps served, so every step of the window is as likely to be
kept, whatever their number), and each kept step keeps every stream's
frame. After the window the reference recomputes each kept step from the
same inputs: the round's sources, the clip's first frame and the step's
driving frames, with its own keypoints and source cache.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from portbench import arith
from portbench.reference.models.mrfa import MRFA as ReferenceMRFA
from portbench.reference.serve import Clip
from portbench.weights import make_weights


def nchw(x: torch.Tensor, device) -> torch.Tensor:
    """(N, H, W, 3) host frames -> (N, 3, H, W) f32 on `device`."""
    return x.to(device).float().permute(0, 3, 1, 2).contiguous()


class Sample:
    """A seeded reservoir of `size` served steps: (round, t, host frames)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed))
        self.seen = 0
        self.kept: List[tuple] = []

    def offer(self, round_: int, t: int, frames: torch.Tensor) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((round_, t, frames.clone()))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = (round_, t, frames.clone())


def reference_model(ctx) -> torch.nn.Module:
    model = ReferenceMRFA(ctx.model_cfg, ctx.device)
    model.load_state_dict(make_weights(ctx.model_cfg, ctx.seed, ctx.device,
                                       ctx.config.get("init")))
    return model.eval()


def reference_frames(ctx, model, kept, sources, clips, count_flops: bool = False
                     ) -> Dict[int, torch.Tensor]:
    """The reference's (S, H, W, 3) frames of each kept step, by its index in
    `kept`; with `count_flops`, also sets `ctx.flops_per_unit` (the FLOPs of
    one stream-frame)."""
    out: Dict[int, torch.Tensor] = {}
    by_round: Dict[int, list] = {}
    for i, (r, t, _) in enumerate(kept):
        by_round.setdefault(r, []).append((i, t))
    for r, steps in sorted(by_round.items()):
        clip = Clip(model, nchw(sources[r % len(sources)], ctx.device), nchw(clips[0], ctx.device))
        for i, t in steps:
            driving = nchw(clips[t], ctx.device)
            if count_flops and ctx.flops_per_unit is None:
                ctx.flops_per_unit = arith.count_flops(lambda: clip.frame(driving)) / len(driving)
            out[i] = clip.frame(driving).permute(0, 2, 3, 1).float().cpu()
    return out


def compare(kept, want: Dict[int, torch.Tensor], got: Optional[Dict[int, torch.Tensor]] = None
            ) -> Dict[str, float]:
    """The served frames (or `got`) against the reference's, each frame's
    mean abs: their mean (over every compared pixel), their median and the
    worst frame's; and the root mean square over every compared pixel."""
    per_frame, squares = [], []
    for i, (_, _, served) in enumerate(kept):
        diff = ((served if got is None else got[i]).float() - want[i]).flatten(1)
        per_frame.append(diff.abs().mean(1))
        squares.append(diff.square().mean(1))
    per_frame = torch.cat(per_frame)
    return {"frame_mean_abs": float(per_frame.mean()),
            "median_frame_mean_abs": float(per_frame.median()),
            "worst_frame_mean_abs": float(per_frame.max()),
            "frame_rms": float(torch.cat(squares).mean().sqrt())}
