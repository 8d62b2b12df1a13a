"""The numbers a training cell's check compares, program against reference.

Each is a gap of norms, not the norm of a difference: per leaf (a parameter
tensor of the trained subtrees), |norm_program - norm_reference| over the
larger of the reference's norm of that leaf and of the median leaf, since
some gradients are all but zero. The worst leaf is the reading.
  - loss_rel_gap: the largest relative gap of a step's total loss, and
    first_loss_rel_gap the first step's alone;
  - grad_norm_gap: the first gradient as the optimizer received it;
  - change_norm_gap: the weights' change over the first steps, leaving out
    the leaves whose reference gradient is under a thousandth of the median
    leaf's (they move under Adam by round-off alone); median_change_norm_gap
    the median of the same leaves' gaps.
"""
from __future__ import annotations

import torch

ROUND_OFF_LEAF = 1e-3  # of the median leaf's gradient norm


def leaf_gaps(got: torch.Tensor, want: torch.Tensor, keep=None) -> torch.Tensor:
    if keep is not None:
        got, want = got[keep], want[keep]
    return (got - want).abs() / torch.maximum(want, want.median())


def training_gaps(program, reference) -> dict:
    losses, grads, changes = program
    ref_losses, ref_grads, ref_changes = reference
    moved = ref_grads >= ROUND_OFF_LEAF * ref_grads.median()
    change = leaf_gaps(changes, ref_changes, moved)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {
        "loss_rel_gap": max(loss),
        "first_loss_rel_gap": loss[0],
        "grad_norm_gap": float(leaf_gaps(grads, ref_grads).max()),
        "change_norm_gap": float(change.max()),
        "median_change_norm_gap": float(change.median()),
    }
