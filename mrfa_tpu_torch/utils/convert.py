"""Carry JAX-package weights into the port's modules.

Every port module is named after the reference torch attribute path, and the
JAX package names its flax modules after the same paths with ModuleList /
Sequential indices folded into the parent name (`down_blocks.0` ->
`down_blocks_0`). So each port `state_dict()` key maps onto one flax leaf:

  weight (4-D conv, OIHW)   <- params .../kernel, HWIO
  weight (2-D linear)       <- params .../kernel, (in, out)
  weight (1-D norm affine)  <- params .../scale
  bias                      <- params .../bias
  running_mean/running_var  <- batch_stats .../mean, var
  anything else             <- params leaf of the same name, verbatim

(the inverse of the JAX package's torch -> flax converter).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _fold_indices(segments: Iterable[str]) -> List[str]:
    """Fold pure-digit path segments into the preceding name with '_'."""
    out: List[str] = []
    for seg in segments:
        if seg.isdigit() and out:
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return out


def flax_path(key: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of the flax leaf that a port state_dict key maps to."""
    segs = _fold_indices(key.split("."))
    mod, leaf = tuple(segs[:-1]), segs[-1]
    if leaf == "weight" and ndim in (2, 4):
        return "params", mod + ("kernel",)
    if leaf == "weight" and ndim == 1:
        return "params", mod + ("scale",)
    if leaf == "running_mean":
        return "batch_stats", mod + ("mean",)
    if leaf == "running_var":
        return "batch_stats", mod + ("var",)
    return "params", mod + (leaf,)


def _to_torch_layout(arr: np.ndarray, key: str, ndim: int) -> np.ndarray:
    is_weight = key.rsplit(".", 1)[-1] == "weight"
    if is_weight and ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if is_weight and ndim == 2:
        return arr.T  # (in, out) -> (out, in)
    return arr


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_jax_variables(
    module: nn.Module, variables: Mapping[str, Any], skip: Iterable[str] = ()
) -> None:
    """Fill `module`'s state_dict from JAX variables {'params', 'batch_stats'}.

    Strict both ways: every port key must find its flax leaf with the same
    shape, and every flax leaf must be used except those under a top-level
    module named in `skip` (subtrees the caller does not carry over). The
    frozen `vgg` and every BatchNorm running
    statistic are filled like any other leaf. Raises KeyError or ValueError
    otherwise.
    """
    skip = set(skip)
    leaves = {
        (coll,) + path: leaf
        for coll in ("params", "batch_stats")
        for path, leaf in _flatten(variables.get(coll, {})).items()
        if path[0] not in skip
    }
    used = set()
    state = module.state_dict()
    with torch.no_grad():
        for key, tensor in state.items():
            if key.endswith("num_batches_tracked"):
                continue
            coll, path = flax_path(key, tensor.dim())
            full = (coll,) + path
            if full not in leaves:
                raise KeyError(f"no JAX leaf {'/'.join(full)} for port key {key!r}")
            arr = _to_torch_layout(np.asarray(leaves[full]), key, tensor.dim())
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"shape mismatch at {key!r}: port {tuple(tensor.shape)} vs JAX "
                    f"{'/'.join(full)} {tuple(arr.shape)} (in torch layout)"
                )
            tensor.copy_(torch.from_numpy(np.array(arr, dtype=np.float32, copy=True)))
            used.add(full)
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"JAX leaves not used by the port: {unused[:10]} ({len(unused)} in all)")
