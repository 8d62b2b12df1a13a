"""Vendored pretrained-backbone weights (VGG19 perceptual, LPIPS-VGG16).

Counterpart of mrfa_tpu/weights/__init__.py. The reference's training loss
runs torchvision's ImageNet VGG19 and its reconstruction harness scores with
LPIPS(net='vgg'). Neither set of values is in the repository: a machine with
the torchvision and lpips weight files converts them offline into
`vgg19_imagenet.npz` and `lpips_vgg16.npz`, flax-named trees with their keys
joined by '/' (`save_tree`), and the files are placed in this directory. The
layout is the JAX package's, so one converted file serves both packages.

When the files are absent:
  - training runs on a randomly initialized VGG19 (`overlay_vgg19` warns),
    whose perceptual loss is not the reference's;
  - reconstruction scores with the uniform-weight LPIPS variant
    (`evals.reconstruction` warns), comparable across runs of this port only.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
from torch import nn

from mrfa_tpu_torch.utils.convert import load_jax_variables

WEIGHTS_DIR = os.path.dirname(os.path.abspath(__file__))
VGG19_FILE = os.path.join(WEIGHTS_DIR, "vgg19_imagenet.npz")
LPIPS_FILE = os.path.join(WEIGHTS_DIR, "lpips_vgg16.npz")


def save_tree(path: str, tree: Dict[str, Any]) -> None:
    """Save a nested dict of arrays as an npz with '/'-joined keys."""
    flat: Dict[str, np.ndarray] = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    rec(tree, "")
    np.savez_compressed(path, **flat)


def load_tree(path: str) -> Dict[str, Any]:
    """Inverse of `save_tree`."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            segs = key.split("/")
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = data[key]
    return out


# The paths are read at call time, so a caller (or a test) may point them
# elsewhere by setting the module's globals.


def vgg19_params() -> Optional[Dict[str, Any]]:
    """The vendored ImageNet VGG19 parameters for `nn/vgg.py::Vgg19`, or None."""
    return load_tree(VGG19_FILE) if os.path.exists(VGG19_FILE) else None


def lpips_variables() -> Optional[Dict[str, Any]]:
    """The vendored LPIPS(net='vgg') variables for `metrics.py::LpipsVgg`, or None."""
    return {"params": load_tree(LPIPS_FILE)} if os.path.exists(LPIPS_FILE) else None


def overlay_vgg19(model: nn.Module) -> bool:
    """Load the vendored VGG19 into `model.vgg` in place, strictly (every
    convolution filled, every leaf of the file used). Returns whether it
    loaded; warns when the file is absent, so that a training run on a
    random VGG19 is never silent. A model without `vgg` is left alone."""
    vgg = getattr(model, "vgg", None)
    if vgg is None:
        return False
    pretrained = vgg19_params()
    if pretrained is None:
        warnings.warn(
            f"{VGG19_FILE} not found: the perceptual loss will use a RANDOMLY "
            "INITIALIZED VGG19, which is not the reference's loss. Convert the "
            "torchvision weights offline into that file "
            "(`python -m mrfa_tpu_torch.cli.convert_backbones`).",
            stacklevel=2,
        )
        return False
    load_jax_variables(vgg, {"params": pretrained})
    return True
