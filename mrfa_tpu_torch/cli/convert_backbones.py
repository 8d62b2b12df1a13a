"""Offline converter: torch backbone weight files -> the vendored npz files.

Counterpart of mrfa_tpu/cli/convert_backbones.py, writing the same files in
the same layout (flax names, HWIO kernels), which both packages read
(`mrfa_tpu_torch/weights/`). Run it on a machine that has the weight files:

  python -m mrfa_tpu_torch.cli.convert_backbones \\
      --vgg19 vgg19-dcbb9e9d.pth \\
      --vgg16 vgg16-397923af.pth \\
      --lpips_lin lpips/weights/v0.1/vgg.pth \\
      [--out_dir mrfa_tpu_torch/weights]

Inputs:
  --vgg19      torchvision vgg19 ImageNet state_dict (features.N.weight/bias)
               -> vgg19_imagenet.npz for the perceptual loss.
  --vgg16      torchvision vgg16 ImageNet state_dict, the LPIPS backbone.
  --lpips_lin  the lpips package's learned linear weights for net='vgg'
               (keys linN.model.1.weight, shape (1, C, 1, 1)).
The two LPIPS pieces are given together -> lpips_vgg16.npz.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping

import numpy as np

# conv layer indices of torchvision vgg19.features used by the 5 relu slices
# (nn/vgg.py) and of vgg16.features used by LPIPS (metrics.py)
VGG19_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _np(val) -> np.ndarray:
    return np.asarray(
        val.detach().cpu().numpy() if hasattr(val, "detach") else val, dtype=np.float32
    )


def convert_vgg_features(sd: Mapping[str, Any], conv_idx=VGG19_CONV_IDX) -> Dict[str, Any]:
    """torchvision vgg state_dict -> {features_N: {kernel (HWIO), bias}}."""
    out: Dict[str, Any] = {}
    for idx in conv_idx:
        w = _np(sd[f"features.{idx}.weight"])  # OIHW
        out[f"features_{idx}"] = {
            "kernel": w.transpose(2, 3, 1, 0),
            "bias": _np(sd[f"features.{idx}.bias"]),
        }
    return out


def convert_lpips_lin(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """lpips vgg.pth lin weights -> {linN: (C,)} per-channel vectors.

    The lpips package stores each as a 1x1 Conv2d weight (1, C, 1, 1) in
    lin<N>.model.1 (model.0 is a Dropout); some exports drop the Sequential.
    """
    out: Dict[str, Any] = {}
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key not in sd:
            key = f"lin{i}.weight"
        out[f"lin{i}"] = _np(sd[key]).reshape(-1)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--vgg19", help="torchvision vgg19 .pth state_dict")
    parser.add_argument("--vgg16", help="torchvision vgg16 .pth state_dict")
    parser.add_argument("--lpips_lin", help="lpips net='vgg' lin weights .pth")
    parser.add_argument("--out_dir", default=None)
    args = parser.parse_args(argv)

    import torch

    from mrfa_tpu_torch import weights as W

    out_dir = args.out_dir or W.WEIGHTS_DIR
    os.makedirs(out_dir, exist_ok=True)

    if args.vgg19:
        sd = torch.load(args.vgg19, map_location="cpu", weights_only=True)
        tree = convert_vgg_features(sd, VGG19_CONV_IDX)
        path = os.path.join(out_dir, os.path.basename(W.VGG19_FILE))
        W.save_tree(path, tree)
        print(f"wrote {path} ({len(tree)} convs)")

    if args.vgg16 or args.lpips_lin:
        if not (args.vgg16 and args.lpips_lin):
            parser.error("--vgg16 and --lpips_lin must be given together")
        sd16 = torch.load(args.vgg16, map_location="cpu", weights_only=True)
        sdlin = torch.load(args.lpips_lin, map_location="cpu", weights_only=True)
        tree = convert_vgg_features(sd16, VGG16_CONV_IDX)
        tree.update(convert_lpips_lin(sdlin))
        path = os.path.join(out_dir, os.path.basename(W.LPIPS_FILE))
        W.save_tree(path, tree)
        print(f"wrote {path} ({len(tree)} leaves)")


if __name__ == "__main__":
    main()
