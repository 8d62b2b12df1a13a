"""Checkpoints: the port's own, and the import of the reference `.pth` files.

Counterpart of mrfa_tpu/utils/checkpoint.py. The port saves torch-native
state (`torch.save` of state dicts, numbers and tensors) at `path/<step>/`,
written beside its place and renamed into it, so a crash leaves no half
checkpoint under a step's name. The reference's released `.pth` files
load into a port model by name: the port's attribute paths are the
reference's, apart from the VGG19 slices, whose convolutions keep their
torchvision index (`vgg.slice<k>.<i>.*` -> `vgg.features_<i>.*`), and the
buffers the port recomputes (the anti-alias kernels `pyramid.downs.*` and
`down.weight`, and the VGG19 `mean`/`std`), which are dropped.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

STATE_FILE = "state.pt"


def save_checkpoint(path: str, tree: Dict[str, Any], step: int) -> str:
    """Save `tree` (state dicts, tensors, numbers) at `path`/<step>,
    replacing an earlier checkpoint of that step. Returns the directory."""
    final = os.path.join(os.path.abspath(path), str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
    """(the tree saved by `save_checkpoint` at `step`, or the latest, on the
    CPU; its step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    tree = torch.load(os.path.join(os.path.abspath(path), str(step), STATE_FILE),
                      map_location="cpu", weights_only=True)
    return tree, step


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a reference `.pth` checkpoint, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt


def remap_reference_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Reference state-dict keys -> the port's: `module.` stripped, the
    recomputed buffers dropped, the VGG19 slices renamed."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if re.match(r"^(pyramid\.downs\.|down\.weight$|vgg\.(mean|std)$)", k):
            continue
        out[re.sub(r"^vgg\.slice\d+\.(\d+)\.", r"vgg.features_\1.", k)] = v
    return out


def load_torch_weights_into(
    model: nn.Module,
    pth_path: str,
    *,
    drop_decoder_pos_embedding: bool = False,
    verbose: bool = True,
) -> Tuple[List[str], List[str]]:
    """Load a reference `.pth` checkpoint into `model` in place, non-strict.

    Returns (missing, unexpected): model keys the file does not fill (kept
    as they are; a shape mismatch is reported here with both shapes) and
    file keys the model has no slot for. BatchNorm's `num_batches_tracked`
    is neither loaded nor reported. `drop_decoder_pos_embedding` leaves the
    decoder's positional embedding out (the reference's rule when training
    resumes from a `.pth`).
    """
    sd = load_torch_checkpoint(pth_path)
    if drop_decoder_pos_embedding:
        sd = {k: v for k, v in sd.items() if "decoder.pos_embedding" not in k}
    sd = remap_reference_keys(sd)
    state = model.state_dict()
    missing: List[str] = []
    with torch.no_grad():
        for key, tensor in state.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key not in sd:
                missing.append(key)
                continue
            value = torch.as_tensor(sd[key])
            if tuple(value.shape) != tuple(tensor.shape):
                missing.append(f"{key} (shape mismatch: model {tuple(tensor.shape)} vs "
                               f"file {tuple(value.shape)})")
                continue
            tensor.copy_(value)
    unexpected = [k for k in sd if k not in state and not k.endswith("num_batches_tracked")]
    if verbose:
        if missing:
            print(f"[checkpoint] {len(missing)} model keys not found in .pth "
                  f"(kept init): {missing[:8]}{'...' if len(missing) > 8 else ''}")
        if unexpected:
            print(f"[checkpoint] {len(unexpected)} .pth keys unused: "
                  f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    return missing, unexpected
