"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) but absent: the
    port never falls back to the CPU on its own; pass `device="cpu"` for that.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def to_device(x: torch.Tensor, device: Optional[Union[str, torch.device]]) -> torch.Tensor:
    """`x` on `device` (None: where it is). A host tensor bound for CUDA goes
    through pinned memory with a non-blocking copy, so the host does not
    wait for the card."""
    if device is None:
        return x
    if x.device.type == "cpu" and torch.device(device).type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def frames_to_device(x, device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) frames, numpy or tensor -> (B, 3, H, W) f32 on `device`."""
    x = torch.as_tensor(np.ascontiguousarray(x) if not torch.is_tensor(x) else x)
    return to_device(x.float(), device).permute(0, 3, 1, 2).contiguous()
