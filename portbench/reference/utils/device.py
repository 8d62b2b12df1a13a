"""Moving host tensors to the reference's device."""
from __future__ import annotations

from typing import Optional, Union

import torch


def to_device(x: torch.Tensor, device: Optional[Union[str, torch.device]]) -> torch.Tensor:
    """`x` on `device` (None: where it is)."""
    return x if device is None else x.to(device)
