"""Device resolution for the package's entry points.

Every entry point takes an explicit ``device``.  Left as ``None`` it means
the current CUDA card; the CPU is used only when a caller asks for it by
name (``device="cpu"``, as the tests do).  There is no silent fallback:
with no card and no explicit device, resolution raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` itself when given,
    else the current CUDA card.  Raises ``RuntimeError`` when no card is
    present and no device was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
