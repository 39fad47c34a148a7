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


def local_world(device: torch.device, count: Optional[int] = None) -> int:
    """How many cards an owner on ``device`` (a worker, a training runner)
    computes over: ``count`` when given (on a card at most the cards the
    process sees; on the CPU, that many CPU "cards"), else every card the
    process sees on a card and one on the CPU (the reference's
    ``len(jax.devices())``).  ``ValueError`` for a count below 1 or above
    the host's cards."""
    if count is None:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    if count < 1:
        raise ValueError(f"a local world needs at least one card, got {count}")
    if device.type == "cuda" and count > torch.cuda.device_count():
        raise ValueError(f"{count} cards asked, this host has {torch.cuda.device_count()}")
    return count


def local_devices(device: torch.device, count: int) -> list[torch.device]:
    """The ``count`` devices of a local world on ``device``'s kind: cards
    0 .. count-1, or the CPU ``count`` times."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(count)]
    return [device] * count
