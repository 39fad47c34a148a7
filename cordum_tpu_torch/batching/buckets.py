"""Pad-to-bucket sizing.

Device calls run best on a small fixed set of shapes (the JAX package
compiles one program per shape; here the kernels, the GEMMs and the caching
allocator meet the same few shapes again), so the batcher quantizes both
the sequence dimension (queue assignment) and the batch dimension
(flush-time padding) onto a small ladder of buckets: every flush takes one
of a handful of shapes instead of one per ragged batch (the Ragged Paged
Attention / FlexNPU serving trick applied to the control plane's job ops).
"""
from __future__ import annotations

from typing import Sequence


def pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Powers of two from ``lo`` up to and including a final ``hi`` cap."""
    out: list[int] = []
    b = max(1, lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ ``length``; the largest bucket when none fits
    (callers cap lengths at the model's max, so overflow means clamp)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
