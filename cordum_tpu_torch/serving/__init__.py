"""Serving subsystem: paged KV cache + continuous batching (docs/SERVING.md).

The PyTorch counterpart of ``cordum_tpu/serving``:

  * :class:`PageAllocator` — block-granular KV-page bookkeeping over a
    preallocated cache arena (page 0 reserved as the null page)
  * :class:`LlamaServingBackend` — the device side: ONE ragged paged-
    attention step (:class:`StepEntry` rows over a static flat token
    buffer) serving any mix of prefill chunks, decode steps and draft rows
  * :class:`ServingEngine` — the continuous-batching loop: admits new
    sessions and retires finished ones every step, schedules chunked
    prefill *inside* the mixed step under a token budget, streams tokens,
    frees pages on retirement/cancel
"""
from .backend import LlamaServingBackend, StepEntry
from .engine import (
    GenRequest,
    ServingEngine,
    ServingStats,
    SessionCancelled,
    SessionMigrated,
    SessionRequeued,
)
from .pager import CacheExhausted, PageAllocator

__all__ = [
    "CacheExhausted",
    "GenRequest",
    "LlamaServingBackend",
    "PageAllocator",
    "ServingEngine",
    "ServingStats",
    "SessionCancelled",
    "SessionMigrated",
    "SessionRequeued",
    "StepEntry",
]
