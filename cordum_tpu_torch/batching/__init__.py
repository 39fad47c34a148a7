"""Micro-batching engine: coalesce batchable jobs into bucketed device calls.

One control-plane job per device call leaves the card idle between tiny
calls — launch and round-trip overhead dominates for single-text ``embed``
and short ``infer`` requests.  This package sits between the worker's job
intake and the device handlers: batchable jobs land in per-(op,
length-bucket) queues, an adaptive window flushes each queue into ONE
padded bf16 device call, and the
per-job results scatter back so downstream consumers see ordinary
``JobResult`` packets (see ``docs/BATCHING.md``).
"""
from .buckets import bucket_for, pow2_buckets
from .engine import BatchCancelled, BatchItem, BatchParts, MicroBatcher

__all__ = [
    "BatchCancelled",
    "BatchItem",
    "BatchParts",
    "MicroBatcher",
    "bucket_for",
    "pow2_buckets",
]
