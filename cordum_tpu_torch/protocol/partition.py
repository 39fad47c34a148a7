"""Keyspace partitioning for the sharded control plane.

Scheduler shards and statebus partitions both carve the id space with the
same function: :func:`partition_of` maps any string id (job id, KV routing
key, subject token) onto ``[0, count)`` deterministically and **stably
across processes and Python versions** — it is the contract that lets the
gateway stamp a partition at submit time and a scheduler shard started
days later in another process agree on who owns the job (the thin
consistency layer of Gavel-style partitioned deciders, PAPERS.md).

CRC-32 rather than ``hash()``: the builtin is salted per process
(PYTHONHASHSEED), which would scatter ownership on every restart.
"""
from __future__ import annotations

import zlib


def partition_of(key: str, count: int) -> int:
    """Stable partition for ``key`` in ``[0, count)``; 0 when unsharded."""
    if count <= 1:
        return 0
    return zlib.crc32(key.encode()) % count


def owns(key: str, index: int, count: int) -> bool:
    """True iff shard/partition ``index`` of ``count`` owns ``key``."""
    return partition_of(key, count) == index
