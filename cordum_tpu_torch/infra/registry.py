"""Worker registry: in-memory heartbeat map with TTL expiry
(reference ``core/controlplane/scheduler/registry_memory.go:11-113``).

TPU delta: workers carry slice telemetry (chip_count, topology, duty cycle,
HBM, device health) used by the slice-aware strategy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..protocol.types import Heartbeat

DEFAULT_TTL_S = 30.0


@dataclass
class WorkerInfo:
    heartbeat: Heartbeat
    last_seen: float = field(default_factory=time.monotonic)


class WorkerRegistry:
    def __init__(self, ttl_s: float = DEFAULT_TTL_S) -> None:
        self.ttl_s = ttl_s
        self._workers: dict[str, WorkerInfo] = {}
        self.version = 0  # bumped on every mutation (packed-scan cache key)

    def update(self, hb: Heartbeat) -> None:
        if hb.worker_id:
            self._workers[hb.worker_id] = WorkerInfo(hb, time.monotonic())
            self.version += 1

    def remove(self, worker_id: str) -> None:
        if self._workers.pop(worker_id, None) is not None:
            self.version += 1

    def expire(self) -> list[str]:
        """Drop workers whose heartbeat is older than TTL; returns dropped ids."""
        cutoff = time.monotonic() - self.ttl_s
        dead = [wid for wid, info in self._workers.items() if info.last_seen < cutoff]
        for wid in dead:
            del self._workers[wid]
        if dead:
            self.version += 1
        return dead

    def get(self, worker_id: str) -> Optional[Heartbeat]:
        info = self._workers.get(worker_id)
        if info is None or info.last_seen < time.monotonic() - self.ttl_s:
            return None
        return info.heartbeat

    def snapshot(self) -> dict[str, Heartbeat]:
        """Live worker map (TTL applied, dict copied — safe for strategy scans)."""
        cutoff = time.monotonic() - self.ttl_s
        return {
            wid: info.heartbeat
            for wid, info in self._workers.items()
            if info.last_seen >= cutoff
        }

    def snapshot_json(self) -> dict:
        return {
            "workers": {wid: hb.to_dict() for wid, hb in self.snapshot().items()},
            "count": len(self._workers),
        }
