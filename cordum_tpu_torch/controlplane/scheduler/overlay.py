"""Scheduler dynamic-config overlay: bootstrap + hot watch.

Reference ``cmd/cordum-scheduler/config_overlay.go:27-310``: on boot, seed
the config service from the YAML files (overlay wins over file afterwards);
then poll the effective config on an interval, hash-compare, and on change
atomically swap the routing table (``strategy.update_routing``) and the
reconciler timeouts.

Overlay document shape (under ``cfg:system:scheduler``):
  ``{"pools": {...pools.yaml doc...}, "timeouts": {...timeouts.yaml doc...}}``
"""
from __future__ import annotations

import asyncio
import hashlib
import json
from typing import Optional

from ...infra import logging as logx
from ...infra.config import PoolConfig, Timeouts, parse_pool_config, parse_timeouts
from ...infra.configsvc import ConfigService
from .reconciler import Reconciler
from .strategy import LeastLoadedStrategy

OVERLAY_DOC_ID = "scheduler"


class ConfigOverlay:
    def __init__(
        self,
        configsvc: ConfigService,
        strategy: LeastLoadedStrategy,
        reconciler: Optional[Reconciler] = None,
        *,
        interval_s: float = 30.0,
    ):
        self.configsvc = configsvc
        self.strategy = strategy
        self.reconciler = reconciler
        self.interval_s = interval_s
        self._hash = ""
        self._task: Optional[asyncio.Task] = None

    async def bootstrap(self, pools_doc: dict, timeouts_doc: dict) -> None:
        """Seed the overlay doc from file config unless one already exists."""
        existing = await self.configsvc.get("system", OVERLAY_DOC_ID)
        if existing is None:
            await self.configsvc.set(
                "system", OVERLAY_DOC_ID, {"pools": pools_doc, "timeouts": timeouts_doc}
            )
        await self.apply_once()

    async def apply_once(self) -> bool:
        doc = await self.configsvc.get("system", OVERLAY_DOC_ID)
        if doc is None:
            return False
        h = hashlib.sha256(
            json.dumps(doc.data, sort_keys=True, default=str).encode()
        ).hexdigest()
        if h == self._hash:
            return False
        self._hash = h
        pools_doc = doc.data.get("pools")
        if pools_doc:
            self.strategy.update_routing(parse_pool_config(pools_doc))
            logx.info("scheduler routing updated", revision=doc.revision)
        timeouts_doc = doc.data.get("timeouts")
        if timeouts_doc and self.reconciler is not None:
            self.reconciler.update_timeouts(parse_timeouts(timeouts_doc))
        return True

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="config-overlay")
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.apply_once()
            except Exception:
                logx.error("config overlay apply failed")


class WorkerSnapshotWriter:
    """Writes the live registry to ``sys:workers:snapshot`` every interval
    (reference ``core/infra/registry/snapshot.go``, 5s)."""

    def __init__(self, kv, registry, *, interval_s: float = 5.0):
        self.kv = kv
        self.registry = registry
        self.interval_s = interval_s
        self._task: Optional[asyncio.Task] = None

    async def write_once(self) -> None:
        dead = self.registry.expire()  # TTL expiry loop (registry_memory.go:24)
        if dead:
            logx.info("workers expired", workers=",".join(dead))
        snap = self.registry.snapshot_json()
        await self.kv.set("sys:workers:snapshot", json.dumps(snap).encode())

    async def start(self) -> None:
        async def loop():
            while True:
                try:
                    await self.write_once()
                except Exception:
                    logx.warn("worker snapshot write failed")
                await asyncio.sleep(self.interval_s)

        self._task = asyncio.ensure_future(loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="worker-snapshot-writer")
            self._task = None
