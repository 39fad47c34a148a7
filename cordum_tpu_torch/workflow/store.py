"""Workflow store: definitions, runs, timeline, idempotency
(reference ``core/workflow/store_redis.go:24-520``).

Keys: ``wf:def:<id>`` (+ org/all z-indexes), ``wf:run:<id>``
(+ per-workflow / all / status / org-active indexes), append-only timeline
list ``wf:run:timeline:<id>``, idempotency ``wf:run:idempotency:<key>``.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional

from ..infra.kv import KV
from ..utils.ids import now_us
from .models import RUN_TERMINAL, TimelineEvent, Workflow, WorkflowRun

TIMELINE_CAP = 500

RUN_LOCK_PREFIX = "lock:wfrun:"


def def_key(wf_id: str) -> str:
    return f"wf:def:{wf_id}"


def run_key(run_id: str) -> str:
    return f"wf:run:{run_id}"


def timeline_key(run_id: str) -> str:
    return f"wf:run:timeline:{run_id}"


class WorkflowStore:
    def __init__(self, kv: KV):
        self.kv = kv

    # -- definitions ------------------------------------------------------
    async def put_workflow(self, wf: Workflow) -> None:
        wf.created_at_us = wf.created_at_us or now_us()
        await self.kv.set(def_key(wf.id), json.dumps(wf.to_dict()).encode())
        await self.kv.zadd("wf:def:index", wf.id, float(wf.created_at_us))
        if wf.org_id:
            await self.kv.zadd(f"wf:def:org:{wf.org_id}", wf.id, float(wf.created_at_us))

    async def get_workflow(self, wf_id: str) -> Optional[Workflow]:
        b = await self.kv.get(def_key(wf_id))
        return Workflow.from_dict(json.loads(b)) if b else None

    async def delete_workflow(self, wf_id: str) -> bool:
        n = await self.kv.delete(def_key(wf_id))
        await self.kv.zrem("wf:def:index", wf_id)
        return n > 0

    async def list_workflows(self, limit: int = 100) -> list[str]:
        return await self.kv.zrange("wf:def:index", 0, limit - 1, desc=True)

    # -- runs --------------------------------------------------------------
    async def put_run(self, run: WorkflowRun) -> None:
        # one pipelined commit instead of ~11 serial KV round trips: put_run
        # sits on the result hot path (every applied step re-saves the run),
        # so the blob + index maintenance ship as a single PIPE frame
        run.updated_at_us = now_us()
        pipe = self.kv.pipeline()
        pipe.set(run_key(run.run_id), json.dumps(run.to_dict()).encode())
        pipe.zadd("wf:run:index", run.run_id, float(run.created_at_us or run.updated_at_us))
        pipe.zadd(f"wf:run:wf:{run.workflow_id}", run.run_id, float(run.created_at_us))
        # status indexes: remove from all, add to current
        for st in ("PENDING", "RUNNING", "WAITING", "WAITING_APPROVAL", "SUCCEEDED", "FAILED", "CANCELLED"):
            if st != run.status:
                pipe.zrem(f"wf:run:status:{st}", run.run_id)
        pipe.zadd(f"wf:run:status:{run.status}", run.run_id, float(run.updated_at_us))
        if run.org_id:
            if run.status in RUN_TERMINAL:
                pipe.zrem(f"wf:run:org_active:{run.org_id}", run.run_id)
            else:
                pipe.zadd(f"wf:run:org_active:{run.org_id}", run.run_id, float(run.updated_at_us))
        await pipe.execute()

    async def get_run(self, run_id: str) -> Optional[WorkflowRun]:
        b = await self.kv.get(run_key(run_id))
        return WorkflowRun.from_dict(json.loads(b)) if b else None

    async def list_runs(self, workflow_id: str = "", limit: int = 100) -> list[str]:
        key = f"wf:run:wf:{workflow_id}" if workflow_id else "wf:run:index"
        return await self.kv.zrange(key, 0, limit - 1, desc=True)

    async def list_run_ids_by_status(self, status: str, limit: int = 200) -> list[str]:
        return await self.kv.zrange(f"wf:run:status:{status}", 0, limit - 1)

    async def list_run_ids_by_statuses(
        self, statuses: tuple[str, ...], limit: int = 200
    ) -> list[tuple[str, str]]:
        """→ ``[(status, run_id), …]`` for several status indexes in ONE
        concurrent batch of zrange reads (the reconciler's per-pass scan
        used to pay one serial round trip per status)."""
        rows = await asyncio.gather(
            *(self.kv.zrange(f"wf:run:status:{st}", 0, limit - 1) for st in statuses)
        )
        return [(st, rid) for st, ids in zip(statuses, rows) for rid in ids]

    async def get_runs(self, run_ids: list[str]) -> list[Optional[WorkflowRun]]:
        """Batch run fetch (concurrent reads) for listings and reconciler
        sweeps; order matches ``run_ids``, misses come back ``None``."""
        blobs = await asyncio.gather(*(self.kv.get(run_key(r)) for r in run_ids))
        return [
            WorkflowRun.from_dict(json.loads(b)) if b else None for b in blobs
        ]

    async def count_active_runs(self, org_id: str) -> int:
        return await self.kv.zcard(f"wf:run:org_active:{org_id}")

    async def delete_run(self, run_id: str) -> bool:
        run = await self.get_run(run_id)
        n = await self.kv.delete(run_key(run_id), timeline_key(run_id))
        await self.kv.zrem("wf:run:index", run_id)
        if run:
            await self.kv.zrem(f"wf:run:wf:{run.workflow_id}", run_id)
            await self.kv.zrem(f"wf:run:status:{run.status}", run_id)
            if run.org_id:
                await self.kv.zrem(f"wf:run:org_active:{run.org_id}", run_id)
        return n > 0

    # -- timeline -----------------------------------------------------------
    async def append_timeline(self, ev: TimelineEvent) -> None:
        ev.ts_us = ev.ts_us or now_us()
        await self.kv.rpush(timeline_key(ev.run_id), json.dumps(ev.to_dict()).encode())
        await self.kv.ltrim(timeline_key(ev.run_id), -TIMELINE_CAP, -1)

    async def timeline(self, run_id: str) -> list[dict]:
        return [json.loads(b) for b in await self.kv.lrange(timeline_key(run_id))]

    # -- idempotency ---------------------------------------------------------
    async def try_set_run_idempotency(self, key: str, run_id: str, ttl_s: float = 24 * 3600) -> tuple[bool, str]:
        k = f"wf:run:idempotency:{key}"
        ok = await self.kv.setnx(k, run_id.encode(), ttl_s)
        if ok:
            return True, run_id
        cur = await self.kv.get(k)
        return False, cur.decode() if cur else ""

    # -- run locks ------------------------------------------------------------
    async def acquire_run_lock(self, run_id: str, owner: str, ttl_s: float = 30.0) -> bool:
        return await self.kv.setnx(RUN_LOCK_PREFIX + run_id, owner.encode(), ttl_s)

    async def release_run_lock(self, run_id: str, owner: str) -> None:
        # owner-checked compare-and-delete in one round trip (del_eq) instead
        # of the old read-then-delete pair
        await self.kv.del_eq(RUN_LOCK_PREFIX + run_id, owner.encode())

    async def held_run_locks(self) -> set[str]:
        """Run ids whose lock key currently exists — ONE prefix scan, so the
        reconciler can skip busy runs without a setnx round trip per run."""
        keys = await self.kv.keys(RUN_LOCK_PREFIX)
        return {k[len(RUN_LOCK_PREFIX):] for k in keys}
