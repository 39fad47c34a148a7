"""Scheduler reconciler + pending replayer: the failure-detection loops.

Reconciler (reference ``core/controlplane/scheduler/reconciler.go``): a
singleton-behind-lock loop that (a) marks stale DISPATCHED/RUNNING jobs
TIMEOUT past their configured timeouts (batched), and (b) expires
``job:deadline`` entries.

Pending replayer (reference ``pending_replayer.go``): re-drives PENDING
jobs older than the dispatch timeout through the engine using the persisted
JobRequest — unsticks submits lost to crashes between persist and dispatch.

Worker failover (docs/SERVING.md §Migration, drain, and failover): expires
workers that missed heartbeats, evicts their affinity entries, and fails
their in-flight jobs over to new workers — a SIGKILL'd serving worker's
sessions resume elsewhere with a forced-decode resume prefix instead of
timing out.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ...infra import logging as logx
from ...infra.config import Timeouts
from ...infra.jobstore import IllegalTransition, JobStore
from ...infra.registry import WorkerRegistry
from ...protocol.subjects import direct_subject
from ...protocol.types import JobState
from ...utils.ids import now_ms, now_us
from .engine import Engine

BATCH = 200
MAX_ITERATIONS = 100
SINGLETON_LOCK = "lock:reconciler"


class Reconciler:
    def __init__(self, job_store: JobStore, timeouts: Timeouts, *, instance_id: str = "rec-0"):
        self.job_store = job_store
        self.timeouts = timeouts
        self.instance_id = instance_id
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    def update_timeouts(self, t: Timeouts) -> None:
        self.timeouts = t

    async def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.ensure_future(self._loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="reconciler")
            self._task = None

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.run_once()
            except Exception:
                logx.error("reconciler pass failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.timeouts.scan_interval_s)
            except asyncio.TimeoutError:
                pass

    async def run_once(self) -> int:
        """One reconciliation pass; returns number of jobs timed out."""
        # singleton guard: only one replica reconciles at a time
        if not await self.job_store.kv.setnx(
            SINGLETON_LOCK, self.instance_id.encode(), ttl_s=self.timeouts.scan_interval_s
        ):
            return 0
        try:
            n = 0
            n += await self._timeout_state(JobState.DISPATCHED, self.timeouts.dispatch_timeout_s)
            n += await self._timeout_state(JobState.RUNNING, self.timeouts.running_timeout_s)
            n += await self._expire_deadlines()
            return n
        finally:
            # owner-checked release: never delete another replica's lock
            # (ours may have TTL-expired mid-pass and been re-acquired)
            cur = await self.job_store.kv.get(SINGLETON_LOCK)
            if cur is not None and cur.decode() == self.instance_id:
                await self.job_store.kv.delete(SINGLETON_LOCK)

    async def _timeout_state(self, state: JobState, timeout_s: float) -> int:
        total = 0
        cutoff_us = now_us() - int(timeout_s * 1e6)
        for _ in range(MAX_ITERATIONS):
            stale = await self.job_store.list_by_state_older_than(state.value, cutoff_us, BATCH)
            if not stale:
                break
            progressed = 0
            for job_id in stale:
                try:
                    changed = await self.job_store.set_state(
                        job_id,
                        JobState.TIMEOUT,
                        fields={"error_message": f"stale in {state.value} > {timeout_s}s"},
                        event="reconciler_timeout",
                    )
                    if changed:
                        total += 1
                        progressed += 1
                except IllegalTransition:
                    progressed += 1  # moved on concurrently; index will catch up
            if not progressed:
                break
        return total

    async def _expire_deadlines(self) -> int:
        expired = await self.job_store.expired_deadlines(now_ms(), limit=BATCH)
        n = 0
        for job_id in expired:
            await self.job_store.clear_deadline(job_id)
            if await self.job_store.is_terminal(job_id):
                continue
            try:
                if await self.job_store.set_state(
                    job_id,
                    JobState.TIMEOUT,
                    fields={"error_message": "deadline exceeded"},
                    event="deadline_expired",
                ):
                    n += 1
            except IllegalTransition:
                pass
        return n


class WorkerFailover:
    """Detects dead workers (missed heartbeats past the registry TTL) and
    fails their in-flight jobs over to new workers.

    Each pass expires the registry, evicts the dead workers' affinity
    entries (so session turns stop routing at the corpse), then scans the
    owner shard's DISPATCHED/RUNNING jobs for ones whose recorded
    ``dispatch_subject`` targets a dead worker's direct subject and drives
    :meth:`Engine.failover_job` for each — serving sessions resume on a new
    worker with their streamed tokens as a forced-decode prefix; stateless
    jobs simply re-run (worker idempotence dedupes the occasional race).
    Per-shard, no singleton lock: each shard fails over only jobs it owns."""

    def __init__(
        self,
        engine: Engine,
        job_store: JobStore,
        registry: WorkerRegistry,
        timeouts: Timeouts,
    ) -> None:
        self.engine = engine
        self.job_store = job_store
        self.registry = registry
        self.timeouts = timeouts
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.ensure_future(self._loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="worker-failover")
            self._task = None

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.run_once()
            except Exception:
                logx.error("worker failover pass failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.timeouts.scan_interval_s)
            except asyncio.TimeoutError:
                pass

    async def run_once(self) -> int:
        dead = self.registry.expire()
        if not dead:
            return 0
        logx.warn("workers missed heartbeats; failing over their jobs",
                  workers=",".join(dead))
        for wid in dead:
            self.engine._evict_affinity(wid)
        dead_subjects = {direct_subject(w) for w in dead}
        n = 0
        for state in (JobState.DISPATCHED.value, JobState.RUNNING.value):
            stuck = await self.job_store.list_by_state_older_than(
                state, now_us(), BATCH
            )
            for job_id in stuck:
                if not self.engine.owns(job_id):
                    continue
                snap = await self.job_store.watch_meta(job_id)
                if snap.get("dispatch_subject", "") not in dead_subjects:
                    continue
                try:
                    if await self.engine.failover_job(job_id, reason="worker_dead"):
                        n += 1
                except Exception:
                    logx.warn("failover failed", job_id=job_id)
        return n


class PendingReplayer:
    """Replays stuck PENDING / APPROVAL-released jobs through the engine."""

    def __init__(self, engine: Engine, job_store: JobStore, timeouts: Timeouts):
        self.engine = engine
        self.job_store = job_store
        self.timeouts = timeouts
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.ensure_future(self._loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="pending-replayer")
            self._task = None

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.run_once()
            except Exception:
                logx.error("pending replayer pass failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.timeouts.scan_interval_s)
            except asyncio.TimeoutError:
                pass

    async def run_once(self) -> int:
        # PENDING gets its own (short) cutoff: a submit that exhausted its
        # bus redeliveries under backpressure, or whose owner shard was
        # down, must resurface in seconds — replays are idempotent
        pending_cutoff_us = now_us() - int(self.timeouts.pending_replay_s * 1e6)
        stuck = await self.job_store.list_by_state_older_than(
            JobState.PENDING.value, pending_cutoff_us, BATCH
        )
        n = 0
        for job_id in stuck:
            if not self.engine.owns(job_id):
                # sharded: a job parked while its owner shard was down is
                # replayed by the OWNER after restart, preserving the
                # no-cross-shard-ownership invariant
                continue
            req = await self.job_store.get_request(job_id)
            if req is None:
                continue
            try:
                await self.engine.handle_job_request(req)
                n += 1
            except Exception:
                logx.warn("replay failed", job_id=job_id)
        # SCHEDULED-but-never-published (crash/bus blip between
        # set_state(SCHEDULED) and the dispatch publish): the submit-path
        # in-flight short-circuit deliberately ignores redeliveries for these,
        # so the replayer re-drives the dispatch leg directly
        dispatch_cutoff_us = now_us() - int(self.timeouts.dispatch_timeout_s * 1e6)
        wedged = await self.job_store.list_by_state_older_than(
            JobState.SCHEDULED.value, dispatch_cutoff_us, BATCH
        )
        for job_id in wedged:
            if not self.engine.owns(job_id):
                continue
            try:
                if await self.engine.redispatch_scheduled(job_id):
                    n += 1
            except Exception:
                logx.warn("redispatch failed", job_id=job_id)
        # DISPATCHED/RUNNING past the result-replay window: the dispatch
        # packet or its terminal result may have been lost to a statebus
        # failover (pub/sub pushes are not replicated) — re-deliver to the
        # worker, whose idempotence turns the nudge into "republish your
        # result" (or a no-op for genuinely still-running jobs)
        nudge_cutoff_us = now_us() - int(self.timeouts.result_replay_s * 1e6)
        for state in (JobState.DISPATCHED.value, JobState.RUNNING.value):
            wedged = await self.job_store.list_by_state_older_than(
                state, nudge_cutoff_us, BATCH
            )
            for job_id in wedged:
                if not self.engine.owns(job_id):
                    continue
                try:
                    if await self.engine.nudge_inflight(job_id):
                        n += 1
                except Exception:
                    logx.warn("inflight nudge failed", job_id=job_id)
        return n
