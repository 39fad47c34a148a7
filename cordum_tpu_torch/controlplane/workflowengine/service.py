"""Workflow-engine service: bus consumer + run reconciler.

Recreates the reference service (``core/controlplane/workflowengine/``):
subscribes ``sys.job.result`` in the ``cordum-workflow-engine`` queue group,
takes a per-run lock before advancing the run (NAK-with-delay on
contention — two consumers may converge on the same run), and a reconciler
loop that (a) resumes delay steps and parked retries whose time has come,
and (b) replays terminal job states from the JobStore into the engine for
results the service missed (crash between worker publish and engine apply).
"""
from __future__ import annotations

import asyncio
import random
import time
from typing import Optional

from ...infra import logging as logx
from ...infra.bus import Bus, MAX_NAK_DELAY_S, RetryAfter
from ...infra.jobstore import JobStore
from ...protocol import subjects as subj
from ...protocol.types import BusPacket, JobResult, JobState, TERMINAL_STATES
from ...workflow import models as M
from ...workflow.engine import Engine as WorkflowEngine, split_job_id

# base NAK delay for run-lock contention; doubles per redelivery with ±25 %
# jitter, capped at MAX_NAK_DELAY_S (the scheduler's tenant-NAK convention,
# docs/PROTOCOL.md §Subjects) — two replicas converging on one hot run
# de-synchronize instead of retrying in lockstep
RUN_LOCK_NAK_BASE_S = 0.05


class WorkflowEngineService:
    def __init__(
        self,
        *,
        engine: WorkflowEngine,
        bus: Bus,
        job_store: Optional[JobStore] = None,
        instance_id: str = "wf-svc-0",
        reconcile_interval_s: float = 5.0,
    ):
        self.engine = engine
        self.bus = bus
        self.job_store = job_store
        self.instance_id = instance_id
        self.reconcile_interval_s = reconcile_interval_s
        self._subs: list = []
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        self._subs.append(
            await self.bus.subscribe(
                subj.RESULT, self._on_result, queue=subj.QUEUE_WORKFLOW_ENGINE
            )
        )
        # under a sharded scheduler, workers echo the owning shard's
        # partition and publish on ``sys.job.result.<p>`` — without this
        # wildcard the engine would only advance runs via the reconciler's
        # JobStore replay (one reconcile interval of latency per step)
        self._subs.append(
            await self.bus.subscribe(
                f"{subj.RESULT}.>", self._on_result, queue=subj.QUEUE_WORKFLOW_ENGINE
            )
        )
        # context.* steps executed in-engine report on their own subject
        # (the scheduler must not see jobs it never dispatched); same queue
        # group, so any replica applies them under the run lock
        self._subs.append(
            await self.bus.subscribe(
                subj.STEP_RESULT, self._on_result, queue=subj.QUEUE_WORKFLOW_ENGINE
            )
        )
        self._stop.clear()
        self._task = asyncio.ensure_future(self._reconcile_loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        self._stop.set()
        if self._task:
            self._task.cancel()
            await logx.join_task(self._task, name="workflow-reconciler")
            self._task = None

    # ------------------------------------------------------------------
    async def _on_result(self, subject: str, pkt: BusPacket) -> None:
        res = pkt.job_result
        if res is None or not res.job_id:
            return
        await self.handle_job_result(res, redeliveries=pkt.redelivery_count)

    async def handle_job_result(self, res: JobResult, *, redeliveries: int = 0) -> None:
        try:
            run_id, _, _ = split_job_id(res.job_id)
        except ValueError:
            return  # not a workflow job
        if not await self.engine.store.acquire_run_lock(run_id, self.instance_id):
            delay = min(
                MAX_NAK_DELAY_S,
                RUN_LOCK_NAK_BASE_S * (2 ** max(0, redeliveries)),
            )
            delay *= 1.0 + random.uniform(-0.25, 0.25)
            raise RetryAfter(delay, f"run {run_id} locked")
        try:
            await self.engine.handle_job_result(res)
        finally:
            await self.engine.store.release_run_lock(run_id, self.instance_id)

    # ------------------------------------------------------------------
    async def _reconcile_loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.reconcile_once()
            except Exception:
                logx.error("workflow reconciler pass failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.reconcile_interval_s)
            except asyncio.TimeoutError:
                pass

    async def reconcile_once(self) -> int:
        """Resume due waits and replay missed terminal job states.

        The per-pass scan is batched: all status indexes are read in one
        concurrent zrange batch, and runs whose lock is already held are
        skipped off a single lock-prefix scan instead of paying a setnx
        round trip per busy run.  Pass cost lands in
        ``cordum_workflow_reconcile_seconds``; the live-run count feeds
        ``cordum_workflow_active_runs``."""
        t0 = time.monotonic()
        progressed = 0
        store = self.engine.store
        rows = await store.list_run_ids_by_statuses((M.PENDING, M.RUNNING, M.WAITING))
        metrics = self.engine.metrics
        metrics.workflow_active_runs.set(float(len({rid for _, rid in rows})))
        held = await store.held_run_locks() if rows else set()
        for _status, run_id in rows:
            if run_id in held:
                continue  # busy under another replica; next pass retries
            if not await store.acquire_run_lock(run_id, self.instance_id):
                continue  # lost a race since the prefix scan
            try:
                if await self.engine.resume_due(run_id):
                    progressed += 1
                if self.job_store is not None:
                    progressed += await self._replay_terminal_jobs(run_id)
            except Exception:
                # one poisoned run must not starve the rest of the pass
                logx.error("reconcile failed for run", run_id=run_id)
            finally:
                await store.release_run_lock(run_id, self.instance_id)
        metrics.workflow_reconcile_seconds.observe(time.monotonic() - t0)
        return progressed

    async def _replay_terminal_jobs(self, run_id: str) -> int:
        """If the JobStore saw a terminal state for a step's job but the run
        still shows it RUNNING, synthesize the JobResult and apply it."""
        run = await self.engine.store.get_run(run_id)
        if run is None:
            return 0
        n = 0
        for sr in run.steps.values():
            for t in [sr, *sr.children.values()]:
                if t.status != M.RUNNING or not t.job_id:
                    continue
                meta = await self.job_store.get_meta(t.job_id)
                state = meta.get("state", "")
                if state and state in (s.value for s in TERMINAL_STATES):
                    try:
                        execution_ms = int(meta.get("execution_ms", "0") or 0)
                    except ValueError:
                        execution_ms = 0
                    # the replay mirrors every JobResult field the live path
                    # persists (scheduler _result_fields); result labels are
                    # transport-only stream metadata the engine never reads,
                    # so the synthesized result carries the wire default
                    res = JobResult(
                        job_id=t.job_id,
                        status=state,
                        result_ptr=meta.get("result_ptr", ""),
                        worker_id=meta.get("worker_id", ""),
                        execution_ms=execution_ms,
                        error_code=meta.get("error_code", ""),
                        error_message=meta.get("error_message", ""),
                    )
                    await self.engine.handle_job_result(res)
                    n += 1
        return n
