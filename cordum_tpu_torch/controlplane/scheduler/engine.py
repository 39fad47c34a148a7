"""Scheduler engine: the core job-processing state machine.

Recreates reference ``core/controlplane/scheduler/engine.go`` behavior,
redesigned for asyncio + at-least-once redelivery:

  * consumes ``sys.job.submit`` / ``sys.job.result`` / ``sys.job.cancel``
    (queue group) + ``sys.heartbeat`` (fan-out)
  * per-job KV lock before mutating state; contention → RetryAfter NAK
    (the reference's 25ms lock spin redesigned as bus redelivery,
    SURVEY.md §7 "hard parts")
  * safety gate with approval-hash re-check: a job carrying
    ``approval_granted`` is re-hashed and compared to the stored decision's
    hash before the stored constraints are honored (engine.go:484-522)
  * decision branches: DENY → DLQ; REQUIRE_APPROVAL → APPROVAL_REQUIRED
    park; THROTTLE → delayed redelivery; ALLOW_WITH_CONSTRAINTS → env
    injection + budget clamp (engine.go:298-347, applyConstraints :674-706)
  * max-attempts + tenant-concurrency + deadline registration
  * strategy pick → SCHEDULED → publish job packet → DISPATCHED → RUNNING
  * ``handleJobResult``: terminal state + result_ptr, DLQ on failure,
    terminal-state short-circuit for idempotency under redelivery
  * tick batching: submits landing in one event-loop tick drain
    into ONE selection pass + grouped pipelined commits; anything off the
    common path (redelivery, non-ALLOW decisions, tenant limits) falls back
    to the per-job path above, so the batch is a pure fast path
"""
from __future__ import annotations

import asyncio
import contextlib
import random
import time
from typing import AsyncIterator, Optional

from ...infra import codec, logging as logx, syncsan
from ...infra.bus import Bus, MAX_NAK_DELAY_S, RetryAfter
from ...infra.configsvc import ConfigService
from ...infra.jobstore import JobStore, MetaSnapshot, SafetyDecisionRecord, meta_key
from ...infra.metrics import Metrics
from ...infra.registry import WorkerRegistry
from ...obs.tracer import Tracer, current_trace_context
from ...protocol import subjects as subj
from ...protocol.jobhash import job_hash
from ...protocol.partition import partition_of
from ...utils.eager import eager_gather
from ...utils.ids import now_us
from ...protocol.types import (
    BusPacket,
    Constraints,
    Decision,
    ENV_EFFECTIVE_CONFIG,
    ERROR_SESSION_REQUEUE,
    JobPreempt,
    JobRequest,
    JobResult,
    JobState,
    LABEL_APPROVAL_GRANTED,
    LABEL_PARTITION,
    LABEL_RESUME_TOKENS,
    PolicyCheckRequest,
    STATUS_HINT_STREAM,
    TERMINAL_STATES,
    gang_workers,
)
from .safety_client import SafetyClient
from .strategy import Strategy

DEFAULT_MAX_ATTEMPTS = 5
DEFAULT_SUBMIT_CONCURRENCY = 64
ENV_POLICY_CONSTRAINTS = "CORDUM_POLICY_CONSTRAINTS"
ENV_MAX_CHIPS = "CORDUM_MAX_CHIPS"
# tenant-concurrency NAK backoff base: doubles per redelivery (±25% jitter)
# so a tenant burst de-synchronizes instead of NAKing in lockstep
TENANT_NAK_BASE_S = 0.25
# batch preemption under interactive SLO pressure (docs/ADMISSION.md):
# at most this many BATCH jobs preempted per pressure beacon, each held
# off this long (jittered) before its attempts-exempt re-dispatch, and
# never re-preempted within the cooldown
MAX_PREEMPTIONS_PER_PRESSURE = 8
PREEMPT_HOLDOFF_S = 1.0
PREEMPT_COOLDOWN_S = 5.0
PREEMPTED_REASON = "preempted"

_INFLIGHT_STATES = (
    JobState.SCHEDULED.value,
    JobState.DISPATCHED.value,
    JobState.RUNNING.value,
)


def _owns_everything(job_id: str) -> bool:
    """Identity ownership for the unsharded engine — bound at construction
    so the 1×1 hot path never hashes a job id."""
    return True


class _SubmitItem:
    """One submit riding a scheduler tick batch."""

    __slots__ = (
        "req", "trace_id", "parent_span_id", "fut",
        "snap", "pending", "resp", "sched_sp", "target", "redeliveries",
    )

    def __init__(self, req: JobRequest, trace_id: str, parent_span_id: str,
                 fut: "asyncio.Future[None]", redeliveries: int = 0) -> None:
        self.req = req
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.fut = fut
        self.redeliveries = redeliveries
        self.snap: Optional[MetaSnapshot] = None
        self.pending: dict[str, str] = {}
        self.resp = None
        self.sched_sp = None
        self.target = ""

    @property
    def job_id(self) -> str:
        return self.req.job_id


class _ResultItem:
    """One job result riding a scheduler tick batch."""

    __slots__ = ("res", "trace_id", "parent_span_id", "fut", "snap",
                 "sched_sp", "state")

    def __init__(self, res: JobResult, trace_id: str, parent_span_id: str,
                 fut: "asyncio.Future[None]") -> None:
        self.res = res
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.fut = fut
        self.snap: Optional[MetaSnapshot] = None
        self.sched_sp = None  # the per-item "result" span (see _fail_item)
        self.state: Optional[JobState] = None

    @property
    def job_id(self) -> str:
        return self.res.job_id


@syncsan.instrument
class Engine:
    def __init__(
        self,
        *,
        bus: Bus,
        job_store: JobStore,
        safety: SafetyClient,
        strategy: Strategy,
        registry: WorkerRegistry,
        configsvc: Optional[ConfigService] = None,
        metrics: Optional[Metrics] = None,
        instance_id: str = "scheduler-0",
        max_attempts: int = DEFAULT_MAX_ATTEMPTS,
        tenant_concurrency_limit: int = 0,
        tracer: Optional[Tracer] = None,
        submit_concurrency: int = DEFAULT_SUBMIT_CONCURRENCY,
        shard_index: int = 0,
        shard_count: int = 1,
        batch_ticks: bool = True,
    ):
        self.bus = bus
        self.tracer = tracer or Tracer("scheduler", bus)
        self.job_store = job_store
        self.safety = safety
        self.strategy = strategy
        self.registry = registry
        self.configsvc = configsvc
        self.metrics = metrics or Metrics()
        self.instance_id = instance_id
        self.max_attempts = max_attempts
        self.tenant_concurrency_limit = tenant_concurrency_limit
        # jobs are processed concurrently (the per-job KV lock guarantees
        # safety); the semaphore bounds in-flight work so a submit burst
        # can't spawn unbounded tasks all hammering the state bus at once
        self.submit_concurrency = max(1, submit_concurrency)
        self._sem = asyncio.Semaphore(self.submit_concurrency)
        # keyspace sharding: shard i of n owns every job with
        # partition_of(job_id, n) == i and consumes its hash-partitioned
        # lifecycle subjects; there is NO cross-shard lock — worker load and
        # batch affinity live in per-shard caches fed by fan-out heartbeats
        # and tolerate bounded staleness (docs/PROTOCOL.md §Partitioning)
        if not (0 <= shard_index < max(1, shard_count)):
            raise ValueError(f"shard_index {shard_index} out of range for {shard_count} shards")
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self._shard_label = str(shard_index)
        if self.shard_count == 1:
            # 1×1 specialization: ownership and partition stamping collapse
            # to identity at construction — no per-message branch or crc32
            self.owns = _owns_everything  # type: ignore[method-assign]
            self._stamp_partition = self._stamp_noop  # type: ignore[method-assign]
        self._inflight = 0  # submit backlog gauge (cordum_shard_partition_queue_depth)
        # start()/stop() hold this across their subscribe/teardown awaits so
        # a racing start+stop pair cannot interleave at an await and leak a
        # subscription or a half-cancelled drain task (CL008)
        self._lifecycle_lock = asyncio.Lock()
        self._subs = []  # cordum: guarded-by(_lifecycle_lock)
        # tick batching: submits arriving in one event-loop tick
        # drain together; grouped commits need co-committable keys, which
        # kv.pipe_group answers per key
        self.batch_ticks = batch_ticks
        self._submit_q: list[_SubmitItem] = []
        self._result_q: list[_ResultItem] = []
        self._submit_wake = asyncio.Event()
        self._drain_task: Optional[asyncio.Task] = None  # cordum: guarded-by(_lifecycle_lock)
        # dispatch-time snapshot cache: the RUNNING commit's post-commit
        # MetaSnapshot, so the result path needs ZERO reads in the common
        # case (a conflict — e.g. a cancel racing the result — re-reads)
        self._snap_cache: dict[str, MetaSnapshot] = {}
        # serving failover (docs/SERVING.md §Migration, drain, and
        # failover): the owner shard shadows each live session's streamed
        # tokens in memory (offset-merged from stream progress packets) so
        # a crash re-dispatch can stamp them as the forced-decode resume
        # prefix.  Deliberately NOT persisted — per-token writes would
        # swamp the job store; after a scheduler restart a failover simply
        # replays from the prompt (same tokens, more decode work).
        self._stream_tokens: dict[str, list[int]] = {}
        # batch preemption under interactive SLO pressure (docs/ADMISSION.md
        # §Preemption): the gateway admission controller's pressure beacons
        # trigger a bounded scan that asks workers to hand back dispatched
        # BATCH jobs; preempted jobs re-dispatch attempts-exempt after a
        # jittered hold-off
        self._preempt_cooldown: dict[str, float] = {}
        self._preempt_tasks: set[asyncio.Task] = set()
        self._preempt_scan: Optional[asyncio.Task] = None
        # gang scheduling (docs/GANG.md): attached by GangScheduler's
        # constructor; submits carrying cordum.gang_workers depart the
        # single-worker dispatch path at _post_decision
        self.gangs = None
        # kv round-trip accounting (cordum_kv_roundtrips_total{op}) for the
        # store this engine drives — the bench's kv_roundtrips_per_job source
        job_store.kv.bind_metrics(self.metrics)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        async with self._lifecycle_lock:
            # plain subjects stay subscribed even when sharded: they are the
            # unstamped-publisher fallback — whichever shard draws the message
            # from the queue group forwards it to the owner's partition subject
            self._subs = [
                await self.bus.subscribe(subj.SUBMIT, self._on_submit, queue=subj.QUEUE_SCHEDULER),
                await self.bus.subscribe(subj.RESULT, self._on_result, queue=subj.QUEUE_SCHEDULER),
                await self.bus.subscribe(subj.CANCEL, self._on_cancel, queue=subj.QUEUE_SCHEDULER),
                await self.bus.subscribe(subj.HEARTBEAT, self._on_heartbeat),
                await self.bus.subscribe(subj.PROGRESS, self._on_progress),
                await self.bus.subscribe(subj.ADMISSION_PRESSURE, self._on_pressure),
            ]
            if self.shard_count > 1:
                # this shard's slice of the keyspace: its own partition subjects
                # (queue groups so replicas of one shard still split the load)
                q = f"{subj.QUEUE_SCHEDULER}-{self.shard_index}"
                self._subs += [
                    await self.bus.subscribe(
                        subj.submit_subject(self.shard_index, self.shard_count),
                        self._on_submit, queue=q),
                    await self.bus.subscribe(
                        subj.result_subject(self.shard_index, self.shard_count),
                        self._on_result, queue=q),
                    await self.bus.subscribe(
                        subj.cancel_subject(self.shard_index, self.shard_count),
                        self._on_cancel, queue=q),
                ]
            if self.batch_ticks and self._drain_task is None:
                self._drain_task = asyncio.ensure_future(self._submit_drain_loop())

    async def stop(self) -> None:
        async with self._lifecycle_lock:
            for s in self._subs:
                s.unsubscribe()
            self._subs = []
            if self._drain_task is not None:
                self._drain_task.cancel()
                try:
                    await self._drain_task
                except asyncio.CancelledError:
                    pass
                self._drain_task = None
            for it in [*self._submit_q, *self._result_q]:
                if not it.fut.done():
                    it.fut.cancel()
            self._submit_q = []
            self._result_q = []
            self._snap_cache.clear()
            self._stream_tokens.clear()
            if self._preempt_scan is not None:
                self._preempt_scan.cancel()
                await logx.join_task(self._preempt_scan, name="preempt-scan")
                self._preempt_scan = None
            for t in list(self._preempt_tasks):
                t.cancel()
                await logx.join_task(t, name="preempt-redispatch")
            self._preempt_tasks.clear()
            self._preempt_cooldown.clear()

        # ------------------------------------------------------------------
    def owns(self, job_id: str) -> bool:
        return partition_of(job_id, self.shard_count) == self.shard_index

    async def _forward_to_owner(
        self, kind: str, job_id: str, subject_fn, pkt: BusPacket
    ) -> None:
        """Route an unstamped message to the owning shard's partition
        subject (one extra bus hop; the stamped fast path skips it)."""
        p = partition_of(job_id, self.shard_count)
        self.metrics.shard_forwarded.inc(kind=kind, shard=self._shard_label)
        await self.bus.publish(subject_fn(p, self.shard_count), pkt)

    # ------------------------------------------------------------------
    async def _on_heartbeat(self, subject: str, pkt: BusPacket) -> None:
        hb = pkt.heartbeat
        if hb is None:
            return
        if hb.draining and hb.worker_id:
            # drain beacon: deregister on sight and drop every affinity
            # entry pointing at the worker — new session/batch jobs must
            # not route to a worker that is migrating its state away
            self.registry.remove(hb.worker_id)
            self._evict_affinity(hb.worker_id)
        else:
            self.registry.update(hb)
        self.metrics.workers_live.set(len(self.registry.snapshot()))
        if hb.worker_id:
            self.metrics.tpu_duty_cycle.set(hb.tpu_duty_cycle, worker=hb.worker_id)

    def _evict_affinity(self, worker_id: str) -> None:
        evict = getattr(self.strategy, "evict_worker", None)
        if evict is not None:
            evict(worker_id)

    async def _on_progress(self, subject: str, pkt: BusPacket) -> None:
        pr = pkt.job_progress
        if pr is None or not pr.job_id:
            return
        if pr.status_hint == STATUS_HINT_STREAM:
            # llm.generate token-stream packets are transport, not state:
            # the gateway WS tap relays them live and the terminal result
            # carries the full token list — persisting one event per decode
            # step would swamp the job store.  The owner shard DOES shadow
            # them in memory: they become the forced-decode resume prefix
            # when the worker dies mid-session (failover_job).
            if pr.tokens and self.owns(pr.job_id):
                self._record_stream(pr.job_id, pr.offset, pr.tokens)
            return
        if not self.owns(pr.job_id):
            return  # progress fans out to every shard; only the owner records
        await self.job_store.append_event(
            pr.job_id, "progress", percent=pr.percent, message=pr.message
        )

    def _record_stream(self, job_id: str, offset: int, tokens: list) -> None:
        buf = self._stream_tokens.get(job_id)
        if buf is None:
            if len(self._stream_tokens) > 8192:
                self._stream_tokens.clear()  # leak guard (entries pop on terminal)
            buf = self._stream_tokens[job_id] = []
        off = offset if isinstance(offset, int) and offset >= 0 else len(buf)
        for i, t in enumerate(tokens):
            idx = off + i
            if idx == len(buf):
                buf.append(int(t))
            elif idx < len(buf):
                buf[idx] = int(t)
            # idx > len(buf): a gap (lost packet) — the worker's resume
            # replay at offset 0 backfills it on the next failover

    async def _on_cancel(self, subject: str, pkt: BusPacket) -> None:
        c = pkt.job_cancel
        if c is None or not c.job_id:
            return
        if not self.owns(c.job_id):
            await self._forward_to_owner("cancel", c.job_id, subj.cancel_subject, pkt)
            return
        if await self.job_store.cancel_job(c.job_id):
            await self.job_store.append_event(c.job_id, "cancelled", reason=c.reason)
            if self.gangs is not None:
                # a cancelled gang job aborts its whole gang (members stop,
                # devices release) without a requeue
                await self.gangs.on_cancel(c.job_id)

    # ------------------------------------------------------------------
    # batch preemption (docs/ADMISSION.md §Preemption): the telemetry
    # plane changing the data plane — interactive SLO pressure requeues
    # dispatched BATCH work instead of letting interactive p99 collapse
    # ------------------------------------------------------------------
    async def _on_pressure(self, subject: str, pkt: BusPacket) -> None:
        ap = pkt.admission_pressure
        if ap is None or not ap.preempt_batch:
            return
        if self._preempt_scan is not None and not self._preempt_scan.done():
            return  # single-flight: one scan per beacon at most
        self._preempt_scan = asyncio.ensure_future(self._preempt_batch_jobs())

    async def _preempt_batch_jobs(self) -> int:
        """Scan owned DISPATCHED/RUNNING BATCH jobs and ask their workers to
        hand them back (bounded per beacon, per-job cooldown).  Workers
        requeue where that is safe (queued intake slots, serving sessions);
        a handler already executing simply ignores the request."""
        now = time.monotonic()
        self._preempt_cooldown = {
            jid: t for jid, t in self._preempt_cooldown.items()
            if now - t < PREEMPT_COOLDOWN_S
        }
        n = 0
        for state in (JobState.RUNNING.value, JobState.DISPATCHED.value):
            if n >= MAX_PREEMPTIONS_PER_PRESSURE:
                break
            for jid in await self.job_store.list_by_state(state, 128):
                if n >= MAX_PREEMPTIONS_PER_PRESSURE:
                    break
                if not self.owns(jid) or jid in self._preempt_cooldown:
                    continue
                meta = await self.job_store.get_meta(jid)
                if (meta.get("priority") or "BATCH") != "BATCH":
                    continue  # only BATCH yields to interactive pressure
                if meta.get("state") != state:
                    continue  # moved on concurrently
                await self.preempt_job(jid)
                n += 1
        return n

    async def preempt_job(self, job_id: str, *, reason: str = "slo_pressure") -> None:
        """Fan out a :class:`JobPreempt` for one BATCH job.  Fire-and-forget:
        the holding worker answers with a non-terminal ``SESSION_REQUEUE``
        result (reason ``preempted``) when it can yield the job."""
        self._preempt_cooldown[job_id] = time.monotonic()
        self.metrics.preemptions.inc(reason="requested")
        await self.bus.publish(
            subj.PREEMPT,
            BusPacket.wrap(
                JobPreempt(job_id=job_id, reason=reason,
                           requested_by=self.instance_id),
                sender_id=self.instance_id,
            ),
        )

    def _schedule_preempt_redispatch(self, job_id: str) -> None:
        """Attempts-exempt re-dispatch of a preempted job after a jittered
        hold-off — long enough for the interactive burst to drain ahead of
        it, short enough that preemption never strands work (the replayer's
        result-replay nudge backstops it regardless)."""
        async def _redispatch() -> None:
            await asyncio.sleep(
                PREEMPT_HOLDOFF_S * (1.0 + random.uniform(-0.5, 0.5))
            )
            moved = await self.failover_job(
                job_id, reason=PREEMPTED_REASON, count_attempt=False
            )
            if moved:
                self.metrics.preemptions.inc(reason="redispatched")

        t = asyncio.ensure_future(_redispatch())
        self._preempt_tasks.add(t)
        t.add_done_callback(self._preempt_tasks.discard)

    # ------------------------------------------------------------------
    async def _on_submit(self, subject: str, pkt: BusPacket) -> None:
        req = pkt.job_request
        if req is None or not req.job_id or not req.topic:
            return
        if not self.owns(req.job_id):
            await self._forward_to_owner("submit", req.job_id, subj.submit_subject, pkt)
            return
        self._inflight += 1
        self.metrics.shard_queue_depth.set(float(self._inflight), shard=self._shard_label)
        try:
            if self.batch_ticks and self._drain_task is not None:
                # enqueue for the tick batch; the await preserves per-message
                # semantics exactly (a RetryAfter raised while processing the
                # batch propagates to THIS delivery and drives redelivery)
                fut: asyncio.Future[None] = asyncio.get_running_loop().create_future()
                self._submit_q.append(
                    _SubmitItem(req, pkt.trace_id, pkt.span_id, fut,
                                pkt.redelivery_count)
                )
                self._submit_wake.set()
                await fut
            else:
                async with self._sem:
                    await self.handle_job_request(
                        req, trace_id=pkt.trace_id, parent_span_id=pkt.span_id,
                        redeliveries=pkt.redelivery_count,
                    )
        finally:
            self._inflight -= 1
            self.metrics.shard_queue_depth.set(float(self._inflight), shard=self._shard_label)

    # ------------------------------------------------------------------
    # tick batching: the submit fast path
    # ------------------------------------------------------------------
    async def _submit_drain_loop(self) -> None:
        """Drain every submit that accumulated during the last event-loop
        tick and process them as ONE batch (mirror of the statebus write
        coalescer).  The loop is single-flight: submits arriving while a
        batch is in progress form the next batch."""
        while True:
            await self._submit_wake.wait()
            self._submit_wake.clear()
            batch = self._submit_q[: self.submit_concurrency]
            del self._submit_q[: self.submit_concurrency]
            rbatch = self._result_q[: self.submit_concurrency]
            del self._result_q[: self.submit_concurrency]
            if self._submit_q or self._result_q:
                self._submit_wake.set()
            for items, process in (
                (batch, self._process_submit_batch),
                (rbatch, self._process_result_batch),
            ):
                if not items:
                    continue
                try:
                    await process(items)
                except asyncio.CancelledError:
                    for it in items:
                        if not it.fut.done():
                            it.fut.cancel()
                    raise
                except Exception as e:  # noqa: BLE001 - a batch bug must not wedge the queue
                    logx.error("tick batch failed", err=str(e))
                    for it in items:
                        if not it.fut.done():
                            it.fut.set_exception(e)

    @contextlib.asynccontextmanager
    async def _spanctx(
        self, name: str, trace_id: str, parent_span_id: str, attrs: dict
    ) -> AsyncIterator:
        """Explicit-parent span (no ambient contextvar): the batched path
        runs several jobs' spans interleaved in one task, so parenting must
        not ride the task-local context."""
        sp = self.tracer.begin(
            name, trace_id=trace_id, parent_span_id=parent_span_id, attrs=attrs
        )
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            await self.tracer.finish(sp, status="ERROR")
            raise
        else:
            await self.tracer.finish(sp)

    def _submit_fields(self, req: JobRequest, trace_id: str) -> dict[str, str]:
        return {
            "topic": req.topic,
            "tenant_id": req.tenant_id,
            "principal_id": req.principal_id,
            "context_ptr": req.context_ptr,
            "workflow_id": req.workflow_id,
            "run_id": req.run_id,
            "trace_id": trace_id,
            "priority": req.priority,
            "submitted_at_us": str(time.time_ns() // 1000),
        }

    async def _process_submit_batch(self, batch: list[_SubmitItem]) -> None:
        self.metrics.sched_tick_batch.observe(float(len(batch)))
        # duplicate job ids inside one tick cannot share a grouped create
        # (their watches would collapse); dupes take the per-job path, whose
        # lock + short-circuits already model redelivery
        seen: set[str] = set()
        grouped: list[_SubmitItem] = []
        fallback: list[_SubmitItem] = []
        for it in batch:
            if it.req.job_id in seen:
                fallback.append(it)
            else:
                seen.add(it.req.job_id)
                grouped.append(it)

        # stage 1 — grouped optimistic create: every job assumed fresh
        # (version 0), →PENDING + request blob + trace membership folded
        # into ONE pipe per co-committable key group.  A conflicted group
        # means at least one job already exists → that whole group falls
        # back to the per-job path (which re-reads and short-circuits).
        created: list[_SubmitItem] = []
        kv = self.job_store.kv
        groups: dict[int, list[_SubmitItem]] = {}
        for it in grouped:
            groups.setdefault(kv.pipe_group(meta_key(it.req.job_id)), []).append(it)
        for members in groups.values():
            watches: dict[str, int] = {}
            ops: list[tuple] = []
            overlays: dict[str, dict[str, bytes]] = {}
            for it in members:
                jid = it.req.job_id
                c_ops, overlay, _ = self.job_store.build_chain_ops(
                    jid, MetaSnapshot(),
                    [(JobState.PENDING, self._submit_fields(it.req, it.trace_id),
                      "submit")],
                )
                watches[meta_key(jid)] = 0
                ops.extend(c_ops)
                ops.extend(self.job_store.put_request_ops(it.req))
                ops.extend(self.job_store.add_to_trace_ops(it.trace_id, jid))
                overlays[jid] = overlay
            ok, versions = await kv.pipe_execute(watches, ops)
            if ok:
                for it in members:
                    jid = it.req.job_id
                    it.snap = MetaSnapshot(
                        versions.get(meta_key(jid), 0), dict(overlays[jid])
                    )
                    self.metrics.jobs_received.inc(topic=it.req.topic)
                created.extend(members)
            else:
                fallback.extend(members)

        if fallback:
            self.metrics.sched_tick_fallbacks.inc(amount=float(len(fallback)))
            await eager_gather([self._fallback_submit(it) for it in fallback])
        if not created:
            return

        # stage 2 — per-job config attach + policy check, gathered so the
        # checks overlap; each runs inside its own task, so the policy-check
        # span context stays per-job (remote kernels see correct parents)
        await eager_gather([self._batch_pre(it) for it in created])

        # stage 3 — classify: the grouped tail handles only the plain-ALLOW
        # shape (no constraints, no tenant concurrency gate); everything
        # else continues on the per-job decision tail
        simple: list[_SubmitItem] = []
        complex_: list[_SubmitItem] = []
        for it in created:
            if it.fut.done():
                continue  # pre-stage already failed this item
            resp = it.resp
            gated = bool(self._tenant_limit(it.req) and it.req.tenant_id)
            is_gang = self.gangs is not None and gang_workers(it.req.labels) > 0
            if resp.decision == Decision.ALLOW.value and not gated and not is_gang:
                simple.append(it)
            else:
                complex_.append(it)
        if complex_:
            self.metrics.sched_tick_fallbacks.inc(amount=float(len(complex_)))
            await eager_gather([self._complex_tail(it) for it in complex_])
        if simple:
            await self._batch_dispatch(simple)

    async def _fallback_submit(self, it: _SubmitItem) -> None:
        """Per-job slow path for batch members that aren't fresh creates;
        funnels the outcome (including RetryAfter) into the item's future."""
        try:
            async with self._sem:
                await self.handle_job_request(
                    it.req, trace_id=it.trace_id, parent_span_id=it.parent_span_id,
                    redeliveries=it.redeliveries,
                )
        except BaseException as e:
            if not it.fut.done():
                it.fut.set_exception(e)
        else:
            if not it.fut.done():
                it.fut.set_result(None)

    async def _batch_pre(self, it: _SubmitItem) -> None:
        req = it.req
        it.sched_sp = self.tracer.begin(
            "schedule", trace_id=it.trace_id, parent_span_id=it.parent_span_id,
            attrs={"job_id": req.job_id, "topic": req.topic},
        )
        try:
            cfg_hash = await self._attach_effective_config(req)
            if cfg_hash:
                it.pending["config_hash"] = cfg_hash
            async with self.tracer.span(
                "policy-check", trace_id=it.sched_sp.trace_id,
                parent_span_id=it.sched_sp.span_id, attrs={"job_id": req.job_id},
            ) as polsp:
                it.resp = await self._check_safety(req)
                polsp.attrs["decision"] = it.resp.decision
        except BaseException as e:
            await self._fail_item(it, e)

    async def _complex_tail(self, it: _SubmitItem) -> None:
        """Non-ALLOW / gated decisions: reuse the per-job decision tail."""
        try:
            await self._post_decision(
                it.req, it.resp, snap=it.snap, pending_fields=it.pending,
                trace_id=it.sched_sp.trace_id, parent_span_id=it.sched_sp.span_id,
                redeliveries=it.redeliveries,
            )
        except BaseException as e:
            await self._fail_item(it, e)
        else:
            await self._finish_item(it)

    async def _fail_item(self, it: _SubmitItem, e: BaseException) -> None:
        if it.sched_sp is not None:
            it.sched_sp.attrs.setdefault("error", type(e).__name__)
            await self.tracer.finish(it.sched_sp, status="ERROR")
            it.sched_sp = None
        if not it.fut.done():
            it.fut.set_exception(e)

    async def _finish_item(self, it: _SubmitItem) -> None:
        if it.sched_sp is not None:
            await self.tracer.finish(it.sched_sp)
            it.sched_sp = None
        if not it.fut.done():
            it.fut.set_result(None)

    async def _group_chain(self, items: list, steps_for, extra_for=None) -> None:
        """Commit one transition chain per item, folding co-committable items
        into ONE grouped pipe; a conflicted group degrades to per-job
        ``apply_chain`` (which re-reads and retries).  Per-item failures
        (e.g. a cancel racing the batch → IllegalTransition) fail only that
        item via its future."""
        kv = self.job_store.kv
        groups: dict[int, list] = {}
        for it in items:
            groups.setdefault(kv.pipe_group(meta_key(it.job_id)), []).append(it)
        for members in groups.values():
            watches: dict[str, int] = {}
            ops: list[tuple] = []
            overlays: dict[str, dict[str, bytes]] = {}
            try:
                for it in members:
                    jid = it.job_id
                    c_ops, overlay, _ = self.job_store.build_chain_ops(
                        jid, it.snap, steps_for(it)
                    )
                    if extra_for is not None:
                        c_ops = [*c_ops, *extra_for(it)]
                    watches[meta_key(jid)] = it.snap.version
                    ops.extend(c_ops)
                    overlays[jid] = overlay
                ok, versions = await kv.pipe_execute(watches, ops)
            except BaseException:
                ok = False
            if ok:
                for it in members:
                    jid = it.job_id
                    merged = dict(it.snap.fields)
                    merged.update(overlays[jid])
                    it.snap = MetaSnapshot(versions.get(meta_key(jid), 0), merged)
                continue
            # group lost a race (or a chain build failed): per-job commits
            for it in members:
                try:
                    _, it.snap = await self.job_store.apply_chain(
                        it.job_id, steps_for(it), snap=it.snap,
                        extra_ops=list(extra_for(it)) if extra_for else None,
                    )
                except BaseException as e:
                    await self._fail_item(it, e)

    async def _batch_dispatch(self, items: list[_SubmitItem]) -> None:
        """The grouped plain-ALLOW tail: one selection pass, one grouped
        SCHEDULED commit, overlapped publishes + one grouped
        DISPATCHED→RUNNING commit."""
        # selection: one batched strategy pass (registry snapshot amortized)
        st_spans = [
            self.tracer.begin(
                "strategy", trace_id=it.sched_sp.trace_id,
                parent_span_id=it.sched_sp.span_id,
                attrs={"job_id": it.req.job_id},
            )
            for it in items
        ]
        targets = self.strategy.pick_subjects([it.req for it in items])
        for it, sp, target in zip(items, st_spans, targets):
            it.target = target
            sp.attrs["target"] = target
            await self.tracer.finish(sp)
        for it in items:
            # fresh create → this is attempt 1 (mirrors the per-job tail)
            it.pending["attempts"] = "1"

        def sched_steps(it: _SubmitItem):
            return [(JobState.SCHEDULED,
                     {"dispatch_subject": it.target, **it.pending}, "scheduled")]

        def sched_extra(it: _SubmitItem):
            extra = self.job_store.put_safety_decision_ops(
                self._decision_record(it.req, it.resp)
            )
            if it.req.tenant_id:
                extra += self.job_store.tenant_active_add_ops(
                    it.req.tenant_id, it.req.job_id
                )
            if it.req.budget and it.req.budget.deadline_unix_ms:
                extra += self.job_store.register_deadline_ops(
                    it.req.job_id, it.req.budget.deadline_unix_ms
                )
            return extra

        await self._group_chain(items, sched_steps, sched_extra)
        live = [it for it in items if not it.fut.done()]
        if not live:
            return

        # dispatch: publishes overlap each other AND the grouped
        # DISPATCHED→RUNNING bookkeeping commit (same contract as the
        # per-job path: an undelivered publish leaves the job RUNNING for
        # the replayer's result-replay nudge to recover)
        d_spans = []
        pubs = []
        for it in live:
            dsp = self.tracer.begin(
                "dispatch", trace_id=it.sched_sp.trace_id,
                parent_span_id=it.sched_sp.span_id,
                attrs={"job_id": it.req.job_id, "target": it.target},
            )
            d_spans.append(dsp)
            self._stamp_partition(it.req)
            out = BusPacket.wrap(
                it.req, trace_id=it.trace_id, sender_id=self.instance_id,
                span_id=dsp.span_id, parent_span_id=dsp.parent_span_id,
            )
            pubs.append(self.bus.publish(it.target, out))

        def run_steps(it: _SubmitItem):
            return [(JobState.DISPATCHED, None, "dispatched"),
                    (JobState.RUNNING, None, "running")]

        results = await asyncio.gather(
            self._group_chain(live, run_steps), *pubs, return_exceptions=True
        )
        if isinstance(results[0], BaseException):
            logx.error("batched DISPATCHED/RUNNING commit failed",
                       err=str(results[0]))
        for it, dsp, pub_res in zip(live, d_spans, results[1:]):
            if isinstance(pub_res, BaseException):
                dsp.attrs.setdefault("error", type(pub_res).__name__)
                await self.tracer.finish(dsp, status="ERROR")
                await self._fail_item(it, pub_res)
                continue
            await self.tracer.finish(dsp)
            if it.fut.done():
                continue  # run_steps commit failed this item
            self._cache_snap(it.req.job_id, it.snap)
            self.metrics.jobs_dispatched.inc(topic=it.req.topic)
            self.metrics.shard_scheduled.inc(shard=self._shard_label)
            sub_us = int(it.snap.get("submitted_at_us", "0") or 0)
            if sub_us:
                self.metrics.dispatch_latency.observe(
                    max(0.0, (now_us() - sub_us) / 1e6)
                )
            await self._finish_item(it)

    def _cache_snap(self, job_id: str, snap: MetaSnapshot) -> None:
        """Remember the post-RUNNING snapshot so the result path commits
        read-free; the cache is advisory (a conflict re-reads)."""
        if len(self._snap_cache) > 65536:
            self._snap_cache.clear()
        self._snap_cache[job_id] = snap

    async def _process_result_batch(self, items: list[_ResultItem]) -> None:
        self.metrics.sched_tick_batch.observe(float(len(items)))
        fast: list[_ResultItem] = []
        fallback: list[_ResultItem] = []
        seen: set[str] = set()
        for it in items:
            res = it.res
            snap = self._snap_cache.pop(res.job_id, None)
            try:
                it.state = JobState(res.status)
            except ValueError:
                it.state = JobState.FAILED
            if (
                snap is None or snap.is_terminal
                or it.state not in TERMINAL_STATES
                or res.job_id in seen
            ):
                fallback.append(it)  # no cached snap / hint / dup-in-tick
                continue
            seen.add(res.job_id)
            it.snap = snap
            fast.append(it)
        if fallback:
            await eager_gather([self._fallback_result(it) for it in fallback])
        if not fast:
            return
        for it in fast:
            it.sched_sp = self.tracer.begin(
                "result", trace_id=it.trace_id, parent_span_id=it.parent_span_id,
                attrs={"job_id": it.res.job_id, "status": it.state.value},
            )

        def result_steps(it: _ResultItem):
            return [(it.state, self._result_fields(it.res), "result")]

        await self._group_chain(fast, result_steps)
        for it in fast:
            if it.fut.done():
                # commit failed this item (e.g. a cancel won the race and the
                # re-read raised IllegalTransition — the per-job path raises
                # the same way); its future already carries the error
                continue
            self._stream_tokens.pop(it.res.job_id, None)
            self.metrics.jobs_completed.inc(status=it.state.value)
            klass = it.snap.get("priority", "") or "BATCH"
            self.metrics.jobs_by_class.inc(job_class=klass, status=it.state.value)
            sub_us = int(it.snap.get("submitted_at_us", "0") or 0)
            if sub_us:
                # the job's trace id rides as an exemplar so an e2e bucket
                # spike resolves straight to a stored trace
                self.metrics.e2e_latency.observe(
                    max(0.0, (now_us() - sub_us) / 1e6),
                    exemplar=it.snap.get("trace_id", ""), job_class=klass,
                )
            if it.state in (JobState.FAILED, JobState.TIMEOUT):
                req = await self.job_store.get_request(it.res.job_id)
                if req is not None:
                    await self._emit_dlq(
                        req, it.res.error_message or it.state.value,
                        it.res.error_code or it.state.value, status=it.state.value,
                    )
            await self._finish_item(it)

    async def _fallback_result(self, it: _ResultItem) -> None:
        try:
            async with self._sem:
                await self.handle_job_result(
                    it.res, trace_id=it.trace_id, parent_span_id=it.parent_span_id
                )
        except BaseException as e:
            if not it.fut.done():
                it.fut.set_exception(e)
        else:
            if not it.fut.done():
                it.fut.set_result(None)

    @staticmethod
    def _result_fields(res: JobResult) -> dict[str, str]:
        fields = {
            "result_ptr": res.result_ptr,
            "worker_id": res.worker_id,
            "execution_ms": str(res.execution_ms),
        }
        if res.error_message:
            fields["error_message"] = res.error_message
            fields["error_code"] = res.error_code
        return fields

    async def handle_job_request(
        self, req: JobRequest, *, trace_id: str = "", parent_span_id: str = "",
        redeliveries: int = 0,
    ) -> None:
        if not await self.job_store.acquire_job_lock(req.job_id, self.instance_id, ttl_s=30.0):
            raise RetryAfter(0.05, f"job {req.job_id} locked")
        try:
            submit_fields = self._submit_fields(req, trace_id)
            create_extra = self.job_store.put_request_ops(req)
            create_extra += self.job_store.add_to_trace_ops(trace_id, req.job_id)
            # Optimistic fresh-job fast path: assume job:meta does not exist
            # yet (version 0) and fold →PENDING + the request blob + trace
            # membership into ONE pipelined commit — zero read round trips
            # for the common case.  A conflict means the job already exists:
            # apply_chain hands back a fresh snapshot to short-circuit on.
            changed, snap = await self.job_store.apply_chain(
                req.job_id,
                [(JobState.PENDING, submit_fields, "submit")],
                snap=MetaSnapshot(), extra_ops=create_extra, max_retries=1,
            )
            if changed is None:
                st = snap.state
                if snap.is_terminal:
                    return  # idempotency short-circuit under redelivery
                self.metrics.jobs_received.inc(topic=req.topic)
                if st in _INFLIGHT_STATES:
                    # In-flight short-circuit: a redelivered submit for a job
                    # already dispatched must not re-run the safety check,
                    # burn an attempt, or attempt an illegal →SCHEDULED
                    # transition (enough duplicates could otherwise DLQ a job
                    # that is still running).
                    return
                if st == JobState.APPROVAL_REQUIRED.value:
                    # Parked jobs only move via a valid approval: the
                    # republish must carry the approval label AND hash-match
                    # the stored decision record; anything else must not
                    # clobber the parked request/record (attempted approval
                    # bypass otherwise).
                    stored = await self.job_store.get_safety_decision(req.job_id)
                    granted = (req.labels or {}).get(LABEL_APPROVAL_GRANTED) == "true"
                    if not (granted and stored and stored.job_hash == job_hash(req)):
                        logx.warn(
                            "ignoring republish of parked job without valid approval",
                            job_id=req.job_id,
                        )
                        return
                    await self.job_store.put_request(req)
                elif not st:
                    # rare: meta expired between the failed create and the
                    # re-read — walk the normal validated create with retries
                    changed, snap = await self.job_store.apply_chain(
                        req.job_id,
                        [(JobState.PENDING, submit_fields, "submit")],
                        snap=snap, extra_ops=create_extra,
                    )
                else:
                    # PENDING redelivery: refresh the persisted request blob
                    # only (the original submit fields stay authoritative)
                    await self.job_store.put_request(req)
            else:
                self.metrics.jobs_received.inc(topic=req.topic)
            # schedule span: covers safety gate + strategy + dispatch; a
            # RetryAfter (throttle / tenant limit) surfaces as an ERROR span
            # with the exception type, then still drives redelivery
            async with self.tracer.span(
                "schedule",
                trace_id=trace_id,
                parent_span_id=parent_span_id,
                attrs={"job_id": req.job_id, "topic": req.topic},
            ):
                await self.process_job(req, trace_id=trace_id, snap=snap,
                                       redeliveries=redeliveries)
        finally:
            await self.job_store.release_job_lock(req.job_id, self.instance_id)

    # ------------------------------------------------------------------
    async def process_job(
        self, req: JobRequest, *, trace_id: str = "",
        snap: Optional[MetaSnapshot] = None, redeliveries: int = 0,
    ) -> None:
        if snap is None:
            snap = await self.job_store.watch_meta(req.job_id)
        # fields produced along the way (config hash, attempts) ride the next
        # state-transition commit instead of costing their own round trips
        pending_fields: dict[str, str] = {}
        cfg_hash = await self._attach_effective_config(req)
        if cfg_hash:
            pending_fields["config_hash"] = cfg_hash

        async with self.tracer.span(
            "policy-check", attrs={"job_id": req.job_id}
        ) as polsp:
            resp = await self._check_safety(req)
            polsp.attrs["decision"] = resp.decision
        # nested spans in the shared tail take explicit parents (the batched
        # path has no per-job ambient context); here the ambient context IS
        # the enclosing schedule span, so behavior is unchanged
        ptrace, pspan = current_trace_context()
        await self._post_decision(
            req, resp, snap=snap, pending_fields=pending_fields,
            trace_id=trace_id or ptrace, parent_span_id=pspan,
            redeliveries=redeliveries,
        )

    def _tenant_limit(self, req: JobRequest) -> int:
        """Per-tenant concurrency limit: org-scoped effective config
        (rate_limits.concurrent_jobs), else the global default."""
        limit = self.tenant_concurrency_limit
        eff_raw = (req.env or {}).get(ENV_EFFECTIVE_CONFIG)
        if eff_raw and req.tenant_id:
            eff = codec.loads_env_json(eff_raw)
            if isinstance(eff, dict):
                try:
                    rate = eff.get("rate_limits") or {}
                    limit = int(rate.get("concurrent_jobs", limit) or limit)
                except (ValueError, TypeError, AttributeError):
                    pass
        return limit

    async def _post_decision(
        self, req: JobRequest, resp, *,
        snap: MetaSnapshot, pending_fields: dict[str, str],
        trace_id: str = "", parent_span_id: str = "",
        redeliveries: int = 0,
    ) -> None:
        """Everything after the safety check: decision branches, tenant
        gate, deadline, attempts guard, strategy pick, dispatch.  Shared by
        the per-job path and the batched tick path's non-simple items."""
        decision = resp.decision
        decision_ops = self.job_store.put_safety_decision_ops(
            self._decision_record(req, resp)
        )

        if decision == Decision.DENY.value:
            self.metrics.jobs_denied.inc(topic=req.topic)
            await self.job_store.apply_chain(
                req.job_id,
                [(JobState.DENIED,
                  {"deny_reason": resp.reason, **pending_fields}, "safety_deny")],
                snap=snap, extra_ops=decision_ops,
            )
            await self._emit_dlq(req, resp.reason, "SAFETY_DENY", status=JobState.DENIED.value)
            return

        if decision == Decision.REQUIRE_APPROVAL.value:
            await self.job_store.apply_chain(
                req.job_id,
                [(JobState.APPROVAL_REQUIRED,
                  {"approval_reason": resp.reason,
                   "policy_snapshot": resp.policy_snapshot, **pending_fields},
                  "approval_required")],
                snap=snap, extra_ops=decision_ops,
            )
            return  # parked until an admin approves

        if decision == Decision.THROTTLE.value:
            delay = resp.throttle_delay_s or 1.0
            raise RetryAfter(delay, f"throttled: {resp.reason}")

        # The decision record carries the hash of the request *as
        # approved/checked*, before constraint injection mutates env
        # (otherwise the stored hash would never match a faithful
        # republish); the write itself rides the SCHEDULED commit.
        extra_ops = list(decision_ops)
        if decision == Decision.ALLOW_WITH_CONSTRAINTS.value and resp.constraints:
            self._apply_constraints(req, resp.constraints)

        limit = self._tenant_limit(req)
        if limit and req.tenant_id:
            active = await self.job_store.tenant_active_count(req.tenant_id)
            if active >= limit:
                # exponential NAK backoff with ±25% jitter per redelivery:
                # a tenant burst spreads out instead of resonating as a
                # synchronized retry storm (capped by MAX_NAK_DELAY_S)
                delay = min(MAX_NAK_DELAY_S,
                            TENANT_NAK_BASE_S * (2 ** max(0, redeliveries)))
                delay *= 1.0 + random.uniform(-0.25, 0.25)
                raise RetryAfter(
                    delay, f"tenant {req.tenant_id} at concurrency limit {limit}"
                )
        if req.tenant_id:
            extra_ops += self.job_store.tenant_active_add_ops(req.tenant_id, req.job_id)

        # deadline registration
        if req.budget and req.budget.deadline_unix_ms:
            extra_ops += self.job_store.register_deadline_ops(
                req.job_id, req.budget.deadline_unix_ms
            )

        # gang jobs depart here (docs/GANG.md): the gang scheduler owns
        # reservation, fan-out dispatch, and attempts accounting — a queued
        # gang leaves the job PENDING so the replayer keeps it alive
        if self.gangs is not None and gang_workers(req.labels) > 0:
            await self.gangs.on_submit(
                req, extra_ops=extra_ops, pending_fields=pending_fields,
                trace_id=trace_id, parent_span_id=parent_span_id,
            )
            return

        # dispatch-attempts guard: counted only for real dispatch attempts so
        # backpressure redeliveries (throttle / tenant concurrency) don't burn
        # the budget of a job that merely waited
        attempts = int(snap.get("attempts", "0") or "0") + 1
        pending_fields["attempts"] = str(attempts)
        if attempts > self.max_attempts:
            await self._fail_to_dlq(
                req, "max attempts exceeded", "MAX_RETRIES",
                fields=pending_fields, snap=snap,
            )
            return

        # pick subject and dispatch
        async with self._spanctx(
            "strategy", trace_id, parent_span_id, {"job_id": req.job_id}
        ) as stsp:
            target = self.strategy.pick_subject(req)
            stsp.attrs["target"] = target
        async with self._spanctx(
            "dispatch", trace_id, parent_span_id,
            {"job_id": req.job_id, "target": target},
        ) as dsp:
            # ONE pipelined commit: →SCHEDULED + decision record + tenant
            # membership + deadline + attempts/config fields (was 6-9
            # round trips of separate writes)
            _, snap = await self.job_store.apply_chain(
                req.job_id,
                [(JobState.SCHEDULED,
                  {"dispatch_subject": target, **pending_fields}, "scheduled")],
                snap=snap, extra_ops=extra_ops,
            )
            self._stamp_partition(req)
            out = BusPacket.wrap(
                req, trace_id=trace_id, sender_id=self.instance_id,
                span_id=dsp.span_id, parent_span_id=dsp.parent_span_id,
            )
            # Overlap the load-bearing dispatch publish with the
            # non-load-bearing DISPATCHED→RUNNING bookkeeping commit (one
            # pipelined chain).  If the publish fails the chain may still
            # land, leaving the job RUNNING-but-undelivered; the replayer's
            # result-replay nudge recovers it, and the publish error still
            # propagates for bus-level redelivery.
            results = await asyncio.gather(
                self.bus.publish(target, out),
                self.job_store.apply_chain(
                    req.job_id,
                    [(JobState.DISPATCHED, None, "dispatched"),
                     (JobState.RUNNING, None, "running")],
                    snap=snap,
                ),
                return_exceptions=True,
            )
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            self._cache_snap(req.job_id, results[1][1])
        self.metrics.jobs_dispatched.inc(topic=req.topic)
        self.metrics.shard_scheduled.inc(shard=self._shard_label)
        sub_us = int(snap.get("submitted_at_us", "0") or 0)
        if sub_us:
            self.metrics.dispatch_latency.observe(max(0.0, (now_us() - sub_us) / 1e6))

    def _stamp_partition(self, req: JobRequest) -> None:
        """Stamp this shard's partition on the outbound request so the
        worker can publish the result straight to ``sys.job.result.<p>``
        (skipping the unstamped-result forwarding hop).  Rebound to
        :meth:`_stamp_noop` at construction when ``shard_count == 1``."""
        req.labels = dict(req.labels or {})
        req.labels[LABEL_PARTITION] = self._shard_label

    @staticmethod
    def _stamp_noop(req: JobRequest) -> None:
        return None

    # ------------------------------------------------------------------
    async def redispatch_scheduled(self, job_id: str) -> bool:
        """Re-publish a job wedged in SCHEDULED (crash/bus blip between
        set_state(SCHEDULED) and the dispatch publish).  Safety was already
        checked on the original pass; this only repeats the dispatch leg —
        with the attempts guard, so a persistently failing publish still
        lands in the DLQ instead of looping forever.  Driven by the
        PendingReplayer; returns True if the job moved."""
        if not await self.job_store.acquire_job_lock(job_id, self.instance_id, ttl_s=30.0):
            return False
        try:
            snap = await self.job_store.watch_meta(job_id)
            if snap.state != JobState.SCHEDULED.value:
                return False  # moved on concurrently
            req = await self.job_store.get_request(job_id)
            if req is None:
                return False
            attempts = int(snap.get("attempts", "0") or "0") + 1
            if attempts > self.max_attempts:
                await self._fail_to_dlq(
                    req, "max attempts exceeded", "MAX_RETRIES",
                    fields={"attempts": str(attempts)}, snap=snap,
                )
                return True
            target = self.strategy.pick_subject(req)
            # attempts must land BEFORE the publish: a persistently failing
            # publish still burns its budget and reaches the DLQ instead of
            # looping forever (idempotent fields-only commit keeps the
            # snapshot current for the chain below)
            _, snap = await self.job_store.apply_chain(
                job_id,
                [(JobState.SCHEDULED, {"attempts": str(attempts)}, "")],
                snap=snap,
            )
            # fresh bus msg-id label: the redispatch must survive the dedupe
            # window even if the original publish reached the bus
            req.labels = dict(req.labels or {})
            req.labels["cordum.bus_msg_id"] = f"redispatch-{job_id}-{attempts}"
            self._stamp_partition(req)
            out = BusPacket.wrap(req, trace_id=snap.get("trace_id", ""),
                                 sender_id=self.instance_id)
            await self.bus.publish(target, out)
            await self.job_store.apply_chain(
                job_id,
                [(JobState.DISPATCHED,
                  {"dispatch_subject": target}, "redispatched"),
                 (JobState.RUNNING, None, "running")],
                snap=snap,
            )
            self.metrics.jobs_dispatched.inc(topic=req.topic)
            return True
        finally:
            await self.job_store.release_job_lock(job_id, self.instance_id)

    async def nudge_inflight(self, job_id: str) -> bool:
        """Re-deliver a job wedged in DISPATCHED/RUNNING to its recorded
        dispatch subject.  The worker side is idempotent — an in-flight
        redelivery is dropped, a completed job republishes its cached
        result — so this acts as a result-replay request: it recovers jobs
        whose dispatch packet or terminal result was lost to a statebus
        failover window (pub/sub pushes are not replicated), without
        re-running work or transitioning state.  Driven by the
        PendingReplayer past ``Timeouts.result_replay_s``."""
        snap = await self.job_store.watch_meta(job_id)
        if snap.state not in (JobState.DISPATCHED.value, JobState.RUNNING.value):
            return False
        req = await self.job_store.get_request(job_id)
        if req is None:
            return False
        target = snap.get("dispatch_subject", "") or self.strategy.pick_subject(req)
        # fresh bus msg-id: the redelivery must survive the dedupe window
        req.labels = dict(req.labels or {})
        req.labels["cordum.bus_msg_id"] = f"nudge-{job_id}-{now_us()}"
        self._stamp_partition(req)
        await self.bus.publish(
            target,
            BusPacket.wrap(req, trace_id=snap.get("trace_id", ""),
                           sender_id=self.instance_id),
        )
        self.metrics.inflight_nudges.inc()
        return True

    async def failover_job(
        self, job_id: str, *, reason: str = "worker_dead",
        count_attempt: bool = True,
    ) -> bool:
        """Re-dispatch an in-flight job to a NEW worker after its old one
        died or handed it back (``SESSION_REQUEUE``) — the serving-session
        crash-failover leg (docs/SERVING.md §Migration, drain, and
        failover).  Differences from :meth:`nudge_inflight`: the strategy
        picks a FRESH target (the dead worker's affinity entries are
        evicted first), the attempt counts against the job's budget (past
        the cap it fails to the DLQ), and any tokens the dead worker
        already streamed ride along as the forced-decode resume prefix so
        the client's stream resumes with no duplicated or missing tokens.
        State stays DISPATCHED/RUNNING throughout — legal, since the job
        really is still in flight."""
        if not await self.job_store.acquire_job_lock(job_id, self.instance_id, ttl_s=30.0):
            return False
        try:
            snap = await self.job_store.watch_meta(job_id)
            if snap.state not in (JobState.DISPATCHED.value, JobState.RUNNING.value):
                return False  # finished (or was cancelled) concurrently
            req = await self.job_store.get_request(job_id)
            if req is None:
                return False
            # preemption re-dispatches are attempts-exempt: yielding to
            # interactive pressure is the control plane's choice, not the
            # job's failure, so it must never burn the job toward the DLQ
            attempts = int(snap.get("attempts", "0") or "0") + (
                1 if count_attempt else 0
            )
            if attempts > self.max_attempts:
                self._stream_tokens.pop(job_id, None)
                await self._fail_to_dlq(
                    req, f"failover attempts exhausted ({reason})",
                    "MAX_RETRIES", fields={"attempts": str(attempts)},
                    snap=snap,
                )
                return True
            req.labels = dict(req.labels or {})
            streamed = self._stream_tokens.get(job_id)
            if streamed:
                # the forced-decode prefix: the new worker prefills
                # prompt + prefix, replays it at offset 0 (consumers
                # dedupe), and generates only the remainder.  NOT persisted
                # onto the stored request — the prefix is routing state,
                # and mutating the blob would break approval hash checks.
                req.labels[LABEL_RESUME_TOKENS] = ",".join(
                    str(t) for t in streamed
                )
            target = self.strategy.pick_subject(req)
            # attempts + the new dispatch subject land BEFORE the publish
            # (idempotent same-state fields commit), so a crash loop still
            # burns its budget and the replayer nudges the right worker
            _, snap = await self.job_store.apply_chain(
                job_id,
                [(JobState(snap.state),
                  {"attempts": str(attempts), "dispatch_subject": target},
                  "")],
                snap=snap,
            )
            req.labels["cordum.bus_msg_id"] = f"failover-{job_id}-{attempts}"
            self._stamp_partition(req)
            await self.bus.publish(
                target,
                BusPacket.wrap(req, trace_id=snap.get("trace_id", ""),
                               sender_id=self.instance_id),
            )
            await self.job_store.append_event(
                job_id, "failover", reason=reason, target=target,
                attempts=attempts, resumed_tokens=len(streamed or ()),
            )
            self.metrics.session_failovers.inc(reason=reason)
            self.metrics.jobs_dispatched.inc(topic=req.topic)
            logx.info("job failed over", job_id=job_id, reason=reason,
                      target=target, attempts=attempts,
                      resumed_tokens=len(streamed or ()))
            return True
        finally:
            await self.job_store.release_job_lock(job_id, self.instance_id)

    # ------------------------------------------------------------------
    async def _check_safety(self, req: JobRequest):
        """Approval-granted fast path with hash binding, else kernel check."""
        from ...protocol.types import PolicyCheckResponse

        labels = req.labels or {}
        if labels.get(LABEL_APPROVAL_GRANTED) == "true":
            stored = await self.job_store.get_safety_decision(req.job_id)
            if stored is not None and stored.job_hash and stored.job_hash == job_hash(req):
                constraints = (
                    Constraints.from_dict(stored.constraints) if stored.constraints else None
                )
                return PolicyCheckResponse(
                    decision=(
                        Decision.ALLOW_WITH_CONSTRAINTS.value
                        if constraints
                        else Decision.ALLOW.value
                    ),
                    reason="approval granted (hash verified)",
                    policy_snapshot=stored.policy_snapshot,
                    constraints=constraints,
                )
            # hash mismatch: the job content changed since approval → re-check
            logx.warn("approval hash mismatch; re-checking", job_id=req.job_id)

        check = PolicyCheckRequest(
            job_id=req.job_id,
            tenant_id=req.tenant_id,
            principal_id=req.principal_id,
            topic=req.topic,
            labels=dict(labels),
            metadata=req.metadata,
            actor_id=req.principal_id,
        )
        eff = (req.env or {}).get(ENV_EFFECTIVE_CONFIG)
        if eff:
            parsed = codec.loads_env_json(eff)
            if isinstance(parsed, dict):
                check.effective_config = parsed
        self.metrics.policy_evals.inc()
        return await self.safety.check(check)

    def _decision_record(self, req: JobRequest, resp) -> SafetyDecisionRecord:
        return SafetyDecisionRecord(
            job_id=req.job_id,
            decision=resp.decision,
            reason=resp.reason,
            rule_id=resp.rule_id,
            policy_snapshot=resp.policy_snapshot,
            job_hash=job_hash(req),
            constraints=resp.constraints.to_dict() if resp.constraints else None,
            remediations=[r.to_dict() for r in resp.remediations],
        )

    def _apply_constraints(self, req: JobRequest, c: Constraints) -> None:
        req.env = dict(req.env or {})
        # the env contract stays JSON (non-Python workers parse it); the
        # codec module owns contract-JSON under CL007
        req.env[ENV_POLICY_CONSTRAINTS] = codec.dumps_env_json(
            c.to_dict(), sort_keys=True
        )
        if c.max_chips:
            req.env[ENV_MAX_CHIPS] = str(c.max_chips)
        for k, v in (c.env or {}).items():
            req.env[k] = v
        if c.max_tokens and req.budget is not None and (
            req.budget.max_tokens == 0 or req.budget.max_tokens > c.max_tokens
        ):
            req.budget.max_tokens = c.max_tokens
        if c.max_cost_usd and req.budget is not None and (
            req.budget.max_cost_usd == 0 or req.budget.max_cost_usd > c.max_cost_usd
        ):
            req.budget.max_cost_usd = c.max_cost_usd

    async def _attach_effective_config(self, req: JobRequest) -> str:
        """Injects the effective config into the request env and returns its
        hash; the caller folds the ``config_hash`` meta field into the next
        state-transition commit (no separate write round trip)."""
        if self.configsvc is None:
            return ""
        snap = await self.configsvc.effective_snapshot(
            org=req.tenant_id, workflow=req.workflow_id
        )
        req.env = dict(req.env or {})
        req.env[ENV_EFFECTIVE_CONFIG] = snap["config"]
        return str(snap["hash"])

    # ------------------------------------------------------------------
    async def _on_result(self, subject: str, pkt: BusPacket) -> None:
        res = pkt.job_result
        if res is None or not res.job_id:
            return
        if not self.owns(res.job_id):
            await self._forward_to_owner("result", res.job_id, subj.result_subject, pkt)
            return
        if self.batch_ticks and self._drain_task is not None:
            fut: asyncio.Future[None] = asyncio.get_running_loop().create_future()
            self._result_q.append(_ResultItem(res, pkt.trace_id, pkt.span_id, fut))
            self._submit_wake.set()
            await fut
            return
        async with self._sem:
            await self.handle_job_result(
                res, trace_id=pkt.trace_id, parent_span_id=pkt.span_id
            )

    async def handle_job_result(
        self, res: JobResult, *, trace_id: str = "", parent_span_id: str = ""
    ) -> None:
        # one snapshot read serves the terminal short-circuit, the
        # transition's optimistic first attempt, AND the e2e-latency meta
        snap = await self.job_store.watch_meta(res.job_id)
        if snap.state and snap.is_terminal:
            return  # already terminal: redelivery no-op
        try:
            state = JobState(res.status)
        except ValueError:
            state = JobState.FAILED
        if state not in TERMINAL_STATES:
            if res.error_code == ERROR_SESSION_REQUEUE:
                if res.error_message.startswith(PREEMPTED_REASON):
                    # preemption: the worker yielded the job to interactive
                    # pressure — count it, hold it off briefly, then
                    # re-dispatch attempts-exempt (never FAILED/CANCELLED)
                    self.metrics.preemptions.inc(reason="requeued")
                    self._schedule_preempt_redispatch(res.job_id)
                    return
                # a worker handed the job back (drain without a migration
                # target, crashed decode loop): re-dispatch it instead of
                # recording anything terminal — bounded by the attempts cap
                await self.failover_job(res.job_id, reason="requeue_requested")
                return
            # workers may send RUNNING status hints; record as event only
            await self.job_store.append_event(res.job_id, "result_hint", status=res.status)
            return
        async with self.tracer.span(
            "result",
            trace_id=trace_id,
            parent_span_id=parent_span_id,
            attrs={"job_id": res.job_id, "status": state.value},
        ):
            await self._apply_terminal_result(res, state, snap)

    async def _apply_terminal_result(
        self, res: JobResult, state: JobState, snap: Optional[MetaSnapshot] = None
    ) -> None:
        fields = {
            "result_ptr": res.result_ptr,
            "worker_id": res.worker_id,
            "execution_ms": str(res.execution_ms),
        }
        if res.error_message:
            fields["error_message"] = res.error_message
            fields["error_code"] = res.error_code
        # one pipelined commit: terminal transition + result fields + event
        # (+ deadline clear + tenant-active removal, folded in by the
        # transition builder for terminal states)
        _, snap = await self.job_store.apply_chain(
            res.job_id, [(state, fields, "result")], snap=snap
        )
        self._stream_tokens.pop(res.job_id, None)
        self.metrics.jobs_completed.inc(status=state.value)
        # SLO class = the persisted submit-time priority (obs/slo.py reads
        # the class-labeled series fleet-wide)
        klass = snap.get("priority", "") or "BATCH"
        self.metrics.jobs_by_class.inc(job_class=klass, status=state.value)
        sub_us = int(snap.get("submitted_at_us", "0") or 0)
        if sub_us:
            self.metrics.e2e_latency.observe(
                max(0.0, (now_us() - sub_us) / 1e6),
                exemplar=snap.get("trace_id", ""), job_class=klass,
            )
        if state in (JobState.FAILED, JobState.TIMEOUT):
            req = await self.job_store.get_request(res.job_id)
            if req is not None:
                await self._emit_dlq(
                    req,
                    res.error_message or state.value,
                    res.error_code or state.value,
                    status=state.value,
                )

    # ------------------------------------------------------------------
    async def _fail_to_dlq(
        self, req: JobRequest, reason: str, code: str, *,
        fields: Optional[dict[str, str]] = None,
        snap: Optional[MetaSnapshot] = None,
    ) -> None:
        try:
            f = {"error_message": reason, **(fields or {})}
            await self.job_store.set_state(
                req.job_id, JobState.FAILED, fields=f, event="dlq", snap=snap
            )
        except Exception as e:  # noqa: BLE001 - job may already be terminal
            logx.warn("could not mark job FAILED before DLQ", job_id=req.job_id, err=str(e))
        await self._emit_dlq(req, reason, code, status=JobState.FAILED.value)

    async def _emit_dlq(self, req: JobRequest, reason: str, code: str, *, status: str) -> None:
        self.metrics.jobs_dlq.inc(topic=req.topic)
        res = JobResult(
            job_id=req.job_id,
            status=status,
            error_code=code,
            error_message=reason,
            labels={"topic": req.topic, "tenant_id": req.tenant_id},
        )
        await self.bus.publish(subj.DLQ, BusPacket.wrap(res, sender_id=self.instance_id))
