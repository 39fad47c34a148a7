"""Gang scheduling: mesh-aware all-or-nothing placement for multi-chip
SPMD/MPMD jobs (docs/GANG.md, ROADMAP item 4).

Two pieces live here:

* :class:`DeviceLedger` — the scheduler-side chip/slice inventory.  It
  reads per-worker device telemetry straight from heartbeats (chip count,
  topology, device kind, pool — the keys ``config/pools.yaml`` declares)
  and performs **all-or-nothing reservation** of N co-located workers for
  a gang: either every member is reserved in one synchronous pass or
  nothing is touched — the PageAllocator's worst-case-admission pattern
  lifted from KV pages to devices.  Exhaustion parks the gang in a FIFO
  (no queue-jumping), so concurrent gangs queue instead of deadlocking
  half-reserved.

* :class:`GangScheduler` — the gang lifecycle driver next to the engine.
  A submit carrying ``cordum.gang_workers`` departs the single-worker
  dispatch path: the gang scheduler reserves members, fans the request out
  to each member's direct subject with rank/size/member labels, and
  listens on the gang's ``sys.job.gang.<gang_id>`` subject for rendezvous
  beacons, per-member completion reports (aggregated into ONE terminal
  job result), and aborts.  Failure semantics are first-class: any member
  failing, crashing (heartbeat expiry), or timing out at the rendezvous
  aborts the WHOLE gang — peers see the ``GangMsg(kind="abort")`` fan-out,
  every reserved device is released, and the job requeues attempts-bounded
  through the same FIFO.  A ``JobPreempt`` for a BATCH gang (the
  preemption governor) aborts-and-requeues the gang **as a unit**,
  attempts-exempt, after the standard jittered hold-off.
"""
from __future__ import annotations

import asyncio
import contextlib
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from ...infra import logging as logx
from ...infra.config import Pool, PoolConfig
from ...infra.memstore import MemoryStore
from ...protocol import subjects as subj
from ...protocol.partition import partition_of
from ...protocol.types import (
    BusPacket,
    GangMsg,
    JobRequest,
    JobResult,
    JobState,
    LABEL_GANG_CHIPS,
    LABEL_GANG_ID,
    LABEL_GANG_MEMBERS,
    LABEL_GANG_RANK,
    LABEL_GANG_SIZE,
    TERMINAL_STATES,
    gang_chips,
    gang_kind,
    gang_workers,
)
from ...utils.ids import new_id, now_us
from .strategy import worker_satisfies

# default worker-side barrier timeout; the scheduler watchdog backstops at
# 2x so the member-side abort (which names the missing rank) usually wins
DEFAULT_RENDEZVOUS_TIMEOUT_S = 10.0
WATCH_INTERVAL_S = 0.25
# jittered hold-off before a preempted gang re-enters the FIFO (mirrors the
# engine's single-job PREEMPT_HOLDOFF_S)
PREEMPT_HOLDOFF_S = 1.0
RECENT_GANGS_KEPT = 32

GANG_QUEUED = "QUEUED"
GANG_RUNNING = "RUNNING"
GANG_DONE = "DONE"
GANG_ABORTED = "ABORTED"
GANG_FAILED = "FAILED"


def slice_key(hb) -> str:
    """The co-location group a worker belongs to: an explicit
    ``cordum.slice_id`` label when the deployment pins slices, else the
    (pool, region) pair — workers on one slice share ICI and can run one
    mesh."""
    explicit = (hb.labels or {}).get("cordum.slice_id", "")
    if explicit:
        return explicit
    return f"{hb.pool}|{hb.region}"


class DeviceLedger:
    """Per-worker device inventory + all-or-nothing gang reservations.

    Event-loop-confined (no internal locking): ``try_reserve`` finds the
    full member set *before* mutating any state, so a failed reservation
    touches nothing — the invariant :meth:`verify` (and the property test)
    asserts is that no gang ever holds a partial member set.
    """

    def __init__(self, registry, *, metrics=None) -> None:
        self.registry = registry
        self.metrics = metrics
        # worker_id -> gang_id holding it
        self._reserved: dict[str, str] = {}
        # gang_id -> (members, n_requested)
        self._gangs: dict[str, tuple[list[str], int]] = {}

    # ------------------------------------------------------------------
    @property
    def reserved_workers(self) -> dict[str, str]:
        return dict(self._reserved)

    def gang_members(self, gang_id: str) -> list[str]:
        ent = self._gangs.get(gang_id)
        return list(ent[0]) if ent else []

    def eligible_workers(
        self,
        *,
        pools: list[Pool],
        job_requires: list[str],
        chips: int = 0,
        exclude: tuple = (),
        include_reserved: bool = False,
    ) -> dict[str, list]:
        """Live candidate workers grouped by slice key.  A worker is a
        candidate when it serves one of the topic's pools, satisfies the
        pool's slice requirements AND the job's own ``requires``, owns at
        least ``chips`` chips, is healthy/not draining, and is not already
        reserved by another gang (``include_reserved=True`` ignores current
        reservations — the satisfiability probe: could this gang EVER fit
        on the live fleet?)."""
        groups: dict[str, list] = {}
        for hb in self.registry.snapshot().values():
            if hb.worker_id in exclude:
                continue
            if not include_reserved and hb.worker_id in self._reserved:
                continue
            if hb.draining or not hb.devices_healthy:
                continue
            pool = next((p for p in pools if p.name == hb.pool), None)
            if pools and pool is None:
                continue
            if not worker_satisfies(hb, pool, job_requires):
                continue
            if chips and hb.chip_count < chips:
                continue
            groups.setdefault(slice_key(hb), []).append(hb)
        return groups

    def try_reserve(
        self,
        gang_id: str,
        n_workers: int,
        *,
        pools: list[Pool],
        job_requires: list[str],
        chips: int = 0,
        exclude: tuple = (),
    ) -> Optional[list[str]]:
        """Reserve ``n_workers`` co-located workers for ``gang_id`` — all
        in one pass or none at all.  Returns the member list in rank order
        (least-loaded first) or None when no slice group can cover the
        gang."""
        if gang_id in self._gangs:
            return self.gang_members(gang_id)  # idempotent re-reserve
        groups = self.eligible_workers(
            pools=pools, job_requires=job_requires, chips=chips, exclude=exclude
        )
        best: Optional[list] = None
        for members in groups.values():
            if len(members) < n_workers:
                continue
            # best fit: the group with the least slack keeps big slices
            # free for bigger gangs; ties by name for determinism
            if best is None or len(members) < len(best):
                best = members
        if best is None:
            return None
        best.sort(key=lambda hb: (hb.active_jobs, hb.worker_id))
        chosen = [hb.worker_id for hb in best[:n_workers]]
        # the mutation happens only here, after the full set is known —
        # all-or-nothing by construction
        for wid in chosen:
            self._reserved[wid] = gang_id
        self._gangs[gang_id] = (chosen, n_workers)
        self._gauge()
        return chosen

    def release(self, gang_id: str) -> int:
        """Return every worker reserved by ``gang_id``; 0 for unknown gangs
        (release and abort can race benignly, like the page allocator)."""
        ent = self._gangs.pop(gang_id, None)
        if ent is None:
            return 0
        n = 0
        for wid in ent[0]:
            if self._reserved.get(wid) == gang_id:
                del self._reserved[wid]
                n += 1
        self._gauge()
        return n

    def verify(self) -> int:
        """Invariant check: every held gang owns exactly its full member
        set and every reservation back-links to its gang.  Returns the
        number of violations (MUST be 0) and counts them in
        ``cordum_gang_partial_reservations_total``."""
        bad = 0
        for gid, (members, n) in self._gangs.items():
            held = [w for w in members if self._reserved.get(w) == gid]
            if len(held) != n or len(members) != n:
                bad += 1
        for wid, gid in self._reserved.items():
            if wid not in (self._gangs.get(gid) or ((), 0))[0]:
                bad += 1
        if bad and self.metrics is not None:
            self.metrics.gang_partial_reservations.inc(amount=float(bad))
        return bad

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gang_reserved_workers.set(float(len(self._reserved)))


@dataclass
class GangRecord:
    """One gang attempt (a requeue creates a fresh record, same job)."""

    gang_id: str
    job_id: str
    req: JobRequest
    trace_id: str = ""
    parent_span_id: str = ""
    n_workers: int = 1
    chips: int = 0
    kind: str = ""  # "" = training/SPMD default; "serving" = TP serving gang
    state: str = GANG_QUEUED
    members: list[str] = field(default_factory=list)
    ready: set = field(default_factory=set)
    done: dict[int, dict] = field(default_factory=dict)
    exclude: set = field(default_factory=set)
    count_attempt: bool = True
    created_at: float = field(default_factory=time.monotonic)
    dispatched_at: float = 0.0
    extra_ops: list = field(default_factory=list)
    pending_fields: dict[str, str] = field(default_factory=dict)
    reserve_span: Any = None
    abort_reason: str = ""

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.created_at


class GangScheduler:
    """Drives gang jobs end-to-end next to the engine (docs/GANG.md):
    reserve → fan-out dispatch → collect rendezvous/done/abort → one
    terminal job result, with abort + attempts-bounded requeue on any
    member failure and unit-preemption under interactive pressure."""

    def __init__(
        self,
        engine,
        pool_config: PoolConfig,
        *,
        rendezvous_timeout_s: float = DEFAULT_RENDEZVOUS_TIMEOUT_S,
        watch_interval_s: float = WATCH_INTERVAL_S,
        queued_timeout_s: float = 300.0,
    ) -> None:
        self.engine = engine
        self.bus = engine.bus
        self.job_store = engine.job_store
        self.registry = engine.registry
        self.metrics = engine.metrics
        self.tracer = engine.tracer
        self.pool_config = pool_config
        self.rendezvous_timeout_s = rendezvous_timeout_s
        self.watch_interval_s = watch_interval_s
        self.queued_timeout_s = queued_timeout_s
        self.ledger = DeviceLedger(engine.registry, metrics=engine.metrics)
        self._mem = MemoryStore(engine.job_store.kv)
        self._fifo: deque[GangRecord] = deque()
        self._by_job: dict[str, GangRecord] = {}
        self._by_gang: dict[str, GangRecord] = {}
        self._recent: deque[GangRecord] = deque(maxlen=RECENT_GANGS_KEPT)
        self._holdoffs: set[asyncio.Task] = set()
        self._watch_task: Optional[asyncio.Task] = None
        self._subs: list = []
        # _pump single-flight: the watchdog, releases, and submits all
        # pump; overlapping passes could otherwise re-dispatch the same
        # head record around an await
        self._pumping = False
        self._pump_again = False
        engine.gangs = self

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._subs = [
            await self.bus.subscribe(subj.GANG_WILDCARD, self._on_gang_msg),
            await self.bus.subscribe(subj.PREEMPT, self._on_preempt),
        ]
        if self._watch_task is None:
            self._watch_task = asyncio.ensure_future(self._watch_loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        if self._watch_task is not None:
            self._watch_task.cancel()
            await logx.join_task(self._watch_task, name="gang-watchdog")
            self._watch_task = None
        for t in list(self._holdoffs):
            t.cancel()
            await logx.join_task(t, name="gang-holdoff")
        self._holdoffs.clear()

    def update_routing(self, pool_config: PoolConfig) -> None:
        self.pool_config = pool_config

    # ------------------------------------------------------------------
    # submit path (called from Engine._post_decision for gang-labeled jobs)
    # ------------------------------------------------------------------
    async def on_submit(
        self,
        req: JobRequest,
        *,
        extra_ops: Optional[list] = None,
        pending_fields: Optional[dict[str, str]] = None,
        trace_id: str = "",
        parent_span_id: str = "",
    ) -> None:
        """Admit a gang job: reserve-and-dispatch immediately when the FIFO
        is empty and devices cover it, else queue.  Idempotent under
        redelivery — a job with a live gang record is a no-op, so PENDING
        replays of a queued gang just keep it alive."""
        live = self._by_job.get(req.job_id)
        if live is not None and live.state in (GANG_QUEUED, GANG_RUNNING):
            return
        n = gang_workers(req.labels)
        if n < 1:
            raise ValueError(f"job {req.job_id} is not gang-labeled")
        rec = GangRecord(
            gang_id=new_id(),
            job_id=req.job_id,
            req=req,
            trace_id=trace_id,
            parent_span_id=parent_span_id,
            n_workers=n,
            chips=gang_chips(req.labels),
            kind=gang_kind(req.labels),
            extra_ops=list(extra_ops or []),
            pending_fields=dict(pending_fields or {}),
        )
        rec.reserve_span = self.tracer.begin(
            "gang-reserve", trace_id=trace_id, parent_span_id=parent_span_id,
            attrs={"job_id": req.job_id, "gang_id": rec.gang_id,
                   "workers": str(n)},
        )
        self._enqueue(rec)
        await self._pump()
        if rec.state == GANG_QUEUED:
            self.metrics.gang_admissions.inc(outcome="queued")

    def _enqueue(self, rec: GangRecord) -> None:
        self._by_job[rec.job_id] = rec
        self._by_gang[rec.gang_id] = rec
        self._fifo.append(rec)
        self.metrics.gang_queue_depth.set(float(len(self._fifo)))

    def _pools_for(self, rec: GangRecord) -> list[Pool]:
        # follow the strategy's hot-reloaded pool config when present (the
        # ConfigOverlay swaps it atomically via update_routing)
        pc = getattr(self.engine.strategy, "_pool_config", None) or self.pool_config
        return pc.pools_for_topic(rec.req.topic)

    def _requires_for(self, rec: GangRecord) -> list[str]:
        return list(rec.req.metadata.requires) if rec.req.metadata else []

    def _satisfiable(self, rec: GangRecord) -> bool:
        """Could this gang EVER fit on the live fleet (ignoring transient
        reservations, honoring its exclusions)?"""
        groups = self.ledger.eligible_workers(
            pools=self._pools_for(rec), job_requires=self._requires_for(rec),
            chips=rec.chips, exclude=tuple(rec.exclude),
            include_reserved=True,
        )
        return any(len(g) >= rec.n_workers for g in groups.values())

    async def _pump(self) -> None:
        """Admit queued gangs in FIFO order.  A *satisfiable* head that
        cannot reserve yet blocks the line (no overtake — a stream of small
        gangs must not starve a big one); an UNsatisfiable gang first drops
        its exclusions (a transiently-failed worker must not wedge a small
        fleet), then — still unplaceable — is skipped so it cannot block
        the line, and fails to the DLQ past ``queued_timeout_s``.

        Single-flight: concurrent pump requests (watchdog tick, a release,
        a submit) coalesce into one pass + one re-run — overlapping passes
        could otherwise double-dispatch the record they both saw queued."""
        if self._pumping:
            self._pump_again = True
            return
        self._pumping = True
        try:
            await self._pump_locked()
            while self._pump_again:
                self._pump_again = False
                await self._pump_locked()
        finally:
            self._pumping = False

    async def _pump_locked(self) -> None:
        progressed = True
        while progressed:
            progressed = False
            for rec in list(self._fifo):
                if rec.state != GANG_QUEUED:
                    with contextlib.suppress(ValueError):
                        self._fifo.remove(rec)
                    continue
                members = self.ledger.try_reserve(
                    rec.gang_id, rec.n_workers,
                    pools=self._pools_for(rec),
                    job_requires=self._requires_for(rec),
                    chips=rec.chips,
                    exclude=tuple(rec.exclude),
                )
                if members is not None:
                    with contextlib.suppress(ValueError):
                        self._fifo.remove(rec)
                    try:
                        await self._dispatch(rec, members)
                    except Exception as e:  # noqa: BLE001 - one gang must not wedge the queue
                        logx.error("gang dispatch failed", gang_id=rec.gang_id,
                                   job_id=rec.job_id, err=str(e))
                        self.ledger.release(rec.gang_id)
                        self._finish_record(rec, GANG_ABORTED,
                                            reason="dispatch_error")
                    progressed = True
                    break
                if self._satisfiable(rec):
                    break  # head-of-line: wait for devices, no overtake
                if rec.exclude:
                    # the exclusions made it unplaceable on this fleet:
                    # forgive them (the excluded workers may be fine) and
                    # retry — the attempts budget still bounds the cycle
                    logx.warn("gang unplaceable with exclusions; clearing",
                              gang_id=rec.gang_id, job_id=rec.job_id,
                              excluded=",".join(sorted(rec.exclude)))
                    rec.exclude.clear()
                    progressed = True
                    break
                if rec.age_s > self.queued_timeout_s:
                    await self._fail_unplaceable(rec)
                    progressed = True
                    break
                # unsatisfiable but young: let later gangs overtake it
                continue
        self.metrics.gang_queue_depth.set(float(len(self._fifo)))

    async def _fail_unplaceable(self, rec: GangRecord) -> None:
        snap = await self.job_store.watch_meta(rec.job_id)
        self._finish_record(rec, GANG_FAILED, reason="unplaceable")
        self.metrics.gang_completed.inc(status="failed")
        await self.engine._fail_to_dlq(
            rec.req,
            f"gang unplaceable: no slice with {rec.n_workers} eligible "
            f"workers within {self.queued_timeout_s:.0f}s",
            "GANG_UNPLACEABLE", snap=snap,
        )

    async def _dispatch(self, rec: GangRecord, members: list[str]) -> None:
        """Fan the job out to every reserved member with rank/size labels;
        one SCHEDULED→DISPATCHED→RUNNING chain covers the whole gang."""
        snap = await self.job_store.watch_meta(rec.job_id)
        st = snap.state
        if snap.is_terminal:
            # cancelled/finished while queued: nothing to run
            self.ledger.release(rec.gang_id)
            self._finish_record(rec, GANG_ABORTED, reason="terminal_before_dispatch")
            return
        attempts = int(snap.get("attempts", "0") or "0") + (
            1 if rec.count_attempt else 0
        )
        if attempts > self.engine.max_attempts:
            self.ledger.release(rec.gang_id)
            self._finish_record(rec, GANG_FAILED, reason="max_attempts")
            self.metrics.gang_completed.inc(status="failed")
            await self.engine._fail_to_dlq(
                rec.req, "gang failover attempts exhausted", "MAX_RETRIES",
                fields={"attempts": str(attempts)}, snap=snap,
            )
            return
        fields = {
            "dispatch_subject": subj.gang_subject(rec.gang_id),
            "gang_id": rec.gang_id,
            "gang_members": ",".join(members),
            "attempts": str(attempts),
            **rec.pending_fields,
        }
        if st in (JobState.DISPATCHED.value, JobState.RUNNING.value):
            # requeued gang: the job is legally still in flight — a
            # same-state fields commit retargets it (failover_job's shape;
            # same-state steps don't auto-append, so the audit event is
            # explicit)
            await self.job_store.apply_chain(
                rec.job_id, [(JobState(st), fields, "")], snap=snap,
            )
            await self.job_store.append_event(
                rec.job_id, "gang_redispatched", gang_id=rec.gang_id,
                members=",".join(members), attempts=attempts,
            )
        else:
            await self.job_store.apply_chain(
                rec.job_id,
                [(JobState.SCHEDULED, fields, "gang_scheduled"),
                 (JobState.DISPATCHED, None, "dispatched"),
                 (JobState.RUNNING, None, "running")],
                snap=snap, extra_ops=list(rec.extra_ops),
            )
            rec.extra_ops = []  # committed once; requeues must not re-add
        rec.members = members
        rec.state = GANG_RUNNING
        rec.dispatched_at = time.monotonic()
        self.metrics.gang_admissions.inc(outcome="reserved")
        self.metrics.gang_size.observe(float(len(members)))
        if rec.reserve_span is not None:
            rec.reserve_span.attrs["members"] = ",".join(members)
            rec.reserve_span.attrs["queued_ms"] = str(
                round(1000 * rec.age_s, 1))
            await self.tracer.finish(rec.reserve_span)
            rec.reserve_span = None
        dsp = self.tracer.begin(
            "gang-dispatch", trace_id=rec.trace_id,
            parent_span_id=rec.parent_span_id,
            attrs={"job_id": rec.job_id, "gang_id": rec.gang_id,
                   "members": ",".join(members)},
        )
        pubs = []
        for rank, wid in enumerate(members):
            member_req = JobRequest.from_dict(rec.req.to_dict())
            member_req.labels = dict(member_req.labels or {})
            member_req.labels[LABEL_GANG_ID] = rec.gang_id
            member_req.labels[LABEL_GANG_RANK] = str(rank)
            member_req.labels[LABEL_GANG_SIZE] = str(len(members))
            member_req.labels[LABEL_GANG_MEMBERS] = ",".join(members)
            # each member packet must survive the dedupe window on its own
            member_req.labels["cordum.bus_msg_id"] = (
                f"gang-{rec.gang_id}-{rank}-{attempts}"
            )
            self.engine._stamp_partition(member_req)
            pubs.append(self.bus.publish(
                subj.direct_subject(wid),
                BusPacket.wrap(
                    member_req, trace_id=rec.trace_id,
                    sender_id=self.engine.instance_id,
                    span_id=dsp.span_id, parent_span_id=dsp.parent_span_id,
                ),
            ))
        results = await asyncio.gather(*pubs, return_exceptions=True)
        await self.tracer.finish(dsp)
        failed = [members[i] for i, r in enumerate(results)
                  if isinstance(r, BaseException)]
        if failed:
            # an undeliverable member is a failed gang start: abort now so
            # peers don't burn the rendezvous timeout
            await self.abort_gang(rec, reason="dispatch_publish_failed",
                                  exclude=set(failed))
            return
        self.metrics.jobs_dispatched.inc(topic=rec.req.topic)
        logx.info("gang dispatched", gang_id=rec.gang_id, job_id=rec.job_id,
                  members=",".join(members), attempts=attempts)

    # ------------------------------------------------------------------
    # gang subject traffic
    # ------------------------------------------------------------------
    async def _on_gang_msg(self, subject: str, pkt: BusPacket) -> None:
        msg = pkt.gang_msg
        if msg is None or not msg.gang_id:
            return
        rec = self._by_gang.get(msg.gang_id)
        if rec is None or rec.state != GANG_RUNNING:
            return
        if not self.engine.owns(rec.job_id):
            return
        if msg.kind == "ready":
            rec.ready.add(msg.rank)
        elif msg.kind == "abort" and msg.worker_id:
            # member-originated abort (scheduler-originated aborts carry no
            # worker_id and were already handled locally).  Exclusions for
            # the requeue depend on who is actually at fault:
            #   member_failed:* — the REPORTER failed; exclude it
            #   rendezvous_timeout:* — the reporter is healthy; exclude the
            #     members that never beaconed ready
            #   peer_timeout:* / other — unknown culprit; the watchdog's
            #     dead-worker pass names it if it is really gone
            reason = msg.reason or "member_failed"
            exclude: set = set()
            if reason.startswith("member_failed"):
                exclude = {msg.worker_id}
            elif reason.startswith("rendezvous_timeout"):
                exclude = {
                    w for r, w in enumerate(rec.members) if r not in rec.ready
                }
            await self.abort_gang(rec, reason=reason, exclude=exclude)
        elif msg.kind == "done":
            rec.done[msg.rank] = dict(msg.stats or {})
            if len(rec.done) >= rec.n_workers and rec.state == GANG_RUNNING:
                await self._complete(rec)

    async def _complete(self, rec: GangRecord) -> None:
        rec.state = GANG_DONE
        self.ledger.release(rec.gang_id)
        await self._emit_release_span(rec, "done")
        per_rank = {str(r): rec.done[r] for r in sorted(rec.done)}
        last = rec.done.get(rec.n_workers - 1, {})
        doc = {
            "gang_id": rec.gang_id,
            "workers": rec.members,
            "per_rank": per_rank,
            # the headline numbers come from the last rank (the loss-owning
            # stage under MPMD; identical across ranks under SPMD)
            "loss": last.get("loss", last.get("final_loss")),
            "steps_done": last.get("steps_done"),
            "mesh": last.get("mesh"),
            "mode": last.get("mode", "spmd"),
        }
        if rec.kind == "serving":
            # serving gangs headline from rank 0 — the leader alone samples,
            # streams, and counts sessions/tokens (followers only replay)
            lead = rec.done.get(0, {})
            doc.update({
                "kind": "serving",
                "mode": lead.get("mode", "serving"),
                "sessions": lead.get("sessions"),
                "tokens": lead.get("tokens"),
                "tokens_per_s": lead.get("tokens_per_s"),
                "steps_done": lead.get("steps"),
            })
        ptr = await self._mem.put_result(rec.job_id, doc)
        res = JobResult(
            job_id=rec.job_id,
            status=JobState.SUCCEEDED.value,
            result_ptr=ptr,
            worker_id=f"gang:{rec.gang_id}",
            execution_ms=int(1000 * (time.monotonic() - rec.dispatched_at)),
            labels={"cordum.bus_msg_id": f"gang-result-{rec.gang_id}"},
        )
        await self.bus.publish(
            subj.result_subject(
                partition_of(rec.job_id, self.engine.shard_count),
                self.engine.shard_count,
            ),
            BusPacket.wrap(res, trace_id=rec.trace_id,
                           sender_id=self.engine.instance_id),
        )
        self.metrics.gang_completed.inc(status="succeeded")
        self._finish_record(rec, GANG_DONE)
        await self._pump()

    # ------------------------------------------------------------------
    # failure semantics: abort + attempts-bounded requeue
    # ------------------------------------------------------------------
    async def abort_gang(
        self,
        rec: GangRecord,
        *,
        reason: str,
        exclude: Optional[set] = None,
        requeue: bool = True,
        count_attempt: bool = True,
        holdoff_s: float = 0.0,
    ) -> bool:
        """Abort a RUNNING gang: broadcast the abort so every member stops
        between steps, release the full reservation, and (by default)
        requeue the job through the FIFO for a fresh attempt that excludes
        the failed workers.  Idempotent — concurrent abort causes (member
        report + watchdog) collapse into one."""
        if rec.state != GANG_RUNNING:
            return False
        rec.state = GANG_ABORTED
        rec.abort_reason = reason
        # metric label = the reason family only (the full reason carries
        # rank/exception detail — unbounded label cardinality)
        self.metrics.gang_aborts.inc(reason=reason.split(":", 1)[0])
        self.ledger.release(rec.gang_id)
        await self._emit_release_span(rec, reason)
        with contextlib.suppress(Exception):
            await self.bus.publish(
                subj.gang_subject(rec.gang_id),
                BusPacket.wrap(
                    GangMsg(gang_id=rec.gang_id, job_id=rec.job_id,
                            kind="abort", reason=reason),
                    trace_id=rec.trace_id, sender_id=self.engine.instance_id,
                ),
            )
        logx.warn("gang aborted", gang_id=rec.gang_id, job_id=rec.job_id,
                  reason=reason, requeue=requeue)
        self._finish_record(rec, GANG_ABORTED, reason=reason)
        if requeue:
            nxt = GangRecord(
                gang_id=new_id(),
                job_id=rec.job_id,
                req=rec.req,
                trace_id=rec.trace_id,
                parent_span_id=rec.parent_span_id,
                n_workers=rec.n_workers,
                chips=rec.chips,
                kind=rec.kind,
                exclude=set(rec.exclude) | set(exclude or ()),
                count_attempt=count_attempt,
                pending_fields=dict(rec.pending_fields),
            )
            nxt.reserve_span = self.tracer.begin(
                "gang-reserve", trace_id=rec.trace_id,
                parent_span_id=rec.parent_span_id,
                attrs={"job_id": rec.job_id, "gang_id": nxt.gang_id,
                       "workers": str(rec.n_workers), "requeue": reason},
            )
            if holdoff_s > 0:
                t = asyncio.ensure_future(self._requeue_later(nxt, holdoff_s))
                self._holdoffs.add(t)
                t.add_done_callback(self._holdoffs.discard)
            else:
                self._enqueue(nxt)
                await self._pump()
        await self._pump()
        return True

    async def _requeue_later(self, rec: GangRecord, holdoff_s: float) -> None:
        await asyncio.sleep(holdoff_s * (1.0 + random.uniform(-0.5, 0.5)))
        self._enqueue(rec)
        await self._pump()

    async def _emit_release_span(self, rec: GangRecord, reason: str) -> None:
        t0 = now_us()
        sp = self.tracer.begin(
            "gang-release", trace_id=rec.trace_id,
            parent_span_id=rec.parent_span_id,
            attrs={"job_id": rec.job_id, "gang_id": rec.gang_id,
                   "reason": reason},
        )
        sp.start_us = t0
        await self.tracer.finish(sp)
        if rec.reserve_span is not None:
            rec.reserve_span.attrs["abandoned"] = reason
            await self.tracer.finish(rec.reserve_span, status="ERROR")
            rec.reserve_span = None

    def _finish_record(self, rec: GangRecord, state: str, *, reason: str = "") -> None:
        rec.state = state
        if reason:
            rec.abort_reason = rec.abort_reason or reason
        if self._by_job.get(rec.job_id) is rec:
            del self._by_job[rec.job_id]
        self._by_gang.pop(rec.gang_id, None)
        with contextlib.suppress(ValueError):
            self._fifo.remove(rec)
        self.metrics.gang_queue_depth.set(float(len(self._fifo)))
        self._recent.append(rec)

    # ------------------------------------------------------------------
    # external hooks (engine cancel path, preemption governor)
    # ------------------------------------------------------------------
    async def on_cancel(self, job_id: str) -> None:
        rec = self._by_job.get(job_id)
        if rec is None:
            return
        if rec.state == GANG_QUEUED:
            if rec.reserve_span is not None:
                await self.tracer.finish(rec.reserve_span, status="ERROR")
                rec.reserve_span = None
            self._finish_record(rec, GANG_ABORTED, reason="cancelled")
        elif rec.state == GANG_RUNNING:
            await self.abort_gang(rec, reason="cancelled", requeue=False)

    async def _on_preempt(self, subject: str, pkt: BusPacket) -> None:
        """Unit preemption (docs/ADMISSION.md): a BATCH gang yields under
        interactive pressure as a whole — abort, release every device,
        requeue attempts-exempt after the jittered hold-off."""
        p = pkt.job_preempt
        if p is None or not p.job_id:
            return
        rec = self._by_job.get(p.job_id)
        if rec is None or rec.state != GANG_RUNNING:
            return
        if (rec.req.priority or "BATCH") != "BATCH":
            return
        await self.abort_gang(
            rec, reason="preempted", count_attempt=False,
            holdoff_s=PREEMPT_HOLDOFF_S,
        )
        self.metrics.preemptions.inc(reason="requeued")

    # ------------------------------------------------------------------
    # watchdog: dead members, rendezvous timeouts, FIFO pump, invariant
    # ------------------------------------------------------------------
    async def _watch_loop(self) -> None:
        while True:
            await asyncio.sleep(self.watch_interval_s)
            try:
                await self._watch_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - the watchdog must survive
                logx.error("gang watchdog error", err=str(e))

    async def _watch_once(self) -> None:
        live = self.registry.snapshot()
        now = time.monotonic()
        for rec in list(self._by_gang.values()):
            if rec.state != GANG_RUNNING:
                continue
            dead = [w for w in rec.members
                    if w not in live or live[w].draining]
            if dead:
                await self.abort_gang(rec, reason="worker_dead",
                                      exclude=set(dead))
                continue
            if (
                len(rec.ready) < rec.n_workers
                and now - rec.dispatched_at > 2 * self.rendezvous_timeout_s
            ):
                # scheduler-side backstop: the member-side barrier timeout
                # should have fired first; this recovers members that never
                # even received the dispatch
                await self.abort_gang(rec, reason="rendezvous_timeout")
        self.ledger.verify()
        await self._pump()

    # ------------------------------------------------------------------
    # observability (GET /api/v1/gangs, cordumctl gangs)
    # ------------------------------------------------------------------
    def doc(self) -> list[dict]:
        """Live gang table (+ a short tail of finished gangs), newest
        first — beaconed in the scheduler's telemetry health block and
        merged by the gateway's FleetAggregator."""
        out = []
        seen = set()
        for rec in [*self._by_gang.values(), *reversed(self._recent)]:
            if rec.gang_id in seen:
                continue
            seen.add(rec.gang_id)
            out.append({
                "gang_id": rec.gang_id,
                "job_id": rec.job_id,
                "state": rec.state,
                "kind": rec.kind or "spmd",
                "workers": rec.n_workers,
                "chips_per_worker": rec.chips,
                "members": list(rec.members),
                "ready": len(rec.ready),
                "done": len(rec.done),
                "age_s": round(rec.age_s, 2),
                "reason": rec.abort_reason,
            })
        return out


def render_gang_table(doc: dict) -> str:
    """ASCII gang table for ``cordumctl gangs`` from a /api/v1/gangs doc
    (matches the ``cordumctl capacity`` render style)."""
    rows = doc.get("gangs") or []
    header = f"{'GANG':<14} {'JOB':<14} {'STATE':<9} {'KIND':<8} " \
             f"{'WORKERS':>7} {'READY':>5} {'DONE':>4} {'AGE_S':>7}  MEMBERS"
    lines = [header, "-" * len(header)]
    for g in rows:
        lines.append(
            f"{str(g.get('gang_id', ''))[:12]:<14} "
            f"{str(g.get('job_id', ''))[:12]:<14} "
            f"{str(g.get('state', '')):<9} "
            f"{str(g.get('kind', '') or 'spmd'):<8} "
            f"{g.get('workers', 0):>7} "
            f"{g.get('ready', 0):>5} "
            f"{g.get('done', 0):>4} "
            f"{g.get('age_s', 0.0):>7.1f}  "
            f"{','.join(g.get('members') or [])}"
        )
    if not rows:
        lines.append("(no gangs)")
    queued = doc.get("queue_depth")
    if queued is not None:
        lines.append(f"queued: {queued}")
    return "\n".join(lines)
