"""Worker runtime: the in-tree worker that executes jobs on its CUDA cards
(the PyTorch counterpart of ``cordum_tpu/worker/runtime.py``).

Recreates the reference worker runtime contract (``sdk/runtime/worker.go``):
queue-subscribe pool subjects + the direct ``worker.<id>.jobs`` subject,
``max_parallel_jobs`` semaphore, per-job cancel events fed by
``sys.job.cancel``, periodic heartbeats with live load, result status
inferred from handler outcome, ``progress()`` helper.

Device-worker deltas:
  * the worker owns its cards (``chips``, every card the process sees by
    default; the heartbeat's ``chip_count``): handlers run PyTorch
    computations in a thread-pool executor so the asyncio loop keeps
    heartbeating while the device works; every executor call pins the
    worker's device, its first card
  * heartbeats carry device telemetry (device kind, chip count, HBM use,
    duty-cycle estimate, a one-op liveness probe) read from ``torch.cuda``
    for the worker's own ``device``; there is no silent CPU fallback
  * cooperative cancel: handlers receive a :class:`JobContext` whose
    ``cancelled`` event they may poll between jitted steps
  * micro-batching: with a batcher attached (``attach_batcher``), batchable
    jobs (embed/infer) bypass the per-job semaphore, queue per
    (op, length-bucket), and flush as one padded device call — results still
    publish as ordinary per-job ``JobResult``s (docs/BATCHING.md)
"""
from __future__ import annotations

import asyncio
import itertools
import random
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..batching.engine import BatchCancelled, BatchParts, MicroBatcher
from ..device import DeviceLike, local_world, resolve_device
from ..infra import logging as logx
from ..infra.bus import Bus
from ..infra.memstore import MemoryStore
from ..obs.capacity import CapacityProfiler
from ..obs.tracer import Tracer
from ..protocol import subjects as subj
from ..protocol.types import (
    BusPacket,
    ERROR_SESSION_REQUEUE,
    Heartbeat,
    JobProgress,
    JobRequest,
    JobResult,
    JobState,
    LABEL_DECODE_TOKENS_PER_S,
    LABEL_KV_PAGES_FREE,
    LABEL_MIGRATE_ADDR,
    LABEL_PARTITION,
    LABEL_RESUME_TOKENS,
    LABEL_SERVING_ROLE,
    SERVING_ROLE_MIXED,
    SERVING_ROLE_PREFILL,
    SERVING_ROLES,
    STATUS_HINT_STREAM,
    SessionMoved,
    Span,
)
from ..serving.engine import (
    GenRequest,
    ServingEngine,
    SessionCancelled,
    SessionHibernated,
    SessionMigrated,
    SessionRequeued,
)
from ..serving.migration import MigrationError, MigrationServer, migrate_session
from ..utils.ids import new_id
from .gang import GangRunner

HEARTBEAT_INTERVAL_S = 10.0

# sentinel: payload not yet fetched from the memory store
_UNFETCHED = object()


class JobCancelled(Exception):
    pass


@dataclass
class JobContext:
    """Handed to job handlers: payload + progress/cancel plumbing."""

    request: JobRequest
    payload: Any
    worker: "Worker"
    cancelled: asyncio.Event = field(default_factory=asyncio.Event)
    started_at: float = field(default_factory=time.monotonic)
    # (name, start_us, end_us, attrs) tuples recorded by device_timer();
    # emitted as child spans of the execute span after the handler returns
    device_records: list = field(default_factory=list)

    def check_cancelled(self) -> None:
        if self.cancelled.is_set():
            raise JobCancelled(self.request.job_id)

    async def progress(self, percent: float, message: str = "") -> None:
        await self.worker.publish_progress(self.request.job_id, percent, message)

    def device_timer(self, name: str = "device", **attrs: str):
        """Sync context manager timing device work (the wall time around
        ``block_until_ready``).  Safe from executor threads: it only appends
        to a list; the event loop publishes the spans when the job ends."""
        from ..utils.ids import now_us

        class _Timer:
            def __enter__(timer):  # noqa: N805 - inner helper
                timer.t0 = now_us()
                return timer

            def __exit__(timer, et, ev, tb) -> None:  # noqa: N805
                rec_attrs = dict(attrs)
                if et is not None:
                    rec_attrs["error"] = et.__name__
                self.device_records.append((name, timer.t0, now_us(), rec_attrs))

        return _Timer()


# Handlers may be ``async def`` (must not block the loop — use
# ``ctx.worker.run_in_executor`` for blocking device work) or plain ``def``
# (automatically dispatched to the worker's thread pool so a blocking
# computation can never stall heartbeats/cancel delivery).
Handler = Callable[[JobContext], Any]


class Worker:
    def __init__(
        self,
        *,
        bus: Bus,
        store: MemoryStore,
        worker_id: str,
        pool: str = "default",
        topics: Optional[list[str]] = None,
        capabilities: Optional[list[str]] = None,
        labels: Optional[dict[str, str]] = None,
        max_parallel_jobs: int = 4,
        heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
        region: str = "",
        serving_role: str = SERVING_ROLE_MIXED,
        device: DeviceLike = None,
        chips: Optional[int] = None,
    ):
        # the worker's first card; None is the current CUDA card and
        # raises without one (device="cpu" runs on the CPU by request)
        self.device = resolve_device(device)
        # the cards it owns: every card the process sees unless told
        # (on the CPU, that many CPU "cards"; one by default)
        self.chips = local_world(self.device, chips)
        self.bus = bus
        self.store = store
        self.worker_id = worker_id
        self.pool = pool
        self.topics = topics or []
        self.capabilities = capabilities or []
        self.labels = labels or {}
        self.max_parallel_jobs = max_parallel_jobs
        self.heartbeat_interval_s = heartbeat_interval_s
        self.region = region
        self._handlers: dict[str, Handler] = {}
        self._default_handler: Optional[Handler] = None
        self._sem = asyncio.Semaphore(max_parallel_jobs)
        self._active: dict[str, JobContext] = {}
        # published-result cache: a redelivered job republishes its recorded
        # result instead of re-running the work (reference worker behavior
        # under at-least-once delivery, docs/AGENT_PROTOCOL.md)
        self._completed: dict[str, JobResult] = {}
        self._completed_cap = 512
        self._subs: list = []
        # pool-topic subscriptions kept separate: drain drops ONLY these
        # (the direct/cancel subjects stay live for in-flight work)
        self._topic_subs: list = []
        self._hb_task: Optional[asyncio.Task] = None
        self._executor = ThreadPoolExecutor(max_workers=max_parallel_jobs, thread_name_prefix=f"{worker_id}-device")
        self.tracer = Tracer("worker", bus)
        # optional micro-batcher (batching/): batchable jobs bypass the
        # per-job semaphore and coalesce into bucketed device calls
        self._batcher: Optional[MicroBatcher] = None
        # optional serving engine (serving/): llm.generate jobs
        # bypass the semaphore too — the engine's admission control (page
        # budget + max_sessions) bounds concurrency, and a session parked in
        # the decode loop must not starve the per-job lanes
        self._serving: Optional[ServingEngine] = None
        # serving session failover (docs/SERVING.md §Migration, drain, and
        # failover): the migration listener adopting peer sessions, the
        # peer map (fed by fan-out heartbeats) drain picks targets from,
        # and the drain state machine
        self._migration: Optional[MigrationServer] = None
        self._peers: dict[str, dict] = {}
        self._session_partition: dict[str, str] = {}
        # prefill/decode disaggregation (docs/SERVING.md §Disaggregation):
        # a "prefill"-roled worker hands sessions to a decode peer once
        # their prompts finish prefilling (or cross the engine's token
        # threshold); "decode" workers adopt them; "mixed" does both and
        # never hands off.  The role rides heartbeats + capacity beacons.
        self.serving_role = (
            serving_role if serving_role in SERVING_ROLES
            else SERVING_ROLE_MIXED
        )
        self._handoffs: set[str] = set()  # sessions with a hand-off in flight
        # batch preemption (docs/ADMISSION.md §Preemption): jobs still
        # waiting for an intake semaphore slot can be asked to give it back
        # — the waiter future wins the race against the acquire and the job
        # returns to the scheduler as a non-terminal SESSION_REQUEUE
        self._preempt_waiters: dict[str, asyncio.Future] = {}
        # gang scheduling: member jobs (cordum.gang_id label) route to the
        # gang runner (worker/gang.py) — rendezvous barrier + step program;
        # members publish GangMsg traffic, never JobResults.  With no runner
        # attached a gang-labelled job takes the per-job path.
        self._gang: Optional[GangRunner] = None
        self.gang_metrics = None
        self._draining = False
        self._drained = asyncio.Event()
        self._drain_task: Optional[asyncio.Task] = None
        self._telemetry = _device_telemetry(self.device, self.chips)
        # capacity observatory (ISSUE 10): online per-(op, bucket) device
        # profiles published in the telemetry beacon's `capacity` block
        self.capacity = CapacityProfiler(self._telemetry["device_kind"] or "cpu")
        self._busy_since: Optional[float] = None
        self._busy_accum = 0.0
        self._window_start = time.monotonic()

    # ------------------------------------------------------------------
    def register(self, topic: str, handler: Handler) -> None:
        """Register a handler for a topic (exact or used as fallback via
        :meth:`register_default`)."""
        self._handlers[topic] = handler

    def register_default(self, handler: Handler) -> None:
        self._default_handler = handler

    def attach_batcher(self, batcher: MicroBatcher) -> None:
        """Wire a micro-batcher between job intake and the device handlers.
        Jobs whose payload the batcher recognizes (``batcher.parts``) are
        queued and flushed as one padded device call; everything else keeps the
        per-job handler path."""
        self._batcher = batcher

    @property
    def batcher(self) -> Optional[MicroBatcher]:
        return self._batcher

    def attach_serving(self, serving: ServingEngine) -> None:
        """Wire a serving engine between job intake and the decode loop.
        Jobs whose payload it recognizes (``serving.parts``) become decode
        sessions; everything else keeps the per-job handler path."""
        self._serving = serving
        if self.serving_role == SERVING_ROLE_PREFILL:
            # post-prefill hand-off (docs/SERVING.md §Disaggregation): the
            # engine fires once per session when its prompt finishes
            # prefilling (or crosses serving_handoff_tokens); we pick the
            # decode peer with the most KV headroom × steady decode rate
            serving.on_prefill_done = self._on_prefill_done
        # capacity beacon gauges: KV-page/arena headroom + decode occupancy
        # (read at snapshot time, never on the decode hot path)
        alloc = serving.allocator

        def _kv_headroom() -> dict:
            doc = {
                "pages_total": alloc.num_pages - 1,  # page 0 is the null page
                "pages_free": alloc.free_pages,
                "pages_in_use": alloc.used_pages,
            }
            if serving.prefix is not None:
                # prefix-cache residency (docs/SERVING.md §Prefix cache and
                # tiering): cached full-page prefixes still in the device
                # arena, and cold pages tiered out to host RAM
                doc["prefix_pages"] = serving.prefix.warm_pages
                doc["prefix_cold_pages"] = serving.prefix.cold_pages
            return doc

        self.capacity.set_kv_headroom(_kv_headroom)
        stats = serving.stats

        def _occupancy() -> dict:
            doc = {
                "decode_mean": round(stats.mean_occupancy, 3),
                "decode_max": stats.max_occupancy,
                "active_sessions": serving.active_sessions(),
            }
            if serving.prefix is not None:
                pf = serving.prefix.stats
                looked = pf.hits + pf.misses
                doc["prefix_hits"] = pf.hits
                doc["prefix_hit_rate"] = (
                    round(pf.hits / looked, 3) if looked else 0.0
                )
            if serving.tiering is not None:
                warm, cold = serving.tiering.tier_counts()
                doc["resident_warm"] = warm
                doc["resident_cold"] = cold
                doc["hibernated_sessions"] = len(serving.tiering.arena)
            if serving.speculative:
                # speculative acceptance (docs/SERVING.md §Speculative
                # decoding): the engine-level EWMA rides the existing
                # occupancy block, so the capacity matrix and the placer's
                # speculable-hint preference need no new ingest schema —
                # absence of the key IS the "speculation disabled" signal
                doc["spec_accept_rate"] = round(serving.spec_accept_ewma, 3)
            return doc

        self.capacity.set_occupancy(_occupancy)
        if serving.tiering is not None:
            # affinity keepalive (docs/SERVING.md §Prefix cache and tiering):
            # a hibernated conversation must route back HERE next turn — the
            # cold record is host-local — so the scheduler pins its affinity
            # entry past the normal TTL; restoring unpins it again
            serving.tiering.on_hibernated = (
                lambda key: self._publish_tier_move(key, "hibernated")
            )
            serving.tiering.on_restored = (
                lambda key: self._publish_tier_move(key, "restored")
            )

    def _publish_tier_move(self, session_key: str, reason: str) -> None:
        """Announce a tiering transition for ``session_key`` on the moved
        subject.  reason="hibernated" makes the scheduler pin the affinity
        entry (strategy.py SESSION_HIBERNATE_TTL_S); "restored" reverts it
        to the normal TTL.  Fire-and-forget like the migration
        announcement — a lost packet only risks a cold re-prefill."""
        if not session_key:
            return
        asyncio.ensure_future(self.bus.publish(
            subj.SERVING_MOVED,
            BusPacket.wrap(SessionMoved(
                job_id="",
                session_key=session_key,
                from_worker=self.worker_id,
                to_worker=self.worker_id,
                reason=reason,
            ), sender_id=self.worker_id),
        ))

    @property
    def serving(self) -> Optional[ServingEngine]:
        return self._serving

    def attach_gang(self, runner: GangRunner, *, metrics=None) -> None:
        """Wire a gang runner between job intake and the step programs.
        Jobs carrying the scheduler-stamped gang labels bypass the handler
        path and the intake semaphore: the gang's reservation is the
        concurrency bound."""
        self._gang = runner
        self.gang_metrics = metrics

    @property
    def gang(self) -> Optional[GangRunner]:
        return self._gang

    async def run_in_executor(self, fn, *args):
        """Run a blocking device computation off the event loop, in an
        executor thread pinned to the worker's device."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._on_device, fn, args)

    def _on_device(self, fn, args):
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return fn(*args)
        return fn(*args)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._subs.append(
            await self.bus.subscribe(subj.direct_subject(self.worker_id), self._on_job, queue=self.worker_id)
        )
        for topic in self.topics:
            self._topic_subs.append(await self.bus.subscribe(topic, self._on_job, queue=self.pool))
        self._subs.append(await self.bus.subscribe(subj.CANCEL, self._on_cancel))
        self._subs.append(await self.bus.subscribe(subj.DRAIN, self._on_drain))
        self._subs.append(await self.bus.subscribe(subj.PREEMPT, self._on_preempt))
        if self._serving is not None:
            # live-migration listener + the peer map drain targets come
            # from (fan-out heartbeats carry each peer's listener address
            # and KV-page headroom)
            self._migration = MigrationServer(
                self._adopt_session, metrics=self._serving.metrics
            )
            await self._migration.start()
            self._subs.append(
                await self.bus.subscribe(subj.HEARTBEAT, self._on_peer_heartbeat)
            )
            self._subs.append(
                await self.bus.subscribe(subj.SERVING_REBALANCE,
                                         self._on_rebalance)
            )
        self._hb_task = asyncio.ensure_future(self._heartbeat_loop())
        await self.send_heartbeat()

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._hb_task:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 - logged, never swallowed
                logx.warn("heartbeat loop crashed during shutdown", err=str(e))
        for s in [*self._subs, *self._topic_subs]:
            s.unsubscribe()
        self._subs = []
        self._topic_subs = []
        if self._migration is not None:
            await self._migration.stop()
            self._migration = None
        if self._batcher is not None:
            await self._batcher.stop()  # drain queued batches before the pool dies
        if self._serving is not None:
            await self._serving.stop()  # evict sessions (they publish CANCELLED)
        if self._gang is not None:
            await self._gang.stop()  # cancel member tasks: no abort published,
            # the scheduler's watchdog recovers the gang, as after a crash
        self._executor.shutdown(wait=False)

    # ------------------------------------------------------------------
    async def _on_cancel(self, subject: str, pkt: BusPacket) -> None:
        c = pkt.job_cancel
        if c is None or not c.job_id:
            return
        if c.job_id in self._active:
            self._active[c.job_id].cancelled.set()
        if self._batcher is not None:
            # still waiting in a batch queue: pull it out so it does not ride
            # in the flush; its waiter raises BatchCancelled and the job
            # publishes an ordinary CANCELLED result
            self._batcher.cancel(c.job_id)
        if self._serving is not None:
            # stateful cancel: evict the session from the decode loop (or
            # the admission queue) and free its KV pages; its waiter raises
            # SessionCancelled → ordinary CANCELLED result
            self._serving.cancel(c.job_id)

    async def _on_preempt(self, subject: str, pkt: BusPacket) -> None:
        """Batch-job preemption (docs/ADMISSION.md §Preemption): hand the
        job back to the scheduler where that is cheap and safe — a serving
        session requeues mid-decode (its pages free immediately and its
        streamed tokens ride the failover resume prefix), a job still
        waiting for an intake slot gives the slot up.  A handler already
        executing on the device is NOT interrupted: the request is simply
        ignored and the governor moves on."""
        p = pkt.job_preempt
        if p is None or not p.job_id:
            return
        waiter = self._preempt_waiters.get(p.job_id)
        if waiter is not None and not waiter.done():
            waiter.set_result(p.reason or "preempted")
            return
        if self._serving is not None and p.job_id in self._active:
            # requeue only if it really is a live session here (requeue()
            # returns False for unknown ids, so this is belt-and-braces)
            self._serving.requeue(p.job_id, "preempted")

    # ------------------------------------------------------------------
    # graceful drain + session migration (docs/SERVING.md §Migration,
    # drain, and failover)
    # ------------------------------------------------------------------
    async def _on_drain(self, subject: str, pkt: BusPacket) -> None:
        wd = pkt.worker_drain
        if wd is None or (wd.worker_id and wd.worker_id != self.worker_id):
            return
        logx.info("drain requested", worker_id=self.worker_id,
                  requested_by=wd.requested_by, reason=wd.reason)
        if self._drain_task is None:
            self._drain_task = asyncio.ensure_future(self.drain())

    async def _on_peer_heartbeat(self, subject: str, pkt: BusPacket) -> None:
        hb = pkt.heartbeat
        if hb is None or not hb.worker_id or hb.worker_id == self.worker_id:
            return
        addr = (hb.labels or {}).get(LABEL_MIGRATE_ADDR, "")
        if not addr:
            return
        labels = hb.labels or {}
        try:
            pages_free = int(labels.get(LABEL_KV_PAGES_FREE, "0") or 0)
        except ValueError:
            pages_free = 0
        try:
            decode_tps = float(labels.get(LABEL_DECODE_TOKENS_PER_S, "0") or 0)
        except ValueError:
            decode_tps = 0.0
        if len(self._peers) > 1024:
            self._peers.clear()  # unbounded-fleet guard
        self._peers[hb.worker_id] = {
            "addr": addr,
            "pages_free": pages_free,
            # hand-off targets rank by headroom × steady decode tokens/s
            # (the peer's own capacity-profiler measurement)
            "decode_tps": decode_tps,
            "role": labels.get(LABEL_SERVING_ROLE, SERVING_ROLE_MIXED),
            "draining": bool(hb.draining),
            "seen": time.monotonic(),
        }

    def _live_peers(self, *, exclude: tuple = ()) -> list[tuple[str, dict]]:
        window = max(30.0, 3 * self.heartbeat_interval_s)
        now = time.monotonic()
        return [
            (wid, p) for wid, p in self._peers.items()
            if not p["draining"] and now - p["seen"] <= window
            and wid not in exclude
        ]

    def _ranked_drain_peers(self) -> list[tuple[str, str]]:
        """Every live, non-draining peer as ``(worker_id, addr)``, most
        free KV pages first — drain targets (any role beats a requeue)."""
        peers = self._live_peers()
        peers.sort(key=lambda e: e[1]["pages_free"], reverse=True)
        return [(wid, p["addr"]) for wid, p in peers]

    def _ranked_handoff_peers(
        self, *, exclude: tuple = ()
    ) -> list[tuple[str, str]]:
        """Decode-capable peers ranked by KV-page headroom × steady decode
        tokens/s (docs/SERVING.md §Disaggregation) — the hand-off and
        rebalance target order.  Prefill-roled peers are excluded (their
        step budget is ingestion capacity); an unmeasured decode rate
        counts as 1.0 so a fresh decode worker still ranks by headroom."""
        peers = [
            (wid, p) for wid, p in self._live_peers(exclude=exclude)
            if p.get("role", SERVING_ROLE_MIXED) != SERVING_ROLE_PREFILL
            and p["pages_free"] > 0
        ]
        peers.sort(
            key=lambda e: e[1]["pages_free"] * max(e[1]["decode_tps"], 1.0),
            reverse=True,
        )
        return [(wid, p["addr"]) for wid, p in peers]

    async def _migrate_with_retry(
        self,
        job_id: str,
        targets: list[tuple[str, str]],
        *,
        reason: str = "handoff",
    ) -> tuple[bool, bool]:
        """Drive one session migration with ONE jittered retry against the
        next-best target (docs/SERVING.md §Disaggregation) — a single
        handshake failure must not silently abandon the move.  Returns
        ``(moved, used_retry)``; on False the session keeps decoding
        locally (the callers decide between local decode and requeue)."""
        serving = self._serving
        if serving is None:
            return False, False
        for attempt, (peer_id, addr) in enumerate(targets[:2]):
            if serving.describe_session(job_id) is None:
                return False, attempt > 0  # finished/cancelled meanwhile
            if attempt > 0:
                # jittered back-off before the fallback target: lets a
                # transiently wedged listener drain, and decorrelates
                # concurrent hand-offs retrying into the same peer
                await asyncio.sleep(random.uniform(0.05, 0.25))
            host, _, port = addr.rpartition(":")
            try:
                moved = await migrate_session(
                    serving, job_id, host, int(port),
                    meta_extra={
                        "partition": self._session_partition.get(job_id, ""),
                        "from_worker": self.worker_id,
                        "move_reason": reason,
                    },
                    metrics=serving.metrics,
                )
            except Exception as e:  # noqa: BLE001 - try the next target
                logx.warn("migration attempt crashed", job_id=job_id,
                          target=addr, err=str(e))
                moved = False
            if moved:
                return True, attempt > 0
        return False, len(targets) > 1

    # ------------------------------------------------------------------
    # post-prefill hand-off + decode rebalancing (docs/SERVING.md
    # §Disaggregation)
    # ------------------------------------------------------------------
    def _on_prefill_done(self, job_id: str) -> None:
        """Engine hook (fires once per session, from the decode loop): a
        prefill-roled worker ships the freshly prefilled session to the
        best decode peer.  Non-blocking — the loop keeps stepping while
        the live page phase streams."""
        if self._draining or self._closed_for_handoff(job_id):
            return
        self._handoffs.add(job_id)
        asyncio.ensure_future(self._handoff_session(job_id))

    def _closed_for_handoff(self, job_id: str) -> bool:
        return self._serving is None or job_id in self._handoffs

    async def _handoff_session(self, job_id: str) -> None:
        serving = self._serving
        metrics = serving.metrics if serving is not None else None
        try:
            peers = self._ranked_handoff_peers()
            if not peers:
                # no decode-capable peer: decode continues locally — the
                # policy degrades to co-location, never breaks the session
                if metrics is not None:
                    metrics.serving_handoffs.inc(outcome="no_peer")
                return
            moved, retried = await self._migrate_with_retry(
                job_id, peers, reason="handoff")
            if metrics is not None:
                outcome = (
                    ("retried_ok" if retried else "ok") if moved else "failed"
                )
                metrics.serving_handoffs.inc(outcome=outcome)
        finally:
            self._handoffs.discard(job_id)

    async def _on_rebalance(self, subject: str, pkt: BusPacket) -> None:
        """The decode rebalancer's move request: migrate our cheapest
        sessions (fewest live pages, oldest decode position; cooldown-
        immune sessions excluded — no ping-pong) toward the named
        headroom target, with the next-best peer as the jittered
        fallback."""
        rb = pkt.session_rebalance
        serving = self._serving
        if (
            rb is None or rb.worker_id != self.worker_id
            or serving is None or self._draining
        ):
            return
        metrics = serving.metrics
        job_ids = serving.pick_rebalance_sessions(max(1, rb.max_sessions))
        if not job_ids:
            if metrics is not None:
                metrics.serving_rebalances.inc(stage="no_sessions")
            return
        fallbacks = self._ranked_handoff_peers(
            exclude=(rb.target_worker, self.worker_id))
        targets = [(rb.target_worker, rb.target_addr), *fallbacks]
        for job_id in job_ids:
            moved, _ = await self._migrate_with_retry(
                job_id, targets, reason="rebalance")
            if metrics is not None:
                metrics.serving_rebalances.inc(
                    stage="moved" if moved else "failed")

    @property
    def draining(self) -> bool:
        return self._draining

    async def drain(self, timeout_s: float = 60.0) -> None:
        """Graceful drain: stop admitting, live-migrate every serving
        session to the peer with the most KV headroom (scheduler requeue as
        the fallback — zero CANCELLED sessions either way), let per-job
        work finish, and beacon ``draining`` so the scheduler deregisters
        this worker and evicts its affinity entries.  Idempotent; the
        caller (cmd/worker) exits once it returns."""
        if self._draining:
            await self._drained.wait()
            return
        self._draining = True
        logx.info("worker draining", worker_id=self.worker_id,
                  sessions=self._serving.session_count if self._serving else 0,
                  active_jobs=len(self._active))
        try:
            # the draining heartbeat deregisters us and evicts our
            # session/batch affinity BEFORE sessions start moving, so no
            # new turn races its session's migration
            await self.send_heartbeat()
        except Exception:  # noqa: BLE001 - beacon loss must not stop the drain
            logx.warn("draining heartbeat failed", worker_id=self.worker_id)
        for s in self._topic_subs:
            s.unsubscribe()
        self._topic_subs = []
        if self._serving is not None:
            for job_id in list(self._serving.session_ids()):
                moved = False
                # most-KV-headroom peer first, one jittered retry against
                # the next-best (any role beats a requeue when draining)
                peers = self._ranked_drain_peers()
                if peers and self._serving.describe_session(job_id) is not None:
                    moved, _ = await self._migrate_with_retry(
                        job_id, peers, reason="drain")
                if not moved:
                    # pending sessions (no KV state) and unmigratable ones
                    # go back to the scheduler — re-dispatched, not killed
                    self._serving.requeue(job_id, "worker draining")
        deadline = time.monotonic() + timeout_s
        while self._active and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if self._active:
            logx.warn("drain timeout with jobs still active",
                      worker_id=self.worker_id, jobs=len(self._active))
        try:
            await self.send_heartbeat()  # final draining beacon
        except Exception as e:  # noqa: BLE001 - beacon loss must not stop the drain
            logx.warn("final draining heartbeat failed",
                      worker_id=self.worker_id, err=str(e))
        logx.info("worker drained", worker_id=self.worker_id)
        self._drained.set()

    async def wait_drained(self) -> None:
        await self._drained.wait()

    async def _adopt_session(self, meta: dict, state: dict, records: list) -> None:
        """Migration-listener install callback: adopt a peer's session —
        scatter its shipped pages into our arena and resume decoding.
        Raises to refuse (the sender falls back to a scheduler requeue)."""
        serving = self._serving
        if serving is None or self._draining:
            raise MigrationError("worker not accepting sessions")
        job_id = str(meta.get("job_id", ""))
        if not job_id:
            raise MigrationError("migration meta missing job_id")
        if job_id in self._completed:
            raise MigrationError(f"job {job_id} already completed here")
        eos = meta.get("eos_token")
        gen = GenRequest(
            prompt=[int(t) for t in meta.get("prompt") or []],
            max_new_tokens=int(meta.get("max_new_tokens", 16) or 16),
            session_key=str(meta.get("session_key", "") or ""),
            eos_token=int(eos) if isinstance(eos, int) else None,
            stream=bool(meta.get("stream", True)),
            resume_tokens=[int(t) for t in meta.get("resume_tokens") or []],
        )
        trace_id = str(meta.get("trace_id", "") or "")
        fut = await serving.install_session(
            gen, job_id=job_id, state=state, records=records,
            trace_id=trace_id, on_tokens=self._token_sink(job_id, gen),
        )
        self._session_partition[job_id] = str(meta.get("partition", "") or "")
        asyncio.ensure_future(self._finish_adopted(job_id, gen, trace_id, fut))
        # ownership announcement (docs/SERVING.md §Disaggregation): the
        # scheduler retargets the session's affinity so follow-up turns and
        # cancels route here; fire-and-forget — a lost announcement only
        # degrades to lazy eviction + re-election
        asyncio.ensure_future(self.bus.publish(
            subj.SERVING_MOVED,
            BusPacket.wrap(SessionMoved(
                job_id=job_id,
                session_key=gen.session_key,
                from_worker=str(meta.get("from_worker", "") or ""),
                to_worker=self.worker_id,
                reason=str(meta.get("move_reason", "") or ""),
            ), trace_id=trace_id, sender_id=self.worker_id),
        ))

    async def _finish_adopted(
        self, job_id: str, gen: GenRequest, trace_id: str, fut: asyncio.Future
    ) -> None:
        """Await an adopted session and publish its terminal result — the
        half of ``_run_job`` a migrated-in job still needs (the source
        worker's waiter publishes nothing once migration commits)."""
        t0 = time.monotonic()
        partition = self._session_partition.pop(job_id, "")
        status = JobState.SUCCEEDED.value
        error_code = error_message = result_ptr = ""
        try:
            tokens = await fut
            out = ServingEngine.result_doc(gen, tokens)
            result_ptr = await self.store.put_result(job_id, out)
        except SessionMigrated:
            return  # chained onward migration: the next owner publishes
        except SessionHibernated:
            return  # tiered to the cold arena: the restore path publishes
        except SessionRequeued as e:
            await self._publish_requeue(job_id, str(e) or "requeued",
                                        trace_id=trace_id, partition=partition)
            return
        except SessionCancelled:
            status = JobState.CANCELLED.value
            error_code, error_message = "CANCELLED", "cancelled"
        except Exception as e:  # noqa: BLE001 - adopted session failed
            status = JobState.FAILED.value
            error_code = type(e).__name__
            error_message = str(e) or error_code
        res = JobResult(
            job_id=job_id,
            status=status,
            result_ptr=result_ptr,
            worker_id=self.worker_id,
            execution_ms=int((time.monotonic() - t0) * 1000),
            error_code=error_code,
            error_message=error_message,
        )
        self._completed[job_id] = res
        await self.bus.publish(
            subj.stamped_result_subject(partition),
            BusPacket.wrap(res, trace_id=trace_id, sender_id=self.worker_id),
        )

    async def restore_session(self, job_id: str, *, trace_id: str = "") -> bool:
        """Thaw a live session hibernated by ``ServingEngine.hibernate_session``
        and resume publishing its stream + terminal result from this worker
        (the half the hibernate retirement deliberately skipped).  Returns
        False when the cold arena holds no such session."""
        serving = self._serving
        if serving is None or serving.tiering is None:
            return False
        doc = serving.tiering.arena.get(job_id)
        if doc is None:
            return False
        meta = doc.get("meta") or {}
        eos = meta.get("eos_token")
        gen = GenRequest(
            prompt=[int(t) for t in meta.get("prompt") or []],
            max_new_tokens=int(meta.get("max_new_tokens", 16) or 16),
            session_key=str(meta.get("session_key", "") or ""),
            eos_token=int(eos) if isinstance(eos, int) else None,
            stream=bool(meta.get("stream", True)),
            resume_tokens=[int(t) for t in meta.get("resume_tokens") or []],
        )
        fut = await serving.restore_hibernated(
            job_id, on_tokens=self._token_sink(job_id, gen)
        )
        asyncio.ensure_future(self._finish_adopted(job_id, gen, trace_id, fut))
        return True

    async def _publish_requeue(
        self, job_id: str, reason: str, *, trace_id: str = "", partition: str = ""
    ) -> None:
        """Hand a job back to the scheduler: a NON-terminal RUNNING result
        with ``error_code=SESSION_REQUEUE`` asks for failover re-dispatch
        (bounded by the attempts counter) instead of recording a terminal
        state — used by drain-without-target and the crashed decode loop."""
        res = JobResult(
            job_id=job_id,
            status=JobState.RUNNING.value,
            worker_id=self.worker_id,
            error_code=ERROR_SESSION_REQUEUE,
            error_message=reason,
            labels={"cordum.bus_msg_id":
                    f"requeue-{job_id}-{time.monotonic_ns()}"},
        )
        await self.bus.publish(
            subj.stamped_result_subject(partition),
            BusPacket.wrap(res, trace_id=trace_id, sender_id=self.worker_id),
        )

    async def _on_job(self, subject: str, pkt: BusPacket) -> None:
        req = pkt.job_request
        if req is None or not req.job_id:
            return
        if (
            self._draining
            and req.job_id not in self._active
            and req.job_id not in self._completed
        ):
            if self._gang is not None and self._gang.is_member(req):
                # a gang member landing mid-drain is dropped: the scheduler's
                # gang watchdog sees the draining heartbeat and aborts and
                # requeues the WHOLE gang (a requeue here would re-dispatch
                # the gang job to a single worker)
                return
            # new work routed here mid-drain (affinity raced the draining
            # beacon): hand it straight back for failover re-dispatch
            await self._publish_requeue(
                req.job_id, "worker draining", trace_id=pkt.trace_id,
                partition=(req.labels or {}).get(LABEL_PARTITION, ""),
            )
            return
        if self._gang is not None and self._gang.is_member(req):
            # gang member: rendezvous + step program, no intake semaphore
            # and no JobResult (the scheduler folds the member reports)
            member_payload = (
                await self.store.get_pointer(req.context_ptr)
                if req.context_ptr else None
            )
            await self._gang.handle(
                req, member_payload, trace_id=pkt.trace_id, parent_span_id=pkt.span_id,
            )
            return
        payload: Any = _UNFETCHED
        batch_parts: Optional[BatchParts] = None
        gen_req: Optional[GenRequest] = None
        if (
            (self._batcher is not None or self._serving is not None)
            and req.job_id not in self._active
            and req.job_id not in self._completed
            # explicit topic/adapter handlers win over the batch/serving path
            and self._handlers.get(req.topic) is None
            and self._handlers.get(req.adapter_id) is None
        ):
            payload = await self.store.get_pointer(req.context_ptr) if req.context_ptr else None
            if self._batcher is not None:
                batch_parts = self._batcher.parts(payload)
            if batch_parts is None and self._serving is not None:
                gen_req = self._serving.parts(payload)
                if gen_req is not None:
                    # the SLO class rides into the decode loop: batch
                    # prefill chunks yield step-budget headroom to
                    # interactive ones (docs/ADMISSION.md §Serving)
                    gen_req.job_class = req.priority or "BATCH"
                    rt = (req.labels or {}).get(LABEL_RESUME_TOKENS, "")
                    if rt:
                        # failover re-dispatch: the scheduler stamped the
                        # tokens the dead worker already streamed — they
                        # prefill as a forced-decode prefix and replay at
                        # offset 0 (docs/SERVING.md §Migration)
                        try:
                            gen_req.resume_tokens = [
                                int(t) for t in rt.split(",") if t
                            ][: gen_req.max_new_tokens]
                        except ValueError:
                            gen_req.resume_tokens = []
        if batch_parts is not None or gen_req is not None:
            # batchable/serving: no semaphore slot — a queued job must not
            # starve the per-job lanes while it waits for batch-mates (or
            # sits in the decode loop); the batcher's window / the serving
            # engine's admission control bound the actual device concurrency
            await self._run_job(
                req, trace_id=pkt.trace_id, parent_span_id=pkt.span_id,
                payload=payload, batch_parts=batch_parts, gen_req=gen_req,
            )
            return
        # per-job path: the semaphore acquire races a preemption waiter so a
        # BATCH job still queued for a slot can give it back under
        # interactive pressure (docs/ADMISSION.md §Preemption).  Once the
        # slot is held, the job is no longer preemptible.
        waiter: asyncio.Future = asyncio.get_running_loop().create_future()
        self._preempt_waiters[req.job_id] = waiter
        acquire = asyncio.ensure_future(self._sem.acquire())
        try:
            await asyncio.wait(
                {acquire, waiter}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            self._preempt_waiters.pop(req.job_id, None)
        if acquire.done() and not acquire.cancelled():
            waiter.cancel()
            try:
                await self._run_job(
                    req, trace_id=pkt.trace_id, parent_span_id=pkt.span_id,
                    payload=payload,
                )
            finally:
                self._sem.release()
            return
        acquire.cancel()
        await self._publish_requeue(
            req.job_id, "preempted: yielded intake slot", trace_id=pkt.trace_id,
            partition=(req.labels or {}).get(LABEL_PARTITION, ""),
        )

    async def _run_job(
        self,
        req: JobRequest,
        *,
        trace_id: str = "",
        parent_span_id: str = "",
        payload: Any = _UNFETCHED,
        batch_parts: Optional[BatchParts] = None,
        gen_req: Optional[GenRequest] = None,
    ) -> None:
        if req.job_id in self._active:
            return  # redelivery of an in-flight job
        cached = self._completed.get(req.job_id)
        if cached is not None:
            # already ran: republish the recorded result, don't redo the work;
            # fresh bus msg-id so the republish survives the dedupe window
            copy = JobResult.from_dict(cached.to_dict())
            copy.labels = dict(copy.labels or {})
            copy.labels["cordum.bus_msg_id"] = f"republish-{req.job_id}-{time.monotonic_ns()}"
            await self.bus.publish(
                self._result_subject(req),
                BusPacket.wrap(copy, trace_id=trace_id, sender_id=self.worker_id),
            )
            return
        if payload is _UNFETCHED:
            payload = await self.store.get_pointer(req.context_ptr) if req.context_ptr else None
        ctx = JobContext(request=req, payload=payload, worker=self)
        self._active[req.job_id] = ctx
        self._mark_busy()
        # execute span: the worker-side leg of the trace (parent = the
        # scheduler's dispatch span carried on the job packet)
        exec_span = self.tracer.begin(
            "execute",
            trace_id=trace_id,
            parent_span_id=parent_span_id,
            attrs={"job_id": req.job_id, "topic": req.topic, "worker_id": self.worker_id},
        )
        t0 = time.monotonic()
        status = JobState.SUCCEEDED.value
        error_code = error_message = ""
        result_ptr = ""
        migrated = False
        hibernated = False
        requeue_reason = ""
        if gen_req is not None:
            # remembered for drain-time migration (the commit frame carries
            # the partition so the adopting worker's result routes home)
            self._session_partition[req.job_id] = (
                (req.labels or {}).get(LABEL_PARTITION, "")
            )
        try:
            if gen_req is not None and self._serving is not None:
                # serving path: park as a decode session; the continuous-
                # batching loop streams tokens via progress packets and the
                # terminal result carries the full list
                exec_span.attrs["serving"] = "true"
                out = await self._serving.submit(
                    gen_req,
                    job_id=req.job_id,
                    trace_id=trace_id,
                    parent_span_id=exec_span.span_id,
                    on_tokens=self._token_sink(req.job_id, gen_req),
                )
                exec_span.attrs["n_tokens"] = str(out.get("n_tokens", 0))
            elif batch_parts is not None and self._batcher is not None:
                # micro-batch path: park in the (op, bucket) queue and await
                # the scattered slice of the flushed device call.  The flush
                # writes batch_size / batch_queue_wait_ms straight into the
                # execute span's attrs via the sink.
                exec_span.attrs["batched"] = "true"
                out = await self._batcher.submit(
                    batch_parts.op,
                    batch_parts.rows,
                    job_id=req.job_id,
                    length=batch_parts.length,
                    n_rows=batch_parts.n_rows,
                    trace_id=trace_id,
                    parent_span_id=exec_span.span_id,
                    attr_sink=exec_span.attrs,
                )
            else:
                handler = self._handlers.get(req.topic) or self._handlers.get(req.adapter_id) or self._default_handler
                if handler is None:
                    raise RuntimeError(f"no handler for topic {req.topic!r}")
                import inspect

                if inspect.iscoroutinefunction(handler):
                    out = await handler(ctx)
                else:
                    # sync handler: enforce executor dispatch so blocking device
                    # work cannot stall the loop (heartbeats keep flowing)
                    out = await self.run_in_executor(handler, ctx)
                    if inspect.isawaitable(out):  # sync fn returned a coroutine
                        out = await out
            if out is not None:
                result_ptr = await self.store.put_result(req.job_id, out)
        except (JobCancelled, BatchCancelled, SessionCancelled):
            status = JobState.CANCELLED.value
            error_code, error_message = "CANCELLED", "cancelled"
        except SessionMigrated:
            migrated = True  # the target worker owns stream + result now
        except SessionHibernated:
            hibernated = True  # cold arena owns it; restore publishes
        except SessionRequeued as e:
            requeue_reason = str(e) or "requeued"
        except asyncio.CancelledError:
            status = JobState.CANCELLED.value
            error_code, error_message = "CANCELLED", "worker shutdown"
        except Exception as e:  # noqa: BLE001 - handler failure → FAILED result
            status = JobState.FAILED.value
            error_code = type(e).__name__
            error_message = str(e) or traceback.format_exc(limit=3)
        finally:
            self._active.pop(req.job_id, None)
            self._mark_idle()
        self._session_partition.pop(req.job_id, None)
        if migrated or hibernated or requeue_reason:
            # none of these outcomes is terminal here: a migrated session's
            # target publishes everything; a hibernated one publishes from
            # the restore path (restore_session); a requeued one goes back
            # to the scheduler as a non-terminal SESSION_REQUEUE result —
            # no completed-cache entry, so a later redelivery can re-run it
            if not migrated and not hibernated:
                await self._publish_requeue(
                    req.job_id, requeue_reason, trace_id=trace_id,
                    partition=(req.labels or {}).get(LABEL_PARTITION, ""),
                )
            exec_span.attrs["status"] = (
                "MIGRATED" if migrated
                else "HIBERNATED" if hibernated else "REQUEUED"
            )
            await self.tracer.finish(exec_span)
            return
        exec_span.attrs["status"] = status
        if error_code:
            exec_span.attrs["error_code"] = error_code
        await self.tracer.finish(
            exec_span,
            status="OK" if status == JobState.SUCCEEDED.value else "ERROR",
        )
        # device-time spans recorded by handlers (wall time around
        # block_until_ready, compile/host split in attrs when known)
        for name, start_us, end_us, attrs in ctx.device_records:
            await self.tracer.emit(Span(
                span_id=new_id(),
                parent_span_id=exec_span.span_id,
                trace_id=trace_id,
                name=name,
                service="worker",
                start_us=start_us,
                end_us=end_us,
                attrs={"job_id": req.job_id, **attrs},
            ))
        # capacity observatory: successful per-job-path work feeds the
        # device profiler (the micro-batch flush and the serving decode loop
        # feed it directly — observing those jobs here would double count)
        if (
            status == JobState.SUCCEEDED.value
            and batch_parts is None
            and gen_req is None
        ):
            self._observe_capacity(req, payload, ctx.device_records,
                                   time.monotonic() - t0)
        res = JobResult(
            job_id=req.job_id,
            status=status,
            result_ptr=result_ptr,
            worker_id=self.worker_id,
            execution_ms=int((time.monotonic() - t0) * 1000),
            error_code=error_code,
            error_message=error_message,
        )
        self._completed[req.job_id] = res
        if len(self._completed) > self._completed_cap:
            for k in list(itertools.islice(self._completed, self._completed_cap // 2)):
                del self._completed[k]
        await self.bus.publish(
            self._result_subject(req),
            BusPacket.wrap(
                res, trace_id=trace_id, sender_id=self.worker_id,
                span_id=exec_span.span_id, parent_span_id=exec_span.parent_span_id,
            ),
        )

    def _observe_capacity(
        self, req: JobRequest, payload: Any, device_records: list, wall_s: float
    ) -> None:
        """Feed one finished per-job-path job into the capacity profiler:
        device-timer records when the handler produced them (true device
        time, compile split, items/bucket attrs), otherwise the execute wall
        time as the host-op service time."""
        op = ""
        if isinstance(payload, dict):
            op = str(payload.get("op") or "")
        op = op or req.topic
        fed = False
        for name, start_us, end_us, attrs in device_records:
            if attrs.get("error"):
                continue  # a raised timer block is not delivered capacity
            try:
                items = int(attrs.get("items", "1") or 1)
            except (TypeError, ValueError):
                items = 1
            self.capacity.observe(
                attrs.get("op") or op,
                device_s=max(0, end_us - start_us) / 1e6,
                bucket=str(attrs.get("bucket", "-") or "-"),
                items=items,
                compiled=attrs.get("compile_cached") == "false",
            )
            fed = True
        if not fed:
            # no device timer (echo-class host ops): wall time still tells
            # the matrix what this worker delivers for the op
            self.capacity.observe(op, device_s=wall_s, items=1)

    @staticmethod
    def _result_subject(req: JobRequest) -> str:
        """Sharded schedulers stamp their partition on the dispatch; echoing
        it routes the result straight to the owning shard (no forwarding)."""
        return subj.stamped_result_subject((req.labels or {}).get(LABEL_PARTITION, ""))

    # ------------------------------------------------------------------
    def _token_sink(self, job_id: str, gen: GenRequest):
        """The serving engine's streaming callback: each decode step's new
        tokens ride a JobProgress packet with ``status_hint="stream"`` —
        relayed to WS consumers by the gateway tap, skipped by the
        scheduler's event persistence."""
        if not gen.stream:
            return None
        total = max(1, gen.max_new_tokens)

        async def sink(new_tokens: list[int], n_generated: int, done: bool) -> None:
            await self.bus.publish(
                subj.PROGRESS,
                BusPacket.wrap(
                    JobProgress(
                        job_id=job_id,
                        percent=min(100.0, 100.0 * n_generated / total),
                        status_hint=STATUS_HINT_STREAM,
                        worker_id=self.worker_id,
                        tokens=list(new_tokens),
                        # the packet's position in the session's FULL token
                        # sequence: failover replays the streamed prefix at
                        # offset 0, and consumers dedupe by offset so the
                        # assembled stream is exactly-once
                        offset=max(0, n_generated - len(new_tokens)),
                    ),
                    sender_id=self.worker_id,
                ),
            )

        return sink

    async def publish_progress(self, job_id: str, percent: float, message: str = "") -> None:
        await self.bus.publish(
            subj.PROGRESS,
            BusPacket.wrap(
                JobProgress(job_id=job_id, percent=percent, message=message, worker_id=self.worker_id),
                sender_id=self.worker_id,
            ),
        )

    # ------------------------------------------------------------------
    def telemetry_health(self) -> dict:
        """Health beacon for the fleet telemetry exporter (cmd/worker):
        live load + the stateful engines' occupancy."""
        out = {
            "role": "worker",
            "worker_id": self.worker_id,
            "pool": self.pool,
            "active_jobs": len(self._active),
            "max_parallel_jobs": self.max_parallel_jobs,
            "duty_cycle_pct": round(self._duty_cycle_peek(), 1),
            # capacity observatory: delta-encoded per-(op, bucket) device
            # profiles — the fleet aggregator folds these into the op ×
            # worker throughput matrix (docs/OBSERVABILITY.md)
            "capacity": self.capacity.snapshot(),
        }
        if self._serving is not None:
            out["serving_sessions"] = self._serving.active_sessions()
            # disaggregation placement signals (docs/SERVING.md
            # §Disaggregation): the role and drain flag ride the capacity
            # block so the scheduler's CapacityView and the fleet capacity
            # doc read them with the same staleness bound as the rates
            out["serving_role"] = self.serving_role
            out["capacity"]["serving_role"] = self.serving_role
            if self._draining:
                out["capacity"]["draining"] = True
        if self._gang is not None:
            # serving-gang membership: rank 0 beacons the gang's measured
            # throughput, followers their arena headroom; the fleet folds
            # all ranks into one capacity row
            gang_doc = self._gang.serving_gang_doc()
            if gang_doc:
                out["capacity"]["serving_gang"] = gang_doc
        if self._draining:
            out["draining"] = True
        return out

    def _duty_cycle_peek(self) -> float:
        """Duty cycle over the current window WITHOUT resetting it (the
        heartbeat's `_duty_cycle` owns the reset)."""
        now = time.monotonic()
        busy = self._busy_accum
        if self._busy_since is not None:
            busy += now - self._busy_since
        return min(100.0, 100.0 * busy / max(now - self._window_start, 1e-6))

    # ------------------------------------------------------------------
    def _mark_busy(self) -> None:
        if self._busy_since is None and self._active:
            self._busy_since = time.monotonic()

    def _mark_idle(self) -> None:
        if self._busy_since is not None and not self._active:
            self._busy_accum += time.monotonic() - self._busy_since
            self._busy_since = None

    def _duty_cycle(self) -> float:
        """Fraction of the heartbeat window the slice was executing jobs."""
        now = time.monotonic()
        busy = self._busy_accum
        if self._busy_since is not None:
            busy += now - self._busy_since
        window = max(now - self._window_start, 1e-6)
        self._busy_accum = 0.0
        self._window_start = now
        if self._busy_since is not None:
            self._busy_since = now
        return min(100.0, 100.0 * busy / window)

    def build_heartbeat(self) -> Heartbeat:
        tele = self._telemetry
        hbm_used, hbm_total = tele["hbm"]()
        labels = dict(self.labels)
        if self._migration is not None and self._serving is not None:
            # peers live-migrate serving sessions here; the free-page count
            # is the KV-headroom signal drain target selection ranks by,
            # and the role + steady decode rate let prefill workers rank
            # hand-off targets (docs/SERVING.md §Disaggregation)
            labels[LABEL_MIGRATE_ADDR] = self._migration.addr
            labels[LABEL_KV_PAGES_FREE] = str(self._serving.allocator.free_pages)
            labels[LABEL_SERVING_ROLE] = self.serving_role
            labels[LABEL_DECODE_TOKENS_PER_S] = (
                f"{self.capacity.steady_tokens_per_s('llm.generate'):.1f}"
            )
        return Heartbeat(
            worker_id=self.worker_id,
            region=self.region,
            type=tele["type"],
            active_jobs=len(self._active),
            max_parallel_jobs=self.max_parallel_jobs,
            capabilities=list(self.capabilities),
            pool=self.pool,
            labels=labels,
            draining=self._draining,
            cpu_load=_host_cpu_load(),
            tpu_duty_cycle=self._duty_cycle(),
            hbm_used_gb=hbm_used,
            hbm_total_gb=hbm_total,
            device_kind=tele["device_kind"],
            chip_count=tele["chip_count"],
            slice_topology=tele["topology"],
            devices_healthy=tele["healthy"](),
        )

    async def send_heartbeat(self) -> None:
        await self.bus.publish(
            subj.HEARTBEAT, BusPacket.wrap(self.build_heartbeat(), sender_id=self.worker_id)
        )

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval_s)
            try:
                await self.send_heartbeat()
            except Exception:
                logx.warn("heartbeat publish failed", worker_id=self.worker_id)


def _host_cpu_load() -> float:
    """Host CPU pressure as a 0-100 %: 1-minute load average normalized by
    core count.  The least-loaded strategy folds it into the worker score
    (strategy.py load_score) and treats ≥90 as overloaded — so workers
    sharing a host with unrelated heavy processes stop winning placement.
    CORDUM_HOST_LOAD=0 disables it (hermetic tests: the suite itself
    saturates single-core CI hosts, which must not flip every worker to
    overloaded)."""
    import os

    if os.environ.get("CORDUM_HOST_LOAD", "1") == "0":
        return 0.0
    try:
        return min(100.0, 100.0 * os.getloadavg()[0] / (os.cpu_count() or 1))
    except (OSError, AttributeError):  # pragma: no cover - non-POSIX
        return 0.0


def _device_telemetry(device: torch.device, chips: int) -> dict:
    """Telemetry probes for the worker's own devices, read from
    ``torch.cuda``: the first card's name, the ``chips`` cards the worker
    owns, HBM from ``mem_get_info`` and a one-op liveness check.
    ``device`` is resolved already (a worker without a card and without
    ``device="cpu"`` never gets here); a CPU worker reports the CPU, never
    a card."""
    if device.type != "cuda":
        return {
            "type": "cpu",
            "device_kind": "cpu",
            "chip_count": chips,
            "topology": "",
            "hbm": lambda: (0.0, 0.0),
            "healthy": lambda: _device_alive(device),
        }
    return {
        "type": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "chip_count": chips,
        "topology": "",
        "hbm": lambda: _hbm_gb(device),
        "healthy": lambda: _device_alive(device),
    }


def _hbm_gb(device: torch.device) -> tuple[float, float]:
    """(used, total) device memory in GB, as the driver reports it (other
    processes' allocations included)."""
    free, total = torch.cuda.mem_get_info(device)
    return (total - free) / 1e9, total / 1e9


def _device_alive(device: torch.device) -> bool:
    """Liveness probe: a trivial computation must complete on the device."""
    try:
        return float((torch.zeros(1, device=device) + 1).item()) == 1.0
    except Exception:  # noqa: BLE001 - any device fault reads as unhealthy
        return False
