"""Disaggregated serving placement policy (docs/SERVING.md §Disaggregation).

Two consumers of the scheduler-local :class:`~cordum_tpu_torch.obs.capacity.
CapacityView` that turn the measured capacity matrix into *live serving
placement* decisions (FlexNPU / FleetOpt, PAPERS.md) — the policy layer
over the serving page-transfer substrate:

* :class:`ServingPlacer` — routes NEW ``llm.generate`` sessions to the
  worker with the best measured **prefill** tokens/s headroom.  Prefill is
  the right admission signal: a new session's first obligation is prompt
  ingestion (TTFT), and decode placement is corrected post-prefill by the
  worker-side hand-off.  Decode-roled workers are excluded from new-session
  placement whenever a prefill-capable worker exists — their step budget
  belongs to steady token generation.

* :class:`DecodeRebalancer` — a periodic governor watching decode occupancy
  and KV-page pressure across the serving fleet.  When one worker's load
  sits ``skew_ratio`` above the fleet median for ``hysteresis_ticks``
  consecutive evaluations, it publishes a :class:`~cordum_tpu_torch.protocol.
  types.SessionRebalance` asking the hot worker to live-migrate its
  cheapest sessions (fewest live pages, oldest decode position) toward the
  peer with the most headroom.  Rate-limited per worker (``cooldown_s``)
  and paired with the worker-side migrated-in immunity window, so sessions
  never ping-pong even under oscillating skew.

Both degrade to nothing gracefully: an empty/stale capacity view disables
the placer (the strategy falls back to its measured-items/s routing and
ultimately exact LeastLoaded) and starves the governor of candidates.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Optional

from ...infra import logging as logx
from ...protocol import subjects as subj
from ...protocol.types import (
    BusPacket,
    Heartbeat,
    LABEL_MIGRATE_ADDR,
    LABEL_SERVING_ROLE,
    OP_SERVING_PREFILL,
    SERVING_ROLE_DECODE,
    SessionRebalance,
)

DEFAULT_REBALANCE_INTERVAL_S = 5.0
DEFAULT_SKEW_RATIO = 1.5
DEFAULT_HYSTERESIS_TICKS = 2
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_MAX_MOVES = 2
# a worker with fewer active sessions than this is never "hot" (moving the
# only session on a near-idle worker is churn, not rebalancing)
MIN_HOT_SESSIONS = 2
# page pressure (pages_in_use / pages_total) above which pressure skew
# alone can mark a worker hot even with modest occupancy skew
PRESSURE_FLOOR = 0.5


class ServingPlacer:
    """Role-aware placement for new ``llm.generate`` sessions against the
    measured prefill-throughput matrix."""

    def __init__(self, view: Any, *, metrics: Any = None) -> None:
        self.view = view
        self.metrics = metrics
        # smooth-WRR credit per worker (nginx-style: deterministic,
        # starvation-free, converges to exact weight proportions)
        self._wrr: dict[str, float] = {}
        self.placed = 0
        self.fallbacks = 0

    def _gang_topology(self) -> tuple[set, dict]:
        """(follower worker-ids, {leader worker-id: fused gang row}) from
        the capacity view's serving-gang fold; empty when no gang beacons
        (or the view predates the fold — older schedulers keep working)."""
        followers: set = set()
        leaders: dict[str, dict] = {}
        gangs = getattr(self.view, "serving_gangs", None)
        for row in (gangs() if callable(gangs) else {}).values():
            leader = row.get("leader", "")
            if leader:
                leaders[leader] = row
            for wid, rank in (row.get("members") or {}).items():
                if wid != leader and int(rank or 0) > 0:
                    followers.add(wid)
        return followers, leaders

    def _role(self, hb: Heartbeat) -> str:
        """The worker's serving role: the fresh capacity beacon wins, the
        heartbeat label is the fallback (beacons lag ~2s behind boot)."""
        role = self.view.serving_role(hb.worker_id)
        if not role:
            role = (hb.labels or {}).get(LABEL_SERVING_ROLE, "")
        return role

    def pick(self, candidates: list[Heartbeat], *,
             speculable: bool = False) -> str:
        """The worker a new session should prefill on, or ``""`` when the
        view has no measured prefill signal (the caller degrades to its
        ordinary routing).  Score = measured prefill tokens/s (unmeasured
        workers get the median measured rate so they become measured) ×
        KV-page headroom fraction; distributed by smooth WRR.

        ``speculable=True`` (the session carried the ``LABEL_SPECULABLE``
        hint — templated/repetitive traffic) prefers workers whose
        capacity beacon reports a speculative acceptance rate: those are
        the draft-enabled workers that turn the workload's repetition
        into multi-token verified bursts (docs/SERVING.md §Speculative
        decoding).  Preference, not a filter — when no draft-enabled
        worker is live, placement degrades to the ordinary pool.

        Serving gangs (docs/SERVING.md §Sharded serving) collapse to one
        routable endpoint: follower ranks are excluded outright (their
        step budget is slaved to the leader's broadcast), and the leader
        is weighted by the gang's *fused* capacity row — measured gang
        decode tokens/s × min-of-ranks KV-page headroom — so a faster
        gang measurably out-draws a slower one."""
        followers, gang_rows = self._gang_topology()
        pool = [hb for hb in candidates
                if not self.view.draining(hb.worker_id)
                and hb.worker_id not in followers]
        prefill_capable = [
            hb for hb in pool if self._role(hb) != SERVING_ROLE_DECODE
        ]
        if prefill_capable:
            # decode-roled workers take sessions only when nothing else can
            pool = prefill_capable
        if speculable:
            draft_enabled = [
                hb for hb in pool
                if self.view.spec_accept(hb.worker_id) is not None
            ]
            if draft_enabled:
                pool = draft_enabled
        if not pool:
            self.fallbacks += 1
            return ""
        rates = {
            hb.worker_id: self.view.token_rate(hb.worker_id,
                                               OP_SERVING_PREFILL)
            for hb in pool
        }
        for wid, row in gang_rows.items():
            # a gang leader's routable rate is the fused gang row, not its
            # solo prefill history (which predates — or never saw — the gang)
            rate = float(row.get("tokens_per_s", 0.0) or 0.0)
            if rate > 0:
                rates[wid] = rate
        measured = sorted(r for r in rates.values() if r > 0)
        if not measured:
            # no prefill row measured anywhere: nothing analytic to say
            self.fallbacks += 1
            return ""
        median = measured[len(measured) // 2]
        weights: dict[str, float] = {}
        for hb in pool:
            base = rates[hb.worker_id] or median
            row = gang_rows.get(hb.worker_id)
            if row is not None:
                # min-of-ranks headroom: the gang stalls on its fullest rank
                total = float(row.get("pages_total_min", 0) or 0)
                free = float(row.get("pages_free_min", 0) or 0)
            else:
                kv = self.view.kv_pages(hb.worker_id)
                total = float(kv.get("pages_total", 0) or 0)
                free = float(kv.get("pages_free", 0) or 0)
            if total > 0:
                headroom = free / total
            else:
                headroom = 1.0  # arena unknown: rate alone decides
            w = base * headroom
            if w > 0:
                weights[hb.worker_id] = w
        if not weights:
            # every candidate's arena is full: admission-queueing territory,
            # let the load-based fallback spread the pain
            self.fallbacks += 1
            return ""
        self.placed += 1
        return self._wrr_pick(weights)

    def _wrr_pick(self, weights: dict[str, float]) -> str:
        for gone in [w for w in self._wrr if w not in weights]:
            del self._wrr[gone]
        total = sum(weights.values())
        best, best_credit = "", float("-inf")
        for wid, w in sorted(weights.items()):
            credit = self._wrr.get(wid, 0.0) + w
            self._wrr[wid] = credit
            if credit > best_credit:
                best, best_credit = wid, credit
        self._wrr[best] -= total
        return best


class DecodeRebalancer:
    """Periodic decode-load governor: skew detection over the capacity
    view, hysteresis + per-worker rate limiting, and ``SessionRebalance``
    fan-out toward measured headroom."""

    def __init__(
        self,
        bus: Any,
        view: Any,
        registry: Any,
        *,
        instance_id: str = "scheduler",
        interval_s: float = DEFAULT_REBALANCE_INTERVAL_S,
        skew_ratio: float = DEFAULT_SKEW_RATIO,
        hysteresis_ticks: int = DEFAULT_HYSTERESIS_TICKS,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        max_moves: int = DEFAULT_MAX_MOVES,
        min_hot_sessions: int = MIN_HOT_SESSIONS,
        metrics: Any = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.bus = bus
        self.view = view
        self.registry = registry
        self.instance_id = instance_id
        self.interval_s = max(0.05, interval_s)
        self.skew_ratio = max(1.0, skew_ratio)
        self.hysteresis_ticks = max(1, hysteresis_ticks)
        self.cooldown_s = max(0.0, cooldown_s)
        self.max_moves = max(1, max_moves)
        self.min_hot_sessions = max(1, min_hot_sessions)
        self.metrics = metrics
        self.clock = clock
        self._hot_streak: dict[str, int] = {}
        self._last_cmd: dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None
        self.commands_sent = 0

    @classmethod
    def from_config(cls, bus, view, registry, doc: dict, **kw):
        """Build from the pools.yaml ``rebalancer:`` stanza (schema-checked
        upstream); returns None when disabled."""
        if not (doc or {}).get("enabled", True):
            return None
        doc = doc or {}
        return cls(
            bus, view, registry,
            interval_s=float(doc.get("interval_s",
                                     DEFAULT_REBALANCE_INTERVAL_S)),
            skew_ratio=float(doc.get("skew_ratio", DEFAULT_SKEW_RATIO)),
            hysteresis_ticks=int(doc.get("hysteresis_ticks",
                                         DEFAULT_HYSTERESIS_TICKS)),
            cooldown_s=float(doc.get("cooldown_s", DEFAULT_COOLDOWN_S)),
            max_moves=int(doc.get("max_moves", DEFAULT_MAX_MOVES)),
            **kw,
        )

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 - logged, never swallowed
                logx.warn("rebalancer loop crashed during shutdown",
                          err=str(e))
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.tick()
            except Exception as e:  # noqa: BLE001 - governor is best-effort
                logx.warn("rebalance evaluation failed", err=str(e))

    async def tick(self) -> None:
        for cmd in self.plan():
            self.commands_sent += 1
            if self.metrics is not None:
                self.metrics.serving_rebalances.inc(stage="commanded")
            logx.info("rebalance commanded", worker=cmd.worker_id,
                      target=cmd.target_worker, moves=cmd.max_sessions,
                      reason=cmd.reason)
            await self.bus.publish(
                subj.SERVING_REBALANCE,
                BusPacket.wrap(cmd, sender_id=self.instance_id),
            )

    # ------------------------------------------------------------------
    def _load(self, wid: str) -> tuple[float, float]:
        """(active decode sessions, page pressure 0..1) for one worker."""
        occ = self.view.decode_occupancy(wid)
        kv = self.view.kv_pages(wid)
        sessions = float(occ.get("active_sessions", 0) or 0)
        total = float(kv.get("pages_total", 0) or 0)
        pressure = (
            float(kv.get("pages_in_use", 0) or 0) / total if total > 0
            else 0.0
        )
        return sessions, pressure

    def _migrate_addr(self, wid: str) -> str:
        hb = self.registry.get(wid)
        return (hb.labels or {}).get(LABEL_MIGRATE_ADDR, "") if hb else ""

    def plan(self) -> list[SessionRebalance]:
        """Pure skew evaluation: which hot workers should shed, where to,
        and how many sessions — the publish-free half the tests drive.
        Hysteresis state (hot streaks, cooldown stamps) advances here."""
        now = self.clock()
        workers = [
            wid for wid in self.view.serving_workers()
            if not self.view.draining(wid)
        ]
        if len(workers) < 2:
            self._hot_streak.clear()
            return []
        loads = {wid: self._load(wid) for wid in workers}
        sessions_sorted = sorted(s for s, _ in loads.values())
        pressure_sorted = sorted(p for _, p in loads.values())
        # LOWER median: with an even fleet the upper median is the hot
        # worker's own load (a 2-worker fleet could never look skewed)
        med_sessions = sessions_sorted[(len(sessions_sorted) - 1) // 2]
        med_pressure = pressure_sorted[(len(pressure_sorted) - 1) // 2]
        cmds: list[SessionRebalance] = []
        for wid in workers:
            sessions, pressure = loads[wid]
            occ_hot = (
                sessions >= self.min_hot_sessions
                and sessions >= self.skew_ratio * max(med_sessions, 1.0)
                and sessions >= med_sessions + 1
            )
            page_hot = (
                pressure >= PRESSURE_FLOOR
                and pressure >= self.skew_ratio * max(med_pressure, 1e-9)
            )
            if not (occ_hot or page_hot):
                self._hot_streak.pop(wid, None)
                continue
            streak = self._hot_streak.get(wid, 0) + 1
            self._hot_streak[wid] = streak
            if streak < self.hysteresis_ticks:
                continue  # transient spike: wait it out
            if now - self._last_cmd.get(wid, float("-inf")) < self.cooldown_s:
                continue  # rate limit: one command per window per worker
            target = self._pick_target(wid, loads)
            if not target:
                continue
            addr = self._migrate_addr(target)
            if not addr:
                continue
            excess = max(1.0, sessions - med_sessions)
            self._last_cmd[wid] = now
            self._hot_streak[wid] = 0
            cmds.append(SessionRebalance(
                worker_id=wid,
                target_worker=target,
                target_addr=addr,
                max_sessions=int(min(self.max_moves, excess)),
                reason=(f"occupancy {sessions:g} vs median "
                        f"{med_sessions:g}" if occ_hot else
                        f"page pressure {pressure:.2f} vs median "
                        f"{med_pressure:.2f}"),
                requested_by=self.instance_id,
            ))
        return cmds

    def _pick_target(self, hot_wid: str, loads: dict) -> str:
        """The non-hot worker with the most room: free pages × steady
        decode tokens/s (unmeasured decode rate counts as 1 so a fresh
        worker with free pages still ranks), damped by its own occupancy."""
        best, best_score = "", 0.0
        for wid, (sessions, _pressure) in loads.items():
            if wid == hot_wid:
                continue
            kv = self.view.kv_pages(wid)
            free = float(kv.get("pages_free", 0) or 0)
            if free <= 0:
                continue
            decode_rate = self.view.token_rate(wid, "llm.generate") or 1.0
            score = free * decode_rate / (1.0 + sessions)
            if score > best_score:
                best, best_score = wid, score
        return best
