"""Capacity-aware admission control — the gateway's overload defense.

The fleet already measures everything it needs to survive overload: a live
per-worker (op, bucket) throughput matrix (``FleetAggregator.capacity_doc``)
and per-class SLO burn rates (``SLOTracker``).  This module
closes the loop (docs/ADMISSION.md): admission becomes an **analytical
decision against measured capacity** (FleetOpt, PAPERS.md) instead of a
queue-depth heuristic.

Per submission the controller:

1. records the arrival in the per-(op, job_class) offered-rate EWMA
   (offered = everything that arrives, shed or not — shedding must not
   hide the overload it is reacting to);
2. charges the tenant's token bucket (``pools.yaml admission.tenants``);
3. walks the **brownout ladder** driven by the interactive SLO burn signal:
   tier 1 (5m burn ≥ 1.0) sheds all BATCH, tier 2 (page state) also sheds
   best-effort ops, tier 3 (page + deep backlog) bounds even INTERACTIVE
   behind ``interactive_queue_bound``;
4. sheds analytically on per-(op, class) **headroom** — measured fleet
   items/s (fresh matrix rows only, scaled by ``safety_factor``) minus the
   EWMA offered rate.  INTERACTIVE is admitted until *its own* share of
   capacity is exhausted; BATCH is shed first, as soon as the *total*
   offered rate exceeds capacity;
5. falls back to the queue-depth heuristic while the matrix is cold or
   stale for the op (no fresh rows → shed batch past
   ``queue_depth_limit`` of fleet scheduler backlog), re-engaging
   analytically the moment fresh rows appear.

Every shed carries an honest, headroom-derived ``Retry-After``: the time
the measured fleet needs to absorb one second of excess arrivals
(``(offered − capacity) / capacity``, clamped to the configured bounds).

The controller also publishes :class:`AdmissionPressure` beacons on
``sys.admission.pressure`` when the tier changes (and periodically while
shedding): the scheduler's preemption governor requeues dispatched BATCH
jobs on ``preempt_batch`` and serving engines deprioritize batch prefill.

Surfaced at ``GET /api/v1/admission`` / ``cordumctl admission`` and as
``cordum_gateway_shed_total`` / ``cordum_admission_headroom`` /
``cordum_admission_brownout_tier`` metrics.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ...infra.metrics import Metrics
from ...protocol import subjects as subj
from ...protocol.types import AdmissionPressure, BusPacket

INTERACTIVE_CLASSES = frozenset({"INTERACTIVE", "CRITICAL"})

DEFAULT_SAFETY_FACTOR = 0.9
DEFAULT_SMOOTHING_ALPHA = 0.3
DEFAULT_QUEUE_DEPTH_LIMIT = 256
DEFAULT_MIN_RETRY_AFTER_S = 0.25
DEFAULT_MAX_RETRY_AFTER_S = 15.0
DEFAULT_BEST_EFFORT_OPS = ("embed",)
REFRESH_INTERVAL_S = 1.0  # rate roll + capacity/SLO re-read cadence
PRESSURE_INTERVAL_S = 2.0  # re-beacon cadence while tier >= 1


@dataclass
class Verdict:
    """One admission decision; ``retry_after_s`` rides the 429 header."""

    allowed: bool
    reason: str = ""  # shed reason ("" when allowed)
    retry_after_s: float = 0.0
    mode: str = "analytic"  # analytic | fallback | disabled


class _TenantBucket:
    """Token bucket with monotonic refill; ``take`` reports the wait until
    the next token when empty (the honest tenant-quota Retry-After)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_rps: float, burst: float, now: float) -> None:
        self.rate = max(0.0, rate_rps)
        self.burst = max(1.0, burst or self.rate or 1.0)
        self.tokens = self.burst
        self.stamp = now

    def take(self, now: float) -> tuple[bool, float]:
        if self.rate <= 0:
            return True, 0.0  # unlimited
        self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self.tokens) / self.rate


class AdmissionController:
    """Analytical gateway admission against the measured capacity matrix.

    ``fleet`` is the gateway's :class:`~cordum_tpu_torch.obs.fleet.FleetAggregator`
    and ``slo_tracker`` its :class:`~cordum_tpu_torch.obs.slo.SLOTracker`; both
    are read (never written) on each refresh.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(
        self,
        *,
        fleet: Any,
        slo_tracker: Any = None,
        config: Optional[dict] = None,
        metrics: Optional[Metrics] = None,
        bus: Any = None,
        instance_id: str = "gateway-0",
        clock: Callable[[], float] = time.monotonic,
        rng: Callable[[], float] = random.random,
    ) -> None:
        cfg = dict(config or {})
        self.fleet = fleet
        self.slo_tracker = slo_tracker
        self.metrics = metrics
        self.bus = bus
        self.instance_id = instance_id
        self.clock = clock
        self.rng = rng  # injectable for deterministic shed-fraction tests
        self.enabled = bool(cfg) and bool(cfg.get("enabled", True))
        self.safety_factor = float(cfg.get("safety_factor", DEFAULT_SAFETY_FACTOR))
        self.alpha = float(cfg.get("smoothing_alpha", DEFAULT_SMOOTHING_ALPHA))
        self.queue_depth_limit = int(
            cfg.get("queue_depth_limit", DEFAULT_QUEUE_DEPTH_LIMIT)
        )
        self.interactive_queue_bound = int(
            cfg.get("interactive_queue_bound", 4 * self.queue_depth_limit)
        )
        self.min_retry_after_s = float(
            cfg.get("min_retry_after_s", DEFAULT_MIN_RETRY_AFTER_S)
        )
        self.max_retry_after_s = float(
            cfg.get("max_retry_after_s", DEFAULT_MAX_RETRY_AFTER_S)
        )
        self.best_effort_ops = frozenset(
            cfg.get("best_effort_ops") or DEFAULT_BEST_EFFORT_OPS
        )
        self._tenant_cfg: dict[str, dict] = {
            str(k): dict(v or {}) for k, v in (cfg.get("tenants") or {}).items()
        }
        self._buckets: dict[str, _TenantBucket] = {}
        # offered-rate tracking: arrivals counted per (op, class) between
        # refreshes, folded into an EWMA rate at each roll
        self._arrivals: dict[tuple[str, str], int] = {}
        self._rates: dict[tuple[str, str], float] = {}
        self._last_roll = clock()
        self._last_refresh = 0.0
        # refreshed state
        self._capacity: dict[str, float] = {}  # op → admitted items/s budget
        self._queue_depth = 0
        self._tier = 0
        self._interactive_burn = 0.0
        self._slo_states: list[dict] = []
        # pressure beacon state
        self._last_pressure_tier: Optional[int] = None
        self._last_pressure_at = 0.0
        # shed accounting for the admission doc (metrics carry the same)
        self._shed: dict[tuple[str, str], int] = {}
        self._admitted = 0

    # ------------------------------------------------------------------
    # refresh: offered-rate roll + capacity matrix + SLO tier
    # ------------------------------------------------------------------
    def _roll(self, now: float) -> None:
        dt = now - self._last_roll
        if dt <= 0:
            return
        self._last_roll = now
        a = min(1.0, self.alpha * max(1.0, dt / REFRESH_INTERVAL_S))
        seen = set(self._arrivals)
        for key, n in self._arrivals.items():
            rate = n / dt
            prev = self._rates.get(key)
            self._rates[key] = rate if prev is None else a * rate + (1 - a) * prev
        self._arrivals = {}
        # decay quiet series toward zero so old bursts stop shedding
        for key in list(self._rates):
            if key not in seen:
                self._rates[key] *= 1 - a
                if self._rates[key] < 0.01:
                    del self._rates[key]

    def refresh(self, now: Optional[float] = None) -> None:
        """Roll offered rates and re-read the capacity matrix + SLO burn
        states; sets the brownout tier and the headroom/tier gauges."""
        now = self.clock() if now is None else now
        self._last_refresh = now
        self._roll(now)
        # fresh per-op fleet capacity (capacity_doc's `ops` sums only rows
        # whose worker beaconed recently), scaled by the safety factor
        try:
            doc = self.fleet.capacity_doc()
        except Exception:  # noqa: BLE001 - a cold aggregator must not 500 submits
            doc = {}
        self._capacity = {
            str(op): float(v) * self.safety_factor
            for op, v in (doc.get("ops") or {}).items()
            if float(v) > 0
        }
        self._queue_depth = self._fleet_queue_depth()
        self._slo_states = []
        burn = 0.0
        page = False
        if self.slo_tracker is not None:
            try:
                self._slo_states = self.slo_tracker.evaluate(self.fleet)
            except Exception:  # noqa: BLE001 - SLO eval failure ≠ shed everything
                self._slo_states = []
            for state in self._slo_states:
                if str(state.get("job_class", "")).upper() not in INTERACTIVE_CLASSES:
                    continue
                w5 = (state.get("windows") or {}).get("5m") or {}
                burn = max(burn, float(w5.get("burn_rate", 0.0)))
                if state.get("state") == "page":
                    page = True
        self._interactive_burn = burn
        tier = 0
        if burn >= 1.0:
            tier = 1
        if page:
            tier = 2
            if self._queue_depth > self.interactive_queue_bound:
                tier = 3
        self._tier = tier
        if self.metrics is not None:
            self.metrics.admission_tier.set(float(tier))
            for op, cap in self._capacity.items():
                self.metrics.admission_headroom.set(
                    cap - self._offered(op, interactive_only=True),
                    op=op, job_class="INTERACTIVE",
                )
                self.metrics.admission_headroom.set(
                    cap - self._offered(op), op=op, job_class="BATCH",
                )

    def _fleet_queue_depth(self) -> int:
        """Summed live submit backlog across healthy scheduler beacons —
        the cold/stale-matrix fallback signal."""
        depth = 0
        try:
            for s in self.fleet.services():
                if s.get("service") == "scheduler" and s.get("healthy"):
                    depth += int(s.get("queue_depth") or 0)
        except Exception:  # noqa: BLE001 - beacon shape drift must not 500 submits
            return 0
        return depth

    def _offered(self, op: str, *, interactive_only: bool = False) -> float:
        total = 0.0
        for (o, klass), rate in self._rates.items():
            if o != op:
                continue
            if interactive_only and klass not in INTERACTIVE_CLASSES:
                continue
            total += rate
        return total

    # ------------------------------------------------------------------
    # the per-submission decision
    # ------------------------------------------------------------------
    def admit(
        self, *, op: str, job_class: str, tenant: str = "",
        now: Optional[float] = None,
    ) -> Verdict:
        """Decide one submission.  Always records the arrival (offered rate
        includes shed traffic); never raises."""
        now = self.clock() if now is None else now
        op = op or "-"
        klass = (job_class or "BATCH").upper()
        self._arrivals[(op, klass)] = self._arrivals.get((op, klass), 0) + 1
        if not self.enabled:
            return Verdict(True, mode="disabled")
        if now - self._last_refresh >= REFRESH_INTERVAL_S:
            self.refresh(now)

        # tenant token-bucket quota
        ok, wait = self._take_tenant_token(tenant, now)
        if not ok:
            return self._shed_verdict(
                "tenant_quota", klass,
                max(self.min_retry_after_s, min(self.max_retry_after_s, wait)),
                mode="analytic",
            )

        interactive = klass in INTERACTIVE_CLASSES
        cap = self._capacity.get(op, 0.0)

        # brownout ladder (interactive SLO burn signal)
        if self._tier >= 1 and not interactive:
            return self._shed_verdict(
                "brownout_batch", klass, self._capacity_retry_after(op, cap)
            )
        if self._tier >= 2 and op in self.best_effort_ops:
            return self._shed_verdict(
                "brownout_best_effort", klass,
                self._capacity_retry_after(op, cap),
            )
        if (
            self._tier >= 3
            and interactive
            and self._queue_depth > self.interactive_queue_bound
        ):
            return self._shed_verdict(
                "brownout_interactive", klass,
                self._depth_retry_after(self.interactive_queue_bound),
            )

        if cap <= 0.0:
            # matrix cold or stale for this op: queue-depth fallback — never
            # divide by a zero capacity, never shed interactive on it unless
            # the backlog passes the (much larger) interactive bound
            if not interactive and self._queue_depth > self.queue_depth_limit:
                return self._shed_verdict(
                    "queue_depth", klass,
                    self._depth_retry_after(self.queue_depth_limit),
                    mode="fallback",
                )
            if interactive and self._queue_depth > self.interactive_queue_bound:
                return self._shed_verdict(
                    "queue_depth", klass,
                    self._depth_retry_after(self.interactive_queue_bound),
                    mode="fallback",
                )
            self._admitted += 1
            return Verdict(True, mode="fallback")

        # analytic headroom: interactive admitted until its OWN share is
        # exhausted; batch absorbs the whole overload first.  Shedding is
        # PROPORTIONAL — each class sheds exactly its excess fraction, so
        # the admitted stream converges on the capacity budget instead of
        # flapping between shed-everything and admit-everything.
        if interactive:
            offered_int = self._offered(op, interactive_only=True)
            excess = offered_int - cap
            if excess > 0 and self.rng() < min(1.0, excess / offered_int):
                return self._shed_verdict(
                    "capacity_interactive", klass,
                    self._capacity_retry_after(op, cap),
                )
        else:
            offered = self._offered(op)
            batch_offered = offered - self._offered(op, interactive_only=True)
            excess = offered - cap
            if excess > 0 and batch_offered > 0 and self.rng() < min(
                1.0, excess / batch_offered
            ):
                return self._shed_verdict(
                    "capacity", klass, self._capacity_retry_after(op, cap)
                )
        self._admitted += 1
        return Verdict(True, mode="analytic")

    def _take_tenant_token(self, tenant: str, now: float) -> tuple[bool, float]:
        if not tenant or not self._tenant_cfg:
            return True, 0.0
        cfg = self._tenant_cfg.get(tenant) or self._tenant_cfg.get("default")
        if not cfg:
            return True, 0.0
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TenantBucket(
                float(cfg.get("rate_rps") or 0.0),
                float(cfg.get("burst") or 0.0), now,
            )
        return bucket.take(now)

    def _shed_verdict(
        self, reason: str, klass: str, retry_after: float, *,
        mode: str = "analytic",
    ) -> Verdict:
        self._shed[(reason, klass)] = self._shed.get((reason, klass), 0) + 1
        if self.metrics is not None:
            self.metrics.gateway_shed.inc(reason=reason, job_class=klass)
        return Verdict(False, reason, round(retry_after, 3), mode=mode)

    def _capacity_retry_after(self, op: str, cap: float) -> float:
        """Honest headroom-derived delay: the time the measured fleet needs
        to absorb one second of excess arrivals for this op."""
        if cap <= 0:
            return self.min_retry_after_s
        excess = max(0.0, self._offered(op) - cap)
        return max(self.min_retry_after_s,
                   min(self.max_retry_after_s, excess / cap))

    def _depth_retry_after(self, limit: int) -> float:
        over = max(0.0, self._queue_depth - limit) / max(1, limit)
        return max(self.min_retry_after_s,
                   min(self.max_retry_after_s, self.min_retry_after_s * (1 + over)))

    # ------------------------------------------------------------------
    # pressure beacons (the scheduler's preemption trigger)
    # ------------------------------------------------------------------
    async def publish_pressure(self, now: Optional[float] = None) -> bool:
        """Publish an :class:`AdmissionPressure` beacon when the tier
        changed, periodically while shedding (tier ≥ 1), and once as the
        all-clear on the transition back to 0.  Returns True if published."""
        if self.bus is None:
            return False
        now = self.clock() if now is None else now
        changed = self._last_pressure_tier != self._tier
        hot = self._tier >= 1 and (
            now - self._last_pressure_at >= PRESSURE_INTERVAL_S
        )
        if not changed and not hot:
            return False
        self._last_pressure_tier = self._tier
        self._last_pressure_at = now
        await self.bus.publish(
            subj.ADMISSION_PRESSURE,
            BusPacket.wrap(
                AdmissionPressure(
                    tier=self._tier,
                    interactive_burn_5m=round(self._interactive_burn, 3),
                    preempt_batch=self._tier >= 1,
                    reason="slo_pressure" if self._tier >= 1 else "clear",
                ),
                sender_id=self.instance_id,
            ),
        )
        return True

    # ------------------------------------------------------------------
    # introspection (GET /api/v1/admission, cordumctl admission)
    # ------------------------------------------------------------------
    @property
    def tier(self) -> int:
        return self._tier

    def doc(self) -> dict:
        """The live controller state document."""
        ops: dict[str, dict] = {}
        seen_ops = set(self._capacity) | {op for op, _ in self._rates}
        for op in sorted(seen_ops):
            cap = self._capacity.get(op, 0.0)
            offered = {
                klass: round(rate, 2)
                for (o, klass), rate in sorted(self._rates.items())
                if o == op
            }
            ops[op] = {
                "capacity_per_s": round(cap, 2),
                "offered": offered,
                "headroom_interactive": round(
                    cap - self._offered(op, interactive_only=True), 2
                ),
                "headroom_batch": round(cap - self._offered(op), 2),
                "mode": "analytic" if cap > 0 else "fallback",
            }
        tenants = {}
        for name, cfg in sorted(self._tenant_cfg.items()):
            bucket = self._buckets.get(name)
            tenants[name] = {
                "rate_rps": float(cfg.get("rate_rps") or 0.0),
                "burst": float(cfg.get("burst") or 0.0),
                "tokens": round(bucket.tokens, 2) if bucket else None,
            }
        return {
            "enabled": self.enabled,
            "tier": self._tier,
            "interactive_burn_5m": round(self._interactive_burn, 3),
            "queue_depth": self._queue_depth,
            "queue_depth_limit": self.queue_depth_limit,
            "interactive_queue_bound": self.interactive_queue_bound,
            "safety_factor": self.safety_factor,
            "admitted": self._admitted,
            "shed": {
                f"{reason}|{klass}": n
                for (reason, klass), n in sorted(self._shed.items())
            },
            "ops": ops,
            "tenants": tenants,
            "slo": self._slo_states,
        }


# ---------------------------------------------------------------------------
# `cordumctl admission` rendering (pure function so tests cover it offline)
# ---------------------------------------------------------------------------

_ADM_COLS = (
    ("op", "op"), ("cap/s", "capacity_per_s"), ("offered", "offered"),
    ("headroom(int)", "headroom_interactive"),
    ("headroom(batch)", "headroom_batch"), ("mode", "mode"),
)


def render_admission_table(doc: dict) -> str:
    """ASCII controller-state table for ``cordumctl admission`` from a
    ``GET /api/v1/admission`` document."""
    head = (
        "cordum admission — {state}, brownout tier {tier}, "
        "interactive burn(5m) {burn}, scheduler backlog {q}/{lim}".format(
            state="enabled" if doc.get("enabled") else "DISABLED",
            tier=doc.get("tier", 0),
            burn=doc.get("interactive_burn_5m", 0.0),
            q=doc.get("queue_depth", 0),
            lim=doc.get("queue_depth_limit", 0),
        )
    )
    shed = doc.get("shed") or {}
    lines = [head]
    if shed:
        lines.append("shed: " + "  ".join(
            f"{k}={v}" for k, v in sorted(shed.items())))
    rows = []
    for op, o in sorted((doc.get("ops") or {}).items()):
        rows.append({
            "op": op,
            "capacity_per_s": f"{o.get('capacity_per_s', 0.0):g}",
            "offered": " ".join(
                f"{k}={v:g}" for k, v in sorted((o.get("offered") or {}).items())
            ) or "-",
            "headroom_interactive": f"{o.get('headroom_interactive', 0.0):g}",
            "headroom_batch": f"{o.get('headroom_batch', 0.0):g}",
            "mode": str(o.get("mode", "")),
        })
    if rows:
        widths = {
            key: max(len(title), *(len(r[key]) for r in rows))
            for title, key in _ADM_COLS
        }
        lines.append("  ".join(t.ljust(widths[k]) for t, k in _ADM_COLS))
        for r in rows:
            lines.append("  ".join(r[k].ljust(widths[k]) for _, k in _ADM_COLS))
    else:
        lines.append("(no offered traffic or capacity rows yet)")
    tenants = doc.get("tenants") or {}
    if tenants:
        lines.append("tenants: " + "  ".join(
            "{n}[rate={r:g} burst={b:g} tokens={t}]".format(
                n=name, r=t.get("rate_rps", 0.0), b=t.get("burst", 0.0),
                t=t.get("tokens") if t.get("tokens") is not None else "-",
            )
            for name, t in sorted(tenants.items())
        ))
    return "\n".join(lines)
