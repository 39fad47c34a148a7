"""Fleet aggregator: the telemetry plane's read side (gateway-hosted).

Consumes ``sys.telemetry.>`` snapshots from every process and merges them
into fleet-wide series:

* **counters** sum across instances, with Prometheus-style reset handling —
  a process restart (new ``started_at_us`` at the same (service, instance))
  folds the last-seen values into a base so the fleet total keeps the dead
  epoch's contribution and keeps climbing;
* **histograms** bucket-merge (bucket counts, sums and totals add — the
  merged quantile is the quantile of the union stream, at the same bucket
  resolution every process already uses);
* **gauges** keep their instance: summing ``cordum_workers_live`` across
  two scheduler shards that both watch the same heartbeats would double
  count, so gauges are re-labeled ``instance=...`` instead of merged.

Short time-series rings (fine: ~5 min at 2 s; coarse: ~1 h at 30 s) back
the fleet rate and the SLO tracker's multi-window burn rates.  Surfaced as
``/metrics?scope=fleet`` (text exposition), ``GET /api/v1/fleet`` (JSON:
per-service health beacons + fleet rates + stage latencies + SLO states)
and the ``cordumctl top`` table (docs/OBSERVABILITY.md §Fleet telemetry).
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from ..infra import logging as logx
from ..infra.bus import Bus, Subscription
from ..infra.metrics import Metrics, _fmt_labels, _fmt_le, format_exemplar
from ..protocol import subjects as subj
from ..protocol.types import BusPacket, TelemetrySnapshot
from ..utils.ids import now_us

FINE_STEP_S = 2.0
FINE_RETENTION_S = 300.0
COARSE_STEP_S = 30.0
COARSE_RETENTION_S = 3600.0
INSTANCE_EVICT_S = 600.0  # forget an instance silent this long

# metric families the rings/fleet doc read by name
_DISPATCHED = "cordum_jobs_dispatched_total"
_COMPLETED = "cordum_jobs_completed_total"
_BY_CLASS = "cordum_jobs_completed_by_class_total"
_E2E = "cordum_job_e2e_seconds"
_STAGE = "cordum_stage_seconds"
_REPL_LAG = "cordum_statebus_replication_lag_ops"
_SESSIONS = "cordum_serving_active_sessions"
_BATCH_DEPTH = "cordum_batch_queue_depth"
_SPANS_DROPPED = "cordum_spans_dropped_total"

LabelKey = tuple[tuple[str, str], ...]


def quantile_from_buckets(
    buckets: list[float], counts: list[int], total: int, q: float
) -> Optional[float]:
    """Bucket-boundary quantile, the same approximation
    :meth:`Histogram.quantile` uses (counts are cumulative per bucket)."""
    if not total:
        return None
    target = q * total
    for i, c in enumerate(counts):
        if c >= target:
            return buckets[i]
    return buckets[-1] if buckets else None


class _InstanceState:
    """Per-(service, instance) accumulation: last beacon + cumulative metric
    values with a restart-fold base."""

    __slots__ = (
        "service", "instance", "started_at_us", "seq", "interval_s",
        "uptime_s", "health", "last_seen", "counters", "gauges", "hists",
        "hist_buckets", "hist_exemplars", "capacity_rows", "capacity_meta",
    )

    def __init__(self, service: str, instance: str) -> None:
        self.service = service
        self.instance = instance
        self.started_at_us = 0
        self.seq = -1
        self.interval_s = 0.0
        self.uptime_s = 0.0
        self.health: dict[str, Any] = {}
        self.last_seen = 0.0  # monotonic
        # (family, labelkey) → [base, last]; fleet value = base + last
        self.counters: dict[tuple[str, LabelKey], list[float]] = {}
        self.gauges: dict[tuple[str, LabelKey], float] = {}
        # (family, labelkey) → {"base_*": folded, "counts"/"sum"/"total": last}
        self.hists: dict[tuple[str, LabelKey], dict[str, Any]] = {}
        self.hist_buckets: dict[str, list[float]] = {}
        # (family, labelkey) → {bucket_idx(str): [trace_id, value, ts_us]}
        self.hist_exemplars: dict[tuple[str, LabelKey], dict[str, list]] = {}
        # capacity observatory: "op|bucket" → exported profile row,
        # folded from the beacon's delta-encoded `capacity` block.  Rows are
        # cumulative-per-epoch, so a restart clears them (fold_restart) and
        # the fresh epoch's full block repopulates.
        self.capacity_rows: dict[str, dict] = {}
        self.capacity_meta: dict[str, Any] = {}

    def fold_restart(self) -> None:
        """The process restarted: its cumulative series reset to zero.
        Keep the dead epoch's contribution as a base so fleet totals only
        ever climb (counter-reset detection)."""
        for entry in self.counters.values():
            entry[0] += entry[1]
            entry[1] = 0.0
        for h in self.hists.values():
            h["base_counts"] = [
                b + c for b, c in zip(h["base_counts"], h["counts"])
            ]
            h["base_sum"] += h["sum"]
            h["base_total"] += h["total"]
            h["counts"] = [0] * len(h["counts"])
            h["sum"] = 0.0
            h["total"] = 0
        # capacity profiles are rate views of the dead epoch's cumulative
        # device time — a restarted worker starts a fresh profile, so stale
        # rows must not linger in the matrix
        self.capacity_rows.clear()

    def apply(self, snap: TelemetrySnapshot) -> None:
        if self.started_at_us and snap.started_at_us != self.started_at_us:
            self.fold_restart()
        self.started_at_us = snap.started_at_us
        self.seq = snap.seq
        self.interval_s = snap.interval_s
        self.uptime_s = snap.uptime_s
        self.health = dict(snap.health or {})
        self.last_seen = time.monotonic()
        cap = self.health.pop("capacity", None)
        if isinstance(cap, dict):
            self._fold_capacity(cap)
        doc = snap.metrics or {}
        for name, series in (doc.get("counters") or {}).items():
            for labels, value in series:
                k = (name, tuple(sorted(labels.items())))
                entry = self.counters.setdefault(k, [0.0, 0.0])
                entry[1] = float(value)
        for name, series in (doc.get("gauges") or {}).items():
            for labels, value in series:
                self.gauges[(name, tuple(sorted(labels.items())))] = float(value)
        for name, fam in (doc.get("histograms") or {}).items():
            buckets = list(fam.get("buckets") or [])
            self.hist_buckets[name] = buckets
            for labels, counts, sum_, total in fam.get("series") or []:
                k = (name, tuple(sorted(labels.items())))
                h = self.hists.get(k)
                if h is None:
                    h = self.hists[k] = {
                        "base_counts": [0] * len(counts),
                        "base_sum": 0.0, "base_total": 0,
                        "counts": [0] * len(counts), "sum": 0.0, "total": 0,
                    }
                h["counts"] = list(counts)
                h["sum"] = float(sum_)
                h["total"] = int(total)
            for labels, exmap in fam.get("exemplars") or []:
                k = (name, tuple(sorted(labels.items())))
                cur = self.hist_exemplars.setdefault(k, {})
                for idx, ex in (exmap or {}).items():
                    cur[str(idx)] = list(ex)

    def _fold_capacity(self, block: dict) -> None:
        """Fold one beacon `capacity` block: rows carry cumulative values,
        the delta only decides which rows rode this beacon, so folding is a
        plain overwrite (a lost beacon self-heals on the next change)."""
        self.capacity_meta = {
            k: block.get(k)
            for k in ("device_kind", "ts_us", "seq", "kv_pages", "occupancy",
                      "serving_role", "draining", "serving_gang")
            if block.get(k) is not None
        }
        for key, row in (block.get("rows") or {}).items():
            if isinstance(row, dict):
                self.capacity_rows[str(key)] = dict(row)

    def counter_total(self, name: str) -> float:
        return sum(b + l for (n, _), (b, l) in self.counters.items() if n == name)


class FleetAggregator:
    """Merge per-process telemetry snapshots into the fleet view."""

    def __init__(
        self,
        bus: Optional[Bus],
        *,
        metrics: Optional[Metrics] = None,
        fine_step_s: float = FINE_STEP_S,
        coarse_step_s: float = COARSE_STEP_S,
        instance_evict_s: float = INSTANCE_EVICT_S,
    ) -> None:
        self.bus = bus
        self.metrics = metrics
        self.fine_step_s = max(0.05, fine_step_s)
        self.coarse_step_s = max(self.fine_step_s, coarse_step_s)
        self.instance_evict_s = instance_evict_s
        self._instances: dict[tuple[str, str], _InstanceState] = {}
        self._fine: list[dict] = []  # ring of _sample() entries
        self._coarse: list[dict] = []
        self._fine_cap = max(2, int(FINE_RETENTION_S / self.fine_step_s))
        self._coarse_cap = max(2, int(COARSE_RETENTION_S / self.coarse_step_s))
        self._last_coarse = 0.0
        self._sub: Optional[Subscription] = None
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------
    async def start(self) -> None:
        if self.bus is not None:
            self._sub = await self.bus.subscribe(
                subj.TELEMETRY_WILDCARD, self._on_snapshot
            )
        # zero baseline: windows cover everything since aggregator start
        # (after an aggregator restart the first window over-counts the
        # instances' pre-start history, the same artifact a fresh
        # Prometheus rate() has — totals stay exact either way)
        self.sample()
        self._task = asyncio.ensure_future(self._sample_loop())

    async def stop(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
            self._sub = None
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            await logx.join_task(task, name="fleet-aggregator")

    async def _on_snapshot(self, subject: str, pkt: BusPacket) -> None:
        snap = pkt.telemetry
        if snap is None or not snap.service:
            if self.metrics is not None:
                self.metrics.telemetry_dropped.inc(reason="decode_error")
            return
        self.ingest(snap)

    def ingest(self, snap: TelemetrySnapshot) -> None:
        """Apply one snapshot (also the test/bench entry point)."""
        key = (snap.service, snap.instance)
        inst = self._instances.get(key)
        if inst is None:
            inst = self._instances[key] = _InstanceState(snap.service, snap.instance)
        inst.apply(snap)

    # ------------------------------------------------------------------
    # merged views
    # ------------------------------------------------------------------
    def merged_counters(self) -> dict[str, dict[LabelKey, float]]:
        out: dict[str, dict[LabelKey, float]] = {}
        for inst in self._instances.values():
            for (name, lk), (base, last) in inst.counters.items():
                fam = out.setdefault(name, {})
                fam[lk] = fam.get(lk, 0.0) + base + last
        return out

    def merged_histograms(self) -> dict[str, tuple[list[float], dict[LabelKey, dict]]]:
        out: dict[str, tuple[list[float], dict[LabelKey, dict]]] = {}
        for inst in self._instances.values():
            for (name, lk), h in inst.hists.items():
                buckets = inst.hist_buckets.get(name, [])
                fam = out.setdefault(name, (buckets, {}))[1]
                m = fam.get(lk)
                counts = [b + c for b, c in zip(h["base_counts"], h["counts"])]
                if m is None:
                    fam[lk] = {
                        "counts": counts,
                        "sum": h["base_sum"] + h["sum"],
                        "total": h["base_total"] + h["total"],
                    }
                else:
                    m["counts"] = [a + b for a, b in zip(m["counts"], counts)]
                    m["sum"] += h["base_sum"] + h["sum"]
                    m["total"] += h["base_total"] + h["total"]
        return out

    def counter_total(self, name: str) -> float:
        return sum(
            inst.counter_total(name) for inst in self._instances.values()
        )

    def _merged_class_series(self) -> dict[LabelKey, float]:
        return self.merged_counters().get(_BY_CLASS, {})

    # ------------------------------------------------------------------
    # ring sampling (rates + SLO windows)
    # ------------------------------------------------------------------
    async def _sample_loop(self) -> None:
        while True:
            await asyncio.sleep(self.fine_step_s)
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 - sampler must never die silently
                logx.warn("fleet sampler failed", err=str(e))

    def sample(self) -> None:
        """Append one ring entry (also the test/bench entry point)."""
        now = time.monotonic()
        self._evict_stale(now)
        hists = self.merged_histograms()
        e2e = {
            lk: {"counts": list(m["counts"]), "total": m["total"]}
            for lk, m in hists.get(_E2E, (None, {}))[1].items()
        }
        entry = {
            "t": now,
            "dispatched": self.counter_total(_DISPATCHED),
            "completed": self.counter_total(_COMPLETED),
            "by_class": dict(self._merged_class_series()),
            "e2e": e2e,
            "e2e_buckets": hists.get(_E2E, ([], {}))[0],
        }
        self._fine.append(entry)
        if len(self._fine) > self._fine_cap:
            del self._fine[: len(self._fine) - self._fine_cap]
        if now - self._last_coarse >= self.coarse_step_s:
            self._last_coarse = now
            self._coarse.append(entry)
            if len(self._coarse) > self._coarse_cap:
                del self._coarse[: len(self._coarse) - self._coarse_cap]

    def _evict_stale(self, now: float) -> None:
        dead = [
            k for k, inst in self._instances.items()
            if now - inst.last_seen > self.instance_evict_s
        ]
        for k in dead:
            del self._instances[k]
            if self.metrics is not None:
                self.metrics.telemetry_dropped.inc(reason="instance_evicted")

    def _entry_at(self, age_s: float) -> Optional[dict]:
        """Oldest ring entry within ``age_s`` (fine ring first, coarse for
        longer windows); None when the ring is empty."""
        cutoff = time.monotonic() - age_s
        # fine ring first: when it reaches back far enough it wins on
        # resolution; the coarse ring serves the 1 h-class windows
        for ring in (self._fine, self._coarse):
            if ring and ring[0]["t"] <= cutoff:
                # oldest entry NEWER than the cutoff = exactly the window edge
                for entry in ring:
                    if entry["t"] >= cutoff:
                        return entry
        # window exceeds recorded history: use the oldest sample we have
        if self._coarse:
            return self._coarse[0]
        return self._fine[0] if self._fine else None

    def window_delta(self, window_s: float) -> dict:
        """Windowed deltas for rates and SLO burn math: per-class terminal
        counts and per-class e2e histogram deltas over (up to) ``window_s``
        seconds.  ``span_s`` reports the actual history covered."""
        base = self._entry_at(window_s)
        now_entry = {
            "t": time.monotonic(),
            "dispatched": self.counter_total(_DISPATCHED),
            "completed": self.counter_total(_COMPLETED),
            "by_class": dict(self._merged_class_series()),
            "e2e": {
                lk: {"counts": list(m["counts"]), "total": m["total"]}
                for lk, m in self.merged_histograms().get(_E2E, (None, {}))[1].items()
            },
        }
        if base is None:
            base = {"t": now_entry["t"], "dispatched": 0.0, "completed": 0.0,
                    "by_class": {}, "e2e": {}}
            span = 0.0
        else:
            span = max(0.0, now_entry["t"] - base["t"])
        by_class = {
            lk: max(0.0, v - base["by_class"].get(lk, 0.0))
            for lk, v in now_entry["by_class"].items()
        }
        e2e = {}
        for lk, cur in now_entry["e2e"].items():
            prev = base["e2e"].get(lk, {"counts": [0] * len(cur["counts"]), "total": 0})
            e2e[lk] = {
                "counts": [
                    max(0, a - b) for a, b in zip(cur["counts"], prev["counts"])
                ],
                "total": max(0, cur["total"] - prev["total"]),
            }
        return {
            "span_s": span,
            "dispatched": max(0.0, now_entry["dispatched"] - base["dispatched"]),
            "completed": max(0.0, now_entry["completed"] - base["completed"]),
            "by_class": by_class,
            "e2e": e2e,
            "e2e_buckets": self.merged_histograms().get(_E2E, ([], {}))[0],
        }

    # ------------------------------------------------------------------
    # surfaces
    # ------------------------------------------------------------------
    def _healthy(self, inst: _InstanceState, now: float) -> bool:
        ttl = max(6.0, 3.0 * (inst.interval_s or FINE_STEP_S))
        return now - inst.last_seen <= ttl

    def services(self) -> list[dict]:
        now = time.monotonic()
        out = []
        for inst in sorted(
            self._instances.values(), key=lambda i: (i.service, i.instance)
        ):
            doc = {
                "service": inst.service,
                "instance": inst.instance,
                "healthy": self._healthy(inst, now),
                "age_s": round(now - inst.last_seen, 2),
                "uptime_s": round(inst.uptime_s, 1),
                "seq": inst.seq,
                "interval_s": inst.interval_s,
            }
            doc.update(inst.health)
            out.append(doc)
        return out

    def fleet_doc(self, slo_tracker: Any = None) -> dict:
        """The ``GET /api/v1/fleet`` document."""
        services = self.services()
        counts: dict[str, int] = {}
        for s in services:
            if s["healthy"]:
                counts[s["service"]] = counts.get(s["service"], 0) + 1
        hists = self.merged_histograms()
        stage_p50: dict[str, float] = {}
        stage_p99: dict[str, float] = {}
        stage = hists.get(_STAGE)
        if stage is not None:
            buckets, fams = stage
            merged_by_stage: dict[str, dict] = {}
            for lk, m in fams.items():
                name = dict(lk).get("stage", "")
                agg = merged_by_stage.get(name)
                if agg is None:
                    merged_by_stage[name] = {
                        "counts": list(m["counts"]), "total": m["total"]
                    }
                else:
                    agg["counts"] = [
                        a + b for a, b in zip(agg["counts"], m["counts"])
                    ]
                    agg["total"] += m["total"]
            for name, m in merged_by_stage.items():
                p50 = quantile_from_buckets(buckets, m["counts"], m["total"], 0.50)
                p99 = quantile_from_buckets(buckets, m["counts"], m["total"], 0.99)
                if p50 is not None:
                    stage_p50[name] = round(p50 * 1000, 3)
                if p99 is not None:
                    stage_p99[name] = round(p99 * 1000, 3)
        gauges = self._gauge_rollup()
        rate = self.window_delta(60.0)
        rate_5m = self.window_delta(300.0)
        doc = {
            "ts_us": now_us(),
            "services": services,
            "counts": counts,
            "healthy_services": sum(counts.values()),
            "fleet": {
                "jobs_dispatched_total": self.counter_total(_DISPATCHED),
                "jobs_completed_total": self.counter_total(_COMPLETED),
                "scheduled_per_s": round(
                    rate["dispatched"] / rate["span_s"], 2
                ) if rate["span_s"] else 0.0,
                "completed_per_s": round(
                    rate["completed"] / rate["span_s"], 2
                ) if rate["span_s"] else 0.0,
                "completed_5m": rate_5m["completed"],
                "rate_window_s": round(rate["span_s"], 1),
                "stage_p50_ms": stage_p50,
                "stage_p99_ms": stage_p99,
                "replication_lag_ops": gauges["repl_lag"],
                "serving_active_sessions": gauges["sessions"],
                "batch_queue_depth": gauges["batch_depth"],
                "spans_dropped_total": self.counter_total(_SPANS_DROPPED),
            },
        }
        if slo_tracker is not None:
            doc["slo"] = slo_tracker.evaluate(self)
        return doc

    def capacity_doc(self) -> dict:
        """``GET /api/v1/capacity`` — the op × worker throughput matrix
        folded from the workers' beacon ``capacity`` blocks.

        Staleness handling: a row from an instance whose beacon is overdue
        (the same ``healthy`` bound the fleet doc uses) is marked
        ``stale: true`` and excluded from the per-op totals; an instance
        silent past ``instance_evict_s`` is dropped entirely by the sampler.
        This is the read-only input the heterogeneity-aware scheduling
        strategy (ROADMAP item 2) consumes."""
        now = time.monotonic()
        workers: dict[str, dict] = {}
        matrix: list[dict] = []
        ops: dict[str, float] = {}
        for inst in sorted(self._instances.values(),
                           key=lambda i: (i.service, i.instance)):
            if not inst.capacity_rows:
                continue
            fresh = self._healthy(inst, now)
            age = round(now - inst.last_seen, 2)
            meta = inst.capacity_meta
            wdoc: dict[str, Any] = {
                "service": inst.service,
                "device_kind": meta.get("device_kind", ""),
                "fresh": fresh,
                "age_s": age,
                "rows": len(inst.capacity_rows),
            }
            for extra in ("kv_pages", "occupancy", "serving_role", "draining",
                          "serving_gang"):
                if meta.get(extra) is not None:
                    wdoc[extra] = meta[extra]
            workers[inst.instance] = wdoc
            for key in sorted(inst.capacity_rows):
                row = dict(inst.capacity_rows[key])
                row["worker"] = inst.instance
                row["device_kind"] = meta.get("device_kind", "")
                row["stale"] = not fresh
                row["age_s"] = age
                matrix.append(row)
                if fresh:
                    op = str(row.get("op", ""))
                    ops[op] = ops.get(op, 0.0) + float(row.get("items_per_s", 0.0))
        # serving gangs fuse to ONE row per gang (docs/SERVING.md §Sharded
        # serving): rank 0's measured step throughput is the gang's — every
        # rank advances in lock-step — and page headroom is min-of-ranks.
        # Folded over ALL worker instances (a member with no profile rows
        # yet still beacons its membership).
        gangs: dict[str, dict] = {}
        for inst in self._instances.values():
            sg = inst.capacity_meta.get("serving_gang")
            if not isinstance(sg, dict) or not self._healthy(inst, now):
                continue
            gid = str(sg.get("gang_id", "") or "")
            if not gid:
                continue
            g = gangs.setdefault(gid, {
                "gang_id": gid, "size": int(sg.get("size", 0) or 0),
                "leader": "", "members": {}, "tokens_per_s": 0.0,
                "pages_free_min": None, "pages_total_min": None,
            })
            try:
                rank = int(sg.get("rank", -1))
            except (TypeError, ValueError):
                rank = -1
            g["members"][inst.instance] = rank
            if rank == 0:
                g["leader"] = inst.instance
                g["tokens_per_s"] = float(sg.get("tokens_per_s", 0.0) or 0.0)
            for src, dst in (("pages_free", "pages_free_min"),
                             ("pages_total", "pages_total_min")):
                v = sg.get(src)
                if isinstance(v, (int, float)):
                    g[dst] = v if g[dst] is None else min(g[dst], v)
        return {
            "ts_us": now_us(),
            "workers": workers,
            "matrix": matrix,
            "ops": {op: round(v, 2) for op, v in sorted(ops.items())},
            "serving_gangs": [gangs[k] for k in sorted(gangs)],
        }

    def gangs_doc(self) -> dict:
        """``GET /api/v1/gangs`` — the live gang table (docs/GANG.md),
        merged from every scheduler shard's health beacon (each shard
        beacons the gangs it owns, so the union is the fleet view)."""
        now = time.monotonic()
        gangs: list[dict] = []
        queue_depth = 0
        shards = 0
        for inst in sorted(self._instances.values(),
                           key=lambda i: (i.service, i.instance)):
            if inst.service != "scheduler":
                continue
            rows = inst.health.get("gangs")
            if rows is None:
                continue
            shards += 1
            fresh = self._healthy(inst, now)
            for g in rows:
                doc = dict(g)
                doc["shard"] = inst.instance
                doc["stale"] = not fresh
                gangs.append(doc)
            try:
                queue_depth += int(inst.health.get("gang_queue_depth", 0) or 0)
            except (TypeError, ValueError):
                pass
        return {
            "ts_us": now_us(),
            "gangs": gangs,
            "queue_depth": queue_depth,
            "scheduler_shards": shards,
        }

    def _merged_exemplars(
        self, name: str, lk: LabelKey
    ) -> dict[int, tuple[str, float, int]]:
        """Freshest exemplar per bucket across instances for one merged
        histogram series (exemplars don't merge — the newest wins)."""
        best: dict[int, tuple[str, float, int]] = {}
        for inst in self._instances.values():
            for idx, ex in (inst.hist_exemplars.get((name, lk)) or {}).items():
                try:
                    i = int(idx)
                    tid, value, ts = str(ex[0]), float(ex[1]), int(ex[2])
                except (TypeError, ValueError, IndexError):
                    continue
                if i not in best or ts > best[i][2]:
                    best[i] = (tid, value, ts)
        return best

    def _gauge_rollup(self) -> dict:
        repl_lag = 0.0
        sessions = 0.0
        batch_depth = 0.0
        for inst in self._instances.values():
            for (name, _), v in inst.gauges.items():
                if name == _REPL_LAG:
                    repl_lag = max(repl_lag, v)
                elif name == _SESSIONS:
                    sessions += v
                elif name == _BATCH_DEPTH:
                    batch_depth += v
        return {"repl_lag": repl_lag, "sessions": sessions,
                "batch_depth": batch_depth}

    def render(self) -> str:
        """Fleet-scope Prometheus exposition (``/metrics?scope=fleet``):
        counters and histograms merged across instances, gauges re-labeled
        per instance, plus a ``cordum_fleet_instances`` health gauge."""
        lines: list[str] = []
        for name, fam in sorted(self.merged_counters().items()):
            lines.append(f"# TYPE {name} counter")
            for lk, v in sorted(fam.items()):
                lines.append(f"{name}{_fmt_labels(dict(lk))} {v}")
        # gauges: one series per instance (summing would double count)
        gauge_lines: dict[str, list[str]] = {}
        for inst in self._instances.values():
            for (name, lk), v in inst.gauges.items():
                labels = dict(lk)
                labels["instance"] = inst.instance
                gauge_lines.setdefault(name, []).append(
                    f"{name}{_fmt_labels(labels)} {v}"
                )
        for name in sorted(gauge_lines):
            lines.append(f"# TYPE {name} gauge")
            lines.extend(sorted(gauge_lines[name]))
        for name, (buckets, fams) in sorted(self.merged_histograms().items()):
            lines.append(f"# TYPE {name} histogram")
            for lk, m in sorted(fams.items()):
                labels = dict(lk)
                exs = self._merged_exemplars(name, lk)
                for i, b in enumerate(buckets):
                    bl = dict(labels)
                    bl["le"] = _fmt_le(b)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(bl)} {m['counts'][i]}"
                        + format_exemplar(exs.get(i))
                    )
                bl = dict(labels)
                bl["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{_fmt_labels(bl)} {m['total']}"
                    + format_exemplar(exs.get(len(buckets)))
                )
                lines.append(f"{name}_sum{_fmt_labels(labels)} {m['sum']}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {m['total']}")
        # capacity observatory: the throughput matrix as fleet gauges, fresh
        # rows only (GET /api/v1/capacity carries the stale-flagged view)
        cap = self.capacity_doc()
        cap_rows = [r for r in cap["matrix"] if not r.get("stale")]
        if cap_rows:
            lines.append("# TYPE cordum_capacity_items_per_sec gauge")
            for r in cap_rows:
                lines.append(
                    "cordum_capacity_items_per_sec"
                    f"{_fmt_labels({'op': str(r.get('op', '')), 'bucket': str(r.get('bucket', '')), 'worker': str(r.get('worker', ''))})}"
                    f" {r.get('items_per_s', 0.0)}"
                )
            tok_rows = [r for r in cap_rows if float(r.get("tokens_per_s", 0.0)) > 0]
            if tok_rows:
                lines.append("# TYPE cordum_capacity_tokens_per_sec gauge")
                for r in tok_rows:
                    lines.append(
                        "cordum_capacity_tokens_per_sec"
                        f"{_fmt_labels({'op': str(r.get('op', '')), 'bucket': str(r.get('bucket', '')), 'worker': str(r.get('worker', ''))})}"
                        f" {r.get('tokens_per_s', 0.0)}"
                    )
        now = time.monotonic()
        lines.append("# TYPE cordum_fleet_instances gauge")
        per_service: dict[str, int] = {}
        for inst in self._instances.values():
            if self._healthy(inst, now):
                per_service[inst.service] = per_service.get(inst.service, 0) + 1
        for service, n in sorted(per_service.items()):
            lines.append(
                f"cordum_fleet_instances{_fmt_labels({'service': service})} {n}"
            )
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# `cordumctl top` rendering (pure function so tests cover it offline)
# ---------------------------------------------------------------------------

_TOP_COLS = (
    ("service", "service"), ("instance", "instance"), ("role", "role"),
    ("shard", "shard"), ("part", "partition"), ("epoch", "epoch"),
    ("lag", "lag_ops"), ("queue", "queue_depth"), ("jobs", "jobs_scheduled"),
    ("up(s)", "uptime_s"), ("ok", "healthy"),
)


def render_fleet_table(doc: dict) -> str:
    """ASCII fleet table for ``cordumctl top`` from a /api/v1/fleet doc."""
    fleet = doc.get("fleet") or {}
    rows = []
    for s in doc.get("services") or []:
        shard = s.get("shard_index")
        if shard is not None and s.get("shard_count"):
            shard = f"{shard}/{s['shard_count']}"
        rows.append({
            "service": s.get("service", ""),
            "instance": s.get("instance", ""),
            "role": s.get("role", ""),
            "shard": "" if shard is None else str(shard),
            "partition": _cell(s.get("partition")),
            "epoch": _cell(s.get("epoch")),
            "lag_ops": _cell(s.get("lag_ops")),
            "queue_depth": _cell(s.get("queue_depth")),
            "jobs_scheduled": _cell(s.get("jobs_scheduled")),
            "uptime_s": f"{s.get('uptime_s', 0):.0f}",
            "healthy": "yes" if s.get("healthy") else "NO",
        })
    widths = {
        key: max(len(title), *(len(r[key]) for r in rows)) if rows else len(title)
        for title, key in _TOP_COLS
    }
    out = [
        "cordum fleet — {n} healthy instance(s), {r} scheduled/s, "
        "{c} completed/s (window {w}s)".format(
            n=doc.get("healthy_services", 0),
            r=fleet.get("scheduled_per_s", 0.0),
            c=fleet.get("completed_per_s", 0.0),
            w=fleet.get("rate_window_s", 0.0),
        ),
    ]
    stage = fleet.get("stage_p50_ms") or {}
    if stage:
        p99 = fleet.get("stage_p99_ms") or {}
        out.append("stages p50/p99 ms: " + "  ".join(
            f"{k}={v}/{p99.get(k, '-')}" for k, v in sorted(stage.items())
        ))
    for state in doc.get("slo") or []:
        w = state.get("windows") or {}
        out.append(
            "slo {name} [{klass}] state={st} burn 5m={b5} 1h={b1}".format(
                name=state.get("name"), klass=state.get("job_class"),
                st=state.get("state"),
                b5=(w.get("5m") or {}).get("burn_rate", 0.0),
                b1=(w.get("1h") or {}).get("burn_rate", 0.0),
            )
        )
    out.append("  ".join(t.ljust(widths[k]) for t, k in _TOP_COLS))
    for r in rows:
        out.append("  ".join(r[k].ljust(widths[k]) for _, k in _TOP_COLS))
    return "\n".join(out)


def _cell(v: Any) -> str:
    return "" if v is None else str(v)
