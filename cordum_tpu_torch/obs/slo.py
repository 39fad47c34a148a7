"""SLO tracker: multi-window burn rates over the fleet-aggregated series.

Objectives come from the ``slo:`` stanza in pools.yaml (docs/OBSERVABILITY.md
§Fleet telemetry)::

    slo:
      interactive:
        job_class: INTERACTIVE     # JobRequest.priority this objective covers
        latency_ms: 500            # latency objective threshold
        latency_target: 0.99       # fraction of jobs that must finish under it
        availability_target: 0.999 # fraction that must not FAIL/TIMEOUT (0=off)

The tracker evaluates each objective over two windows (5 m from the fine
ring, 1 h from the coarse ring) of the aggregator's merged
``cordum_job_e2e_seconds{job_class}`` histogram and
``cordum_jobs_completed_by_class_total{job_class,status}`` counter:

    error_fraction = bad / total            (per window)
    burn_rate      = error_fraction / (1 - target)

``burn_rate == 1.0`` means the error budget is being spent exactly at the
rate that exhausts it by the end of the SLO period; the classic
multi-window alert fires when BOTH the fast and slow windows burn hot
(fast-only = a blip, slow-only = stale damage already done).  States:
``page`` (5 m ≥ 14.4 AND 1 h ≥ 6 — the Google SRE workbook's 1h/5m page
pair), ``warn`` (either window ≥ 1.0), ``ok`` otherwise.  Latency is
bucket-quantized: the threshold snaps UP to the enclosing histogram bucket,
so a 250 ms objective is measured at the 250 ms bucket boundary.

Burn rates surface as ``cordum_slo_burn_rate{slo,window}`` gauges and in
``GET /api/v1/fleet``'s ``slo`` section — the measurement substrate the
ROADMAP item-2 admission controller will act on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..infra.metrics import Metrics

WINDOWS = (("5m", 300.0), ("1h", 3600.0))
PAGE_FAST_BURN = 14.4  # 5 m window
PAGE_SLOW_BURN = 6.0  # 1 h window
_BAD_STATUSES = ("FAILED", "TIMEOUT")


@dataclass
class SLOObjective:
    name: str
    job_class: str = "BATCH"
    latency_ms: float = 1000.0
    latency_target: float = 0.99
    availability_target: float = 0.0  # 0 disables the availability objective

    @classmethod
    def from_doc(cls, name: str, doc: dict) -> "SLOObjective":
        return cls(
            name=name,
            job_class=str(doc.get("job_class", "BATCH")),
            latency_ms=float(doc.get("latency_ms", 1000.0)),
            latency_target=float(doc.get("latency_target", 0.99)),
            availability_target=float(doc.get("availability_target", 0.0)),
        )


class SLOTracker:
    def __init__(
        self, objectives: list[SLOObjective], *, metrics: Optional[Metrics] = None
    ) -> None:
        self.objectives = objectives
        self.metrics = metrics

    @classmethod
    def from_config(
        cls, slo_doc: dict, *, metrics: Optional[Metrics] = None
    ) -> "SLOTracker":
        """From the parsed pools.yaml ``slo:`` stanza (name → objective doc)."""
        return cls(
            [SLOObjective.from_doc(name, doc or {})
             for name, doc in sorted((slo_doc or {}).items())],
            metrics=metrics,
        )

    # ------------------------------------------------------------------
    def evaluate(self, aggregator) -> list[dict]:
        """Burn rates per objective per window from the aggregator's rings;
        sets the ``cordum_slo_burn_rate`` gauges as a side effect."""
        out = []
        deltas = {label: aggregator.window_delta(w_s) for label, w_s in WINDOWS}
        for obj in self.objectives:
            windows = {}
            for label, _ in WINDOWS:
                windows[label] = self._window_state(obj, deltas[label])
                if self.metrics is not None:
                    self.metrics.slo_burn_rate.set(
                        windows[label]["burn_rate"], slo=obj.name, window=label
                    )
            burn_fast = windows["5m"]["burn_rate"]
            burn_slow = windows["1h"]["burn_rate"]
            if burn_fast >= PAGE_FAST_BURN and burn_slow >= PAGE_SLOW_BURN:
                state = "page"
            elif burn_fast >= 1.0 or burn_slow >= 1.0:
                state = "warn"
            else:
                state = "ok"
            out.append({
                "name": obj.name,
                "job_class": obj.job_class,
                "latency_ms": obj.latency_ms,
                "latency_target": obj.latency_target,
                "availability_target": obj.availability_target,
                "windows": windows,
                "state": state,
            })
        return out

    # ------------------------------------------------------------------
    def _window_state(self, obj: SLOObjective, delta: dict) -> dict:
        lat_frac, lat_total = self._latency_error_fraction(obj, delta)
        avail_frac, avail_total = self._availability_error_fraction(obj, delta)
        lat_burn = _burn(lat_frac, obj.latency_target)
        avail_burn = (
            _burn(avail_frac, obj.availability_target)
            if obj.availability_target else 0.0
        )
        return {
            "span_s": round(delta["span_s"], 1),
            "total": lat_total,
            "latency_error_fraction": round(lat_frac, 6),
            "latency_burn_rate": round(lat_burn, 3),
            "availability_error_fraction": round(avail_frac, 6),
            "availability_burn_rate": round(avail_burn, 3),
            "availability_total": avail_total,
            "burn_rate": round(max(lat_burn, avail_burn), 3),
        }

    def _latency_error_fraction(
        self, obj: SLOObjective, delta: dict
    ) -> tuple[float, int]:
        buckets = delta.get("e2e_buckets") or []
        threshold_s = obj.latency_ms / 1000.0
        idx = None
        for i, b in enumerate(buckets):
            if b >= threshold_s - 1e-12:
                idx = i
                break
        total = 0
        good = 0
        for lk, series in (delta.get("e2e") or {}).items():
            if dict(lk).get("job_class", "") != obj.job_class:
                continue
            total += series["total"]
            if idx is not None:
                good += series["counts"][idx]
            # threshold above the last bucket: every bucketed observation is
            # good only up to +Inf resolution — count the whole total as good
            else:
                good += series["total"]
        if not total:
            return 0.0, 0
        return max(0.0, (total - good) / total), total

    def _availability_error_fraction(
        self, obj: SLOObjective, delta: dict
    ) -> tuple[float, int]:
        total = 0.0
        bad = 0.0
        for lk, v in (delta.get("by_class") or {}).items():
            labels = dict(lk)
            if labels.get("job_class", "") != obj.job_class:
                continue
            total += v
            if labels.get("status", "") in _BAD_STATUSES:
                bad += v
        if not total:
            return 0.0, 0
        return bad / total, int(total)


def _burn(error_fraction: float, target: float) -> float:
    budget = max(1e-9, 1.0 - target)
    return error_fraction / budget
