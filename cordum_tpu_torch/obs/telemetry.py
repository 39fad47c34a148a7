"""Telemetry exporter: the fleet telemetry plane's per-process write side.

Every control-plane process embeds a :class:`TelemetryExporter` that
publishes a :class:`~cordum_tpu_torch.protocol.types.TelemetrySnapshot` on
``sys.telemetry.<service>`` every ``interval_s`` seconds: a health beacon
(role, shard/partition index, queue depths, uptime — whatever the hosting
service's ``health_fn`` reports) plus a **delta-encoded** snapshot of the
process's ``Metrics`` registry.  Deltas keep the wire small: only series
whose value changed since the last publish ride each snapshot, with a
periodic ``full=True`` snapshot (every ``full_every`` publishes) so a
late-joining aggregator converges on gauges and quiet series.

Cost discipline: the exporter is a timer, not a hot-path hook — the job
pipeline never calls into it.  Publishes are listener-gated like span
emission (``Bus.has_listener``), so a process with no aggregator attached
skips even the snapshot build.  Publish failures are logged, counted
(``cordum_telemetry_snapshots_dropped_total``) and never raised: telemetry
must not take down the telemetered process.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Awaitable, Callable, Optional

from ..infra import logging as logx
from ..infra.bus import Bus
from ..infra.metrics import Metrics
from ..protocol import subjects as subj
from ..protocol.types import BusPacket, TelemetrySnapshot
from ..utils.ids import now_us

DEFAULT_INTERVAL_S = 2.0
DEFAULT_FULL_EVERY = 15  # one full snapshot per ~30 s at the default cadence

HealthFn = Callable[[], dict[str, Any]]
PublishFn = Callable[[str, BusPacket], Awaitable[None]]

_SeriesKey = tuple[str, tuple[tuple[str, str], ...]]


class TelemetryExporter:
    """Periodic metric-snapshot + health-beacon publisher for one process.

    ``publish`` overrides the bus publish (the statebus server routes its
    beacon to its own subscribers without being a bus client); ``health_fn``
    supplies the role-specific beacon fields.
    """

    def __init__(
        self,
        service: str,
        bus: Optional[Bus],
        metrics: Metrics,
        *,
        instance_id: str = "",
        interval_s: float = DEFAULT_INTERVAL_S,
        health_fn: Optional[HealthFn] = None,
        publish: Optional[PublishFn] = None,
        full_every: int = DEFAULT_FULL_EVERY,
    ) -> None:
        self.service = service
        self.bus = bus
        self.metrics = metrics
        self.instance_id = instance_id or service
        self.interval_s = max(0.05, interval_s)
        self.health_fn = health_fn
        self._publish = publish
        self.full_every = max(1, full_every)
        self.subject = subj.telemetry_subject(service)
        self.started_at_us = now_us()
        self._t0 = time.monotonic()
        self._seq = 0
        # last published value per series: counters/gauges → float,
        # histograms → (tuple(counts), sum, total)
        self._last_counters: dict[_SeriesKey, float] = {}
        self._last_gauges: dict[_SeriesKey, float] = {}
        self._last_hists: dict[_SeriesKey, tuple] = {}
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            await logx.join_task(task, name="telemetry-exporter")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.publish_once()
            except Exception as e:  # noqa: BLE001 - telemetry must not crash the host
                self.metrics.telemetry_dropped.inc(reason="publish_error")
                logx.warn("telemetry publish failed", service=self.service, err=str(e))

    # ------------------------------------------------------------------
    async def publish_once(self) -> bool:
        """Build and publish one snapshot; returns False when skipped
        (nobody listening).  Public so benches/tests can drive the cadence
        themselves."""
        if self._publish is None and (
            self.bus is None or not self.bus.has_listener(self.subject)
        ):
            return False
        snap = self.build_snapshot()
        pkt = BusPacket.wrap(snap, sender_id=self.instance_id)
        if self._publish is not None:
            await self._publish(self.subject, pkt)
        else:
            await self.bus.publish(self.subject, pkt)
        self.metrics.telemetry_snapshots.inc()
        return True

    def build_snapshot(self) -> TelemetrySnapshot:
        """One snapshot of the registry: full every ``full_every`` publishes
        (and on the first), changed-series delta otherwise."""
        full = self._seq % self.full_every == 0
        doc = self.metrics.snapshot()
        counters = self._delta_scalars(doc["counters"], self._last_counters, full)
        gauges = self._delta_scalars(doc["gauges"], self._last_gauges, full)
        hists = self._delta_hists(doc["histograms"], full)
        health = {"uptime_s": round(time.monotonic() - self._t0, 3)}
        if self.health_fn is not None:
            try:
                health.update(self.health_fn())
            except Exception as e:  # noqa: BLE001 - beacon best-effort, never fatal
                logx.warn("telemetry health probe failed",
                          service=self.service, err=str(e))
        snap = TelemetrySnapshot(
            service=self.service,
            instance=self.instance_id,
            seq=self._seq,
            started_at_us=self.started_at_us,
            uptime_s=health["uptime_s"],
            interval_s=self.interval_s,
            full=full,
            health=health,
            metrics={"counters": counters, "gauges": gauges, "histograms": hists},
        )
        self._seq += 1
        return snap

    # ------------------------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict) -> _SeriesKey:
        return (name, tuple(sorted(labels.items())))

    def _delta_scalars(
        self, fams: dict[str, list], last: dict[_SeriesKey, float], full: bool
    ) -> dict[str, list]:
        out: dict[str, list] = {}
        for name, series in fams.items():
            changed = []
            for labels, value in series:
                k = self._key(name, labels)
                if full or last.get(k) != value:
                    last[k] = value
                    changed.append([labels, value])
            if changed:
                out[name] = changed
        return out

    def _delta_hists(self, fams: dict[str, dict], full: bool) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for name, fam in fams.items():
            ex_by_key = {
                self._key(name, labels): exmap
                for labels, exmap in fam.get("exemplars") or []
            }
            changed = []
            changed_ex = []
            for labels, counts, sum_, total in fam["series"]:
                k = self._key(name, labels)
                cur = (tuple(counts), sum_, total)
                if full or self._last_hists.get(k) != cur:
                    self._last_hists[k] = cur
                    changed.append([labels, counts, sum_, total])
                    exmap = ex_by_key.get(k)
                    if exmap:
                        # exemplars ride with their series (same delta
                        # cadence: a bucket only gains an exemplar when an
                        # observation moved the series)
                        changed_ex.append([labels, exmap])
            if changed:
                out[name] = {"buckets": fam["buckets"], "series": changed}
                if changed_ex:
                    out[name]["exemplars"] = changed_ex
        return out
