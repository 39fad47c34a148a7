"""Runtime profiler: per-process event-loop lag, slow-tick stack dumps, and
GC-pause accounting — the "why is this process slow" leg of the fleet
telemetry plane (docs/OBSERVABILITY.md §Fleet telemetry).

Three probes, all off the hot path:

* **event-loop lag sampler** — an ``asyncio.sleep(tick)`` loop measures how
  late the loop woke it; the excess is scheduling lag (a blocking call, a
  long callback, CPU starvation) and feeds the
  ``cordum_eventloop_lag_seconds`` histogram;
* **slow-tick detector** — when one tick's lag exceeds ``slow_tick_s`` the
  profiler dumps every live task's stack (newest frames) with the last
  active trace/span id to the log, increments ``cordum_slow_ticks_total``
  and keeps the dump on ``last_slow_tick`` so the telemetry beacon can ship
  a summary.  The trace id names the request the process was most recently
  working for when it stalled;
* **GC-pause counters** — ``gc.callbacks`` timing each collection into
  ``cordum_gc_pauses_total{generation}`` and ``cordum_gc_pause_seconds``
  (a generation-2 pause IS event-loop lag; correlating the two histograms
  separates GC stalls from blocking code).

Everything flows through the process's ``Metrics`` registry, so the
exporter ships it fleet-wide for free.
"""
from __future__ import annotations

import asyncio
import gc
import time
import traceback
from typing import Any, Optional

from ..infra import logging as logx
from ..infra.metrics import Metrics
from .tracer import last_active_context

DEFAULT_TICK_S = 0.25
DEFAULT_SLOW_TICK_S = 0.5
MAX_DUMP_TASKS = 12
MAX_DUMP_FRAMES = 6


class RuntimeProfiler:
    def __init__(
        self,
        metrics: Metrics,
        *,
        service: str = "",
        tick_s: float = DEFAULT_TICK_S,
        slow_tick_s: float = DEFAULT_SLOW_TICK_S,
    ) -> None:
        self.metrics = metrics
        self.service = service
        self.tick_s = max(0.01, tick_s)
        self.slow_tick_s = slow_tick_s
        self.last_slow_tick: Optional[dict[str, Any]] = None
        self._task: Optional[asyncio.Task] = None
        self._gc_start: dict[int, float] = {}
        self._gc_cb_installed = False

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())
        if not self._gc_cb_installed:
            gc.callbacks.append(self._on_gc)
            self._gc_cb_installed = True

    async def stop(self) -> None:
        if self._gc_cb_installed:
            try:
                gc.callbacks.remove(self._on_gc)
            except ValueError:
                logx.warn("gc callback already removed", service=self.service)
            self._gc_cb_installed = False
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            await logx.join_task(task, name="runtime-profiler")

    # ------------------------------------------------------------------
    async def _loop(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.tick_s)
            lag = max(0.0, time.monotonic() - t0 - self.tick_s)
            self.metrics.eventloop_lag.observe(lag)
            if lag >= self.slow_tick_s:
                try:
                    self._dump_slow_tick(lag)
                except Exception as e:  # noqa: BLE001 - diagnostics must not crash the host
                    logx.warn("slow-tick dump failed", err=str(e))

    def _dump_slow_tick(self, lag_s: float) -> None:
        """The loop just stalled for ``lag_s``: record who was running."""
        self.metrics.slow_ticks.inc()
        trace_id, span_id = last_active_context()
        tasks = []
        current = asyncio.current_task()
        for task in asyncio.all_tasks():
            if task is current or task.done():
                continue
            frames = task.get_stack(limit=MAX_DUMP_FRAMES)
            if not frames:
                continue
            stack = "".join(
                traceback.format_stack(f, limit=1)[0] for f in frames
            ).rstrip()
            tasks.append({"task": task.get_name(), "stack": stack})
            if len(tasks) >= MAX_DUMP_TASKS:
                break
        self.last_slow_tick = {
            "at_monotonic": time.monotonic(),
            "lag_s": round(lag_s, 4),
            "trace_id": trace_id,
            "span_id": span_id,
            "tasks": [t["task"] for t in tasks],
        }
        logx.warn(
            "slow event-loop tick",
            service=self.service,
            lag_s=round(lag_s, 4),
            trace_id=trace_id or "-",
            span_id=span_id or "-",
            tasks=len(tasks),
        )
        for t in tasks:
            logx.warn("slow-tick task stack", task=t["task"], stack=t["stack"])

    # ------------------------------------------------------------------
    def _on_gc(self, phase: str, info: dict) -> None:
        gen = int(info.get("generation", 0))
        if phase == "start":
            self._gc_start[gen] = time.monotonic()
        elif phase == "stop":
            t0 = self._gc_start.pop(gen, None)
            if t0 is not None:
                dur = time.monotonic() - t0
                self.metrics.gc_pauses.inc(generation=str(gen))
                self.metrics.gc_pause_seconds.observe(dur)

    # ------------------------------------------------------------------
    def health(self) -> dict[str, Any]:
        """Beacon fields the telemetry exporter ships (slow-tick summary)."""
        out: dict[str, Any] = {}
        if self.last_slow_tick is not None:
            out["last_slow_tick_lag_s"] = self.last_slow_tick["lag_s"]
            out["last_slow_tick_trace"] = self.last_slow_tick["trace_id"]
        return out
