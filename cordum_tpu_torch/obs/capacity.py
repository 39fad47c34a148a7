"""Capacity observatory — the worker-side device profiler.

A :class:`CapacityProfiler` turns the worker's ``device_timer`` records,
micro-batch flushes and serving decode steps into online per-(op, bucket)
performance profiles:

* device-time EWMA + a log-spaced millisecond histogram (p50/p99),
* a compile-vs-steady split from the ``compile_cached`` device attr (the
  first call of a new shape is set-up, not capacity — steady-state rates
  exclude it),
* delivered **items/s** and decode **tokens/s** over steady device time,
* decode-batch occupancy and KV-page/arena headroom via callbacks read at
  snapshot time.

The profiler publishes a compact, **delta-encoded** ``capacity`` block in
the worker's telemetry beacon (``Worker.telemetry_health``): rows carry
*cumulative* values, and the delta only decides which rows ride each beacon
(rows whose observation count moved, plus a periodic full block), so a lost
beacon self-heals on the next change.  The control plane's fleet aggregator
and scheduler fold these blocks; they live with the control plane, not in
this package.

A worker serving in a tensor-parallel gang adds a ``serving_gang`` block
(:func:`serving_gang_block`) while the gang lives and drops it when the gang
ends; the scheduler's ``CapacityView`` folds the ranks' blocks into one row
per gang (the leader's tokens/s, the smallest page headroom of any rank) and
routes new sessions to leaders only.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..utils.ids import now_us

# log-spaced device-time buckets in MILLISECONDS (device work spans ~0.1 ms
# cached dispatches to multi-second compiles)
DEVICE_MS_BUCKETS = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)
DEFAULT_EWMA_ALPHA = 0.2
DEFAULT_FULL_EVERY = 15  # full block every N beacons (~30 s at 2 s cadence)
MAX_ROWS = 256  # (op, bucket) rows per worker; overflow folds into one row

GaugeFn = Callable[[], dict]


def _quantile_ms(buckets: tuple, counts: list, total: int, q: float) -> float:
    """Bucket-boundary quantile over cumulative counts (the same
    approximation infra.metrics.Histogram.quantile uses)."""
    if not total:
        return 0.0
    target = q * total
    for i, c in enumerate(counts):
        if c >= target:
            return float(buckets[i])
    return float(buckets[-1])


class CapacityProfiler:
    """Online per-(op, bucket) device-throughput profiles for one worker.

    ``observe()`` is called from the worker's event loop (job completion,
    micro-batch flush, serving decode step); ``snapshot()`` from the
    telemetry exporter's beacon timer.  A lock keeps the two honest if a
    handler ever observes from an executor thread.
    """

    def __init__(
        self,
        device_kind: str = "",
        *,
        ewma_alpha: float = DEFAULT_EWMA_ALPHA,
        full_every: int = DEFAULT_FULL_EVERY,
        buckets: tuple = DEVICE_MS_BUCKETS,
        max_rows: int = MAX_ROWS,
    ) -> None:
        self.device_kind = device_kind or "cpu"
        self.ewma_alpha = ewma_alpha
        self.full_every = max(1, full_every)
        self.buckets = buckets
        self.max_rows = max(1, max_rows)
        self._rows: dict[str, dict] = {}
        self._last_n: dict[str, int] = {}  # published n per row (delta state)
        self._seq = 0
        self._lock = threading.Lock()
        self._kv_headroom_fn: Optional[GaugeFn] = None
        self._occupancy_fn: Optional[GaugeFn] = None

    # ------------------------------------------------------------------
    def set_kv_headroom(self, fn: GaugeFn) -> None:
        """Callback returning ``{"pages_total": N, "pages_free": M}`` —
        read at snapshot time (the serving engine's page arena)."""
        self._kv_headroom_fn = fn

    def set_occupancy(self, fn: GaugeFn) -> None:
        """Callback returning occupancy gauges (e.g. the serving engine's
        mean/max decode-batch occupancy) — read at snapshot time."""
        self._occupancy_fn = fn

    # ------------------------------------------------------------------
    def observe(
        self,
        op: str,
        *,
        device_s: float,
        bucket: str = "-",
        items: int = 1,
        tokens: int = 0,
        compiled: bool = False,
    ) -> None:
        """Record one unit of device work for ``(op, bucket)``.

        ``compiled=True`` marks a call that paid first-shape set-up (the
        ``compile_cached="false"`` device attr): it counts toward the
        compile split and is excluded from steady-state items/s."""
        if not op or device_s < 0:
            return
        ms = device_s * 1000.0
        key = f"{op}|{bucket}"
        with self._lock:
            r = self._rows.get(key)
            if r is None:
                if len(self._rows) >= self.max_rows:
                    key = "overflow|-"
                    op, bucket = "overflow", "-"
                    r = self._rows.get(key)
                if r is None:
                    r = self._rows[key] = {
                        "op": op, "bucket": str(bucket),
                        "n": 0, "items": 0, "tokens": 0,
                        "device_s": 0.0, "ewma_ms": 0.0,
                        "compile_n": 0, "compile_s": 0.0,
                        "steady_s": 0.0, "steady_items": 0, "steady_tokens": 0,
                        "hist": [0] * len(self.buckets),
                        "last_us": 0,
                    }
            r["n"] += 1
            r["items"] += max(0, items)
            r["tokens"] += max(0, tokens)
            r["device_s"] += device_s
            a = self.ewma_alpha
            r["ewma_ms"] = ms if r["n"] == 1 else a * ms + (1 - a) * r["ewma_ms"]
            for i, b in enumerate(self.buckets):  # cumulative, Histogram-style
                if ms <= b:
                    r["hist"][i] += 1
            if compiled:
                r["compile_n"] += 1
                r["compile_s"] += device_s
            else:
                r["steady_s"] += device_s
                r["steady_items"] += max(0, items)
                r["steady_tokens"] += max(0, tokens)
            r["last_us"] = now_us()

    # ------------------------------------------------------------------
    def _export_row(self, r: dict) -> dict:
        steady_s = r["steady_s"]
        if steady_s > 0:
            items_per_s = r["steady_items"] / steady_s
            tokens_per_s = r["steady_tokens"] / steady_s
        elif r["device_s"] > 0:  # everything compiled so far: best effort
            items_per_s = r["items"] / r["device_s"]
            tokens_per_s = r["tokens"] / r["device_s"]
        else:
            items_per_s = tokens_per_s = 0.0
        return {
            "op": r["op"], "bucket": r["bucket"],
            "n": r["n"], "items": r["items"], "tokens": r["tokens"],
            "device_s": round(r["device_s"], 6),
            "ewma_ms": round(r["ewma_ms"], 4),
            "compile_n": r["compile_n"],
            "compile_s": round(r["compile_s"], 6),
            "items_per_s": round(items_per_s, 3),
            "tokens_per_s": round(tokens_per_s, 3),
            "p50_ms": _quantile_ms(self.buckets, r["hist"], r["n"], 0.50),
            "p99_ms": _quantile_ms(self.buckets, r["hist"], r["n"], 0.99),
            "last_us": r["last_us"],
        }

    def snapshot(self, full: Optional[bool] = None) -> dict:
        """The beacon ``capacity`` block: delta-encoded (rows whose count
        moved since the last snapshot), with a periodic full block so a
        late-joining aggregator converges.  Rows carry cumulative values,
        so a lost beacon self-heals on the row's next change."""
        with self._lock:
            if full is None:
                full = self._seq % self.full_every == 0
            rows = {}
            for key, r in self._rows.items():
                if full or self._last_n.get(key) != r["n"]:
                    self._last_n[key] = r["n"]
                    rows[key] = self._export_row(r)
            block: dict[str, Any] = {
                "v": 1,
                "seq": self._seq,
                "full": bool(full),
                "device_kind": self.device_kind,
                "ts_us": now_us(),
                "rows": rows,
            }
            self._seq += 1
        for name, fn in (("kv_pages", self._kv_headroom_fn),
                         ("occupancy", self._occupancy_fn)):
            if fn is not None:
                try:
                    block[name] = fn()
                except Exception:  # noqa: BLE001 - gauges are best-effort
                    from ..infra import logging as logx

                    logx.warn("capacity gauge probe failed", gauge=name)
        return block

    def rows(self) -> list[dict]:
        """Every profile row (exported form) — local introspection/tests."""
        with self._lock:
            return [self._export_row(r) for r in self._rows.values()]

    def steady_tokens_per_s(self, op: str) -> float:
        """This worker's own steady-state tokens/s for ``op`` (summed over
        buckets, compile time excluded) — the heartbeat's
        ``cordum.decode_tokens_per_s`` self-measurement peers rank hand-off
        targets by (docs/SERVING.md §Disaggregation)."""
        with self._lock:
            s = tokens = 0.0
            for r in self._rows.values():
                if r["op"] == op and r["steady_s"] > 0:
                    s += r["steady_s"]
                    tokens += r["steady_tokens"]
            return tokens / s if s > 0 else 0.0


def serving_gang_block(gang_id: str, rank: int, size: int, members: list[str],
                       pages_total: int) -> dict:
    """The identity half of a gang member's ``serving_gang`` capacity block:
    gang id, this worker's rank, the gang's size and members in rank order,
    and the rank's arena size.  Rank 0 adds its live fields at beacon time:
    ``pages_free`` and the gang's measured ``tokens_per_s``."""
    return {"gang_id": gang_id, "rank": int(rank), "size": int(size),
            "members": list(members), "pages_total": int(pages_total)}
