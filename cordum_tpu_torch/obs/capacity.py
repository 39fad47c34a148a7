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


# ---------------------------------------------------------------------------
# CapacityView — the scheduler-side fold of worker capacity beacons
# ---------------------------------------------------------------------------


class CapacityView:
    """Per-worker per-op steady-state throughput, folded from the workers'
    telemetry beacons — the :class:`ThroughputAwareStrategy`'s read-side
    (docs/ADMISSION.md §Routing).

    The gateway's fleet aggregator (the reference's ``obs/fleet.py``) already
    folds these blocks into ``/api/v1/capacity``; the scheduler folds its
    own much smaller view (worker beacons only, rates only) from the same
    ``sys.telemetry.worker`` subject so routing needs no gateway RPC.
    Worker telemetry ``instance`` ids equal heartbeat ``worker_id``s
    (cmd/worker wires the exporter that way), so rows join the registry
    directly.  A restart (``started_at_us`` change) clears the dead
    epoch's rows; a worker silent past ``stale_after_s`` reads as
    unmeasured, which drops it back to LeastLoaded routing.
    """

    def __init__(self, *, stale_after_s: float = 15.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.stale_after_s = stale_after_s
        self.clock = clock
        # worker_id → {"rows": {op: {bucket: (items/s, tokens/s)}},
        #              "kv_pages": dict, "occupancy": dict,
        #              "serving_role": str, "draining": bool,
        #              "started_at_us": int, "last": monotonic}
        self._workers: dict[str, dict] = {}
        self._sub = None

    async def start(self, bus: Any) -> None:
        from ..protocol import subjects as subj

        self._sub = await bus.subscribe(subj.TELEMETRY_WILDCARD, self._on_snapshot)

    async def stop(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
            self._sub = None

    async def _on_snapshot(self, subject: str, pkt: Any) -> None:
        snap = pkt.telemetry
        if snap is not None:
            self.ingest(snap)

    def ingest(self, snap: Any) -> None:
        """Fold one telemetry snapshot (also the test entry point)."""
        if snap.service != "worker" or not snap.instance:
            return
        block = (snap.health or {}).get("capacity")
        if not isinstance(block, dict):
            return
        w = self._workers.get(snap.instance)
        if w is None or (
            snap.started_at_us and w["started_at_us"] != snap.started_at_us
        ):
            # new worker or restart: the dead epoch's cumulative rates are
            # a different machine-state — start a fresh fold
            w = self._workers[snap.instance] = {
                "rows": {}, "started_at_us": snap.started_at_us, "last": 0.0,
                "kv_pages": {}, "occupancy": {},
                "serving_role": "", "draining": False,
                "serving_gang": {},
            }
        w["last"] = self.clock()
        for key, row in (block.get("rows") or {}).items():
            if not isinstance(row, dict):
                continue
            op = str(row.get("op", "")) or str(key).split("|", 1)[0]
            # rows are per-(op, bucket); routing wants per-op, so keep the
            # per-bucket rates and recompute the op aggregate on read
            w["rows"].setdefault(op, {})[str(row.get("bucket", "-"))] = (
                float(row.get("items_per_s", 0.0)),
                float(row.get("tokens_per_s", 0.0)),
            )
        # decode-side serving state (docs/SERVING.md §Disaggregation): page
        # headroom, decode occupancy, the worker's serving role and its
        # drain flag ride every capacity block — the ServingPlacer and the
        # DecodeRebalancer read them with the same staleness bound as rates
        for extra in ("kv_pages", "occupancy"):
            v = block.get(extra)
            if isinstance(v, dict):
                w[extra] = dict(v)
        role = block.get("serving_role")
        if isinstance(role, str):
            w["serving_role"] = role
        w["draining"] = bool(block.get("draining", False))
        # serving-gang membership (docs/SERVING.md §Sharded serving): the
        # block rides every beacon while the worker is a gang member and
        # DISAPPEARS when the gang ends, so absence clears the fold
        sg = block.get("serving_gang")
        w["serving_gang"] = dict(sg) if isinstance(sg, dict) else {}

    def _fresh(self, worker_id: str) -> Optional[dict]:
        w = self._workers.get(worker_id)
        if w is None or self.clock() - w["last"] > self.stale_after_s:
            return None
        return w

    def rate(self, worker_id: str, op: str) -> float:
        """Fresh measured steady-state items/s this worker delivers for
        ``op`` (summed over buckets); 0.0 = unmeasured or stale."""
        w = self._fresh(worker_id)
        if w is None:
            return 0.0
        buckets = w["rows"].get(op)
        if not buckets:
            return 0.0
        return sum(items for items, _ in buckets.values())

    def token_rate(self, worker_id: str, op: str) -> float:
        """Fresh measured steady-state tokens/s for ``op`` (summed over
        buckets); 0.0 = unmeasured or stale.  The serving placement signal:
        ``llm.prefill`` rows measure prompt ingestion, ``llm.generate``
        rows measure steady decode (docs/SERVING.md §Disaggregation)."""
        w = self._fresh(worker_id)
        if w is None:
            return 0.0
        buckets = w["rows"].get(op)
        if not buckets:
            return 0.0
        return sum(tokens for _, tokens in buckets.values())

    def kv_pages(self, worker_id: str) -> dict:
        """Fresh KV-page arena gauges (``pages_total`` / ``pages_free`` /
        ``pages_in_use``); {} = unmeasured or stale."""
        w = self._fresh(worker_id)
        return dict(w["kv_pages"]) if w is not None else {}

    def decode_occupancy(self, worker_id: str) -> dict:
        """Fresh decode-occupancy gauges (``active_sessions`` /
        ``decode_mean`` / ``decode_max``); {} = unmeasured or stale."""
        w = self._fresh(worker_id)
        return dict(w["occupancy"]) if w is not None else {}

    def serving_role(self, worker_id: str) -> str:
        """The worker's beaconed serving role; "" = unknown/stale (readers
        treat it as ``mixed``)."""
        w = self._fresh(worker_id)
        return str(w["serving_role"]) if w is not None else ""

    def spec_accept(self, worker_id: str) -> Optional[float]:
        """The worker's speculative-decoding acceptance EWMA (rides the
        occupancy block, docs/SERVING.md §Speculative decoding); ``None``
        = speculation disabled there, or unmeasured/stale.  Presence is
        the ServingPlacer's draft-enabled signal for speculable traffic."""
        w = self._fresh(worker_id)
        if w is None:
            return None
        rate = w["occupancy"].get("spec_accept_rate")
        return float(rate) if rate is not None else None

    def draining(self, worker_id: str) -> bool:
        w = self._fresh(worker_id)
        return bool(w["draining"]) if w is not None else False

    def serving_workers(self) -> list[str]:
        """Every fresh worker currently reporting serving state (a KV-page
        arena in its capacity block) — the rebalancer's candidate set."""
        return [wid for wid in self._workers
                if (self._fresh(wid) or {}).get("kv_pages")]

    def measured_workers(self, op: str) -> dict[str, float]:
        """worker_id → fresh items/s for every worker measured on ``op``."""
        out = {}
        for wid in self._workers:
            r = self.rate(wid, op)
            if r > 0:
                out[wid] = r
        return out

    def serving_gang(self, worker_id: str) -> dict:
        """The worker's fresh serving-gang membership block; {} = not a
        gang member (or stale)."""
        w = self._fresh(worker_id)
        return dict(w.get("serving_gang") or {}) if w is not None else {}

    def serving_gangs(self) -> dict[str, dict]:
        """gang_id → ONE fused capacity row per live serving gang, folded
        from every fresh member's beacon (docs/SERVING.md §Sharded
        serving): the leader (rank 0) contributes the measured aggregate
        decode tokens/s — the fused step throughput IS rank 0's, every
        rank advances in lock-step — and page headroom fuses min-of-ranks
        (a gang admits only what its tightest arena can hold)."""
        out: dict[str, dict] = {}
        for wid in list(self._workers):
            w = self._fresh(wid)
            if w is None:
                continue
            sg = w.get("serving_gang") or {}
            gid = str(sg.get("gang_id", "") or "")
            if not gid:
                continue
            g = out.setdefault(gid, {
                "gang_id": gid, "size": int(sg.get("size", 0) or 0),
                "leader": "", "members": {}, "tokens_per_s": 0.0,
                "pages_free_min": None, "pages_total_min": None,
            })
            try:
                rank = int(sg.get("rank", -1))
            except (TypeError, ValueError):
                rank = -1
            g["members"][wid] = rank
            if rank == 0:
                g["leader"] = wid
                g["tokens_per_s"] = float(sg.get("tokens_per_s", 0.0) or 0.0)
            for src, dst in (("pages_free", "pages_free_min"),
                             ("pages_total", "pages_total_min")):
                v = sg.get(src)
                if isinstance(v, (int, float)):
                    g[dst] = v if g[dst] is None else min(g[dst], v)
        return out


# ---------------------------------------------------------------------------
# `cordumctl capacity` rendering (pure function so tests cover it offline)
# ---------------------------------------------------------------------------

_CAP_COLS = (
    ("op", "op"), ("bucket", "bucket"), ("worker", "worker"),
    ("device", "device_kind"), ("items/s", "items_per_s"),
    ("tok/s", "tokens_per_s"), ("p50ms", "p50_ms"), ("p99ms", "p99_ms"),
    ("ewma", "ewma_ms"), ("n", "n"), ("compile", "compile_n"),
    ("fresh", "fresh"),
)

# per-worker serving-state columns (docs/SERVING.md §Disaggregation and
# §Prefix cache and tiering): the beacons already carry the KV arena,
# decode occupancy, prefix-cache residency, session tiers, role and drain
# flag — this table surfaces them next to the throughput matrix
_WORKER_COLS = (
    ("worker", "worker"), ("role", "role"), ("kv_free", "kv_free"),
    ("kv_used", "kv_used"), ("sessions", "sessions"), ("occ", "occ"),
    ("pfx_pages", "pfx_pages"), ("pfx_hit", "pfx_hit"),
    ("resident", "resident"), ("hib", "hib"), ("accept", "accept"),
    ("draining", "draining"), ("fresh", "fresh"),
)


def _render_rows(cols: tuple, rows: list[dict]) -> list[str]:
    widths = {
        key: max(len(title), *(len(row[key]) for row in rows))
        for title, key in cols
    }
    out = ["  ".join(t.ljust(widths[k]) for t, k in cols)]
    for row in rows:
        out.append("  ".join(row[k].ljust(widths[k]) for _, k in cols))
    return out


def render_worker_table(workers: dict) -> list[str]:
    """Per-worker serving-state lines (KV-page headroom, decode occupancy,
    role, draining) from a capacity doc's ``workers`` map; [] when no
    worker reports serving state."""
    rows = []
    for wid in sorted(workers):
        w = workers[wid] or {}
        kv = w.get("kv_pages") or {}
        occ = w.get("occupancy") or {}
        if not kv and not occ and not w.get("serving_role"):
            continue
        # prefix-cache + tiering fields ride the same beacons; workers
        # without the cache (or older beacons) render "-"
        resident = "-"
        if "resident_warm" in occ or "resident_cold" in occ:
            resident = (f"{occ.get('resident_warm', 0)}w/"
                        f"{occ.get('resident_cold', 0)}c")
        rows.append({
            "worker": str(wid),
            "role": str(w.get("serving_role") or "mixed"),
            "kv_free": str(kv.get("pages_free", "-")),
            "kv_used": str(kv.get("pages_in_use", "-")),
            "sessions": str(occ.get("active_sessions", "-")),
            "occ": f"{occ.get('decode_mean', 0.0):g}",
            "pfx_pages": str(kv.get("prefix_pages", "-")),
            "pfx_hit": (f"{occ['prefix_hit_rate']:.0%}"
                        if "prefix_hit_rate" in occ else "-"),
            "resident": resident,
            "hib": str(occ.get("hibernated_sessions", "-")),
            # speculative acceptance EWMA; "-" = speculation disabled on
            # that worker (the key never rides its occupancy beacon)
            "accept": (f"{occ['spec_accept_rate']:.0%}"
                       if "spec_accept_rate" in occ else "-"),
            "draining": "yes" if w.get("draining") else "no",
            "fresh": "yes" if w.get("fresh", True) else "no",
        })
    return _render_rows(_WORKER_COLS, rows) if rows else []


_GANG_COLS = (
    ("gang", "gang"), ("size", "size"), ("tok/s", "tokens_per_s"),
    ("kv_free_min", "kv_free_min"), ("members", "members"),
)


def render_serving_gang_table(gangs: list) -> list[str]:
    """ONE fused line per serving gang (docs/SERVING.md §Sharded serving):
    aggregate decode tokens/s, min-of-ranks page headroom, and the member
    ranks — instead of N unrelated worker rows.  [] when no gang is live."""
    rows = []
    for g in sorted(gangs or [], key=lambda g: str(g.get("gang_id", ""))):
        members = g.get("members") or {}
        rows.append({
            "gang": str(g.get("gang_id", "")),
            "size": str(g.get("size", len(members))),
            "tokens_per_s": f"{g.get('tokens_per_s', 0.0):.1f}",
            "kv_free_min": str(g.get("pages_free_min", "-")),
            "members": " ".join(
                f"{wid}:{rank}" for wid, rank in
                sorted(members.items(), key=lambda kv: kv[1])),
        })
    return _render_rows(_GANG_COLS, rows) if rows else []


def render_capacity_table(doc: dict) -> str:
    """ASCII op × worker throughput table for ``cordumctl capacity`` from a
    ``GET /api/v1/capacity`` document, with a per-worker serving-state
    section (KV-page headroom, decode occupancy, role, draining) and one
    fused row per live serving gang."""
    matrix = doc.get("matrix") or []
    ops = doc.get("ops") or {}
    head = "cordum capacity — {w} worker(s), {r} profile row(s)".format(
        w=len(doc.get("workers") or {}), r=len(matrix))
    if ops:
        head += "  |  " + "  ".join(
            f"{op}={v}/s" for op, v in sorted(ops.items()))
    worker_lines = render_worker_table(doc.get("workers") or {})
    gang_lines = render_serving_gang_table(doc.get("serving_gangs") or [])
    if gang_lines:
        worker_lines = [*worker_lines, "", "serving gangs:", *gang_lines]
    if not matrix:
        return "\n".join(
            [head, *worker_lines, "(no capacity profiles reported yet)"])
    rows = []
    for r in sorted(matrix, key=lambda r: (r.get("op", ""), r.get("bucket", ""),
                                           r.get("worker", ""))):
        rows.append({
            "op": str(r.get("op", "")),
            "bucket": str(r.get("bucket", "")),
            "worker": str(r.get("worker", "")),
            "device_kind": str(r.get("device_kind", "")),
            "items_per_s": f"{r.get('items_per_s', 0.0):.1f}",
            "tokens_per_s": f"{r.get('tokens_per_s', 0.0):.1f}",
            "p50_ms": f"{r.get('p50_ms', 0.0):g}",
            "p99_ms": f"{r.get('p99_ms', 0.0):g}",
            "ewma_ms": f"{r.get('ewma_ms', 0.0):.2f}",
            "n": str(r.get("n", 0)),
            "compile_n": str(r.get("compile_n", 0)),
            "fresh": "no" if r.get("stale") else "yes",
        })
    out = [head]
    if worker_lines:
        out.extend(worker_lines)
        out.append("")
    out.extend(_render_rows(_CAP_COLS, rows))
    return "\n".join(out)
