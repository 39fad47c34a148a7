"""Trace assembler: span list → tree, per-stage durations, critical path.

Pure functions over :class:`~cordum_tpu_torch.protocol.types.Span` lists (and the
JSON-safe dicts :func:`assemble` produces), so the gateway API, the CLI
renderer, and bench.py all share one implementation.

Stage semantics: a span's ``name`` IS its pipeline stage.  The canonical
dispatch path is ``submit → policy-check (evaluate) → schedule → dispatch →
execute → result``; ``device`` spans nest under ``execute`` and carry the
device's wall time up to the worker's synchronisation.
"""
from __future__ import annotations

from typing import Any, Optional

from ..protocol.types import Span

# canonical ordering for stage tables (unknown names sort after, by name)
STAGE_ORDER = (
    "submit",
    "step-dispatch",
    "schedule",
    "policy-check",
    "evaluate",
    "strategy",
    "dispatch",
    "execute",
    "device",
    "result",
)


def _stage_rank(name: str) -> tuple[int, str]:
    try:
        return (STAGE_ORDER.index(name), name)
    except ValueError:
        return (len(STAGE_ORDER), name)


def assemble(trace_id: str, spans: list[Span]) -> dict[str, Any]:
    """Rebuild the span tree and derive the trace's shape.

    Returns a JSON-safe dict::

        {trace_id, span_count, services, total_us,
         spans: [{span_id, parent_span_id, name, service, start_us, end_us,
                  duration_us, status, depth, attrs}, ...]   # start order
         stages: {name: {"total_us": int, "count": int}},
         critical_path: [span_id, ...], critical_path_us: int}

    Orphan spans (parent not collected — ring-buffer eviction or a lost
    publish) are treated as roots so a holed trace still renders.
    """
    spans = sorted(spans, key=lambda s: (s.start_us, s.end_us))
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list[Span]] = {}
    roots: list[Span] = []
    for s in spans:
        if s.parent_span_id and s.parent_span_id in by_id:
            children.setdefault(s.parent_span_id, []).append(s)
        else:
            roots.append(s)

    depth: dict[str, int] = {}
    stack = [(r, 0) for r in reversed(roots)]
    while stack:
        node, d = stack.pop()
        depth[node.span_id] = d
        for c in reversed(children.get(node.span_id, [])):
            stack.append((c, d + 1))

    stages: dict[str, dict[str, int]] = {}
    for s in spans:
        st = stages.setdefault(s.name, {"total_us": 0, "count": 0})
        st["total_us"] += s.duration_us
        st["count"] += 1

    path, path_us = _critical_path(roots, children)
    total_us = 0
    if spans:
        total_us = max(s.end_us for s in spans) - min(s.start_us for s in spans)
    return {
        "trace_id": trace_id,
        "span_count": len(spans),
        "services": sorted({s.service for s in spans if s.service}),
        "total_us": max(0, total_us),
        "spans": [
            {
                "span_id": s.span_id,
                "parent_span_id": s.parent_span_id,
                "name": s.name,
                "service": s.service,
                "start_us": s.start_us,
                "end_us": s.end_us,
                "duration_us": s.duration_us,
                "status": s.status,
                "depth": depth.get(s.span_id, 0),
                "attrs": dict(s.attrs),
            }
            for s in spans
        ],
        "stages": dict(sorted(stages.items(), key=lambda kv: _stage_rank(kv[0]))),
        "critical_path": path,
        "critical_path_us": path_us,
    }


def _critical_path(
    roots: list[Span], children: dict[str, list[Span]]
) -> tuple[list[str], int]:
    """Chain from the earliest root to the latest-finishing descendant: at
    each node follow the child whose ``end_us`` is greatest (the one the
    trace actually waited on).  Returns (span ids, wall µs covered)."""
    if not roots:
        return [], 0
    first = min(roots, key=lambda s: s.start_us)
    start = first.start_us
    end = first.end_us
    path: list[str] = []
    cur: Optional[Span] = first
    while cur is not None:
        path.append(cur.span_id)
        end = max(end, cur.end_us)
        kids = children.get(cur.span_id, [])
        cur = max(kids, key=lambda s: (s.end_us, s.duration_us)) if kids else None
    return path, max(0, end - start)


# ---------------------------------------------------------------------------
# cross-trace critical-path aggregation ("where does p99 go")
# ---------------------------------------------------------------------------

UNTRACKED_STAGE = "(untracked)"


def critical_path_blame(doc: dict[str, Any]) -> dict[str, int]:
    """Per-stage **exclusive** µs along one :func:`assemble` doc's critical
    path.

    Each path span's self time is its duration minus its overlap with the
    **union** of the deeper path spans (the time the trace actually spent
    inside a descendant belongs to the descendant's stage — deeper wins, so
    no microsecond is attributed twice even when an async child outlives its
    parent); wall time the path covers but no span accounts for (queueing
    between publishes, clock-skew holes) lands in ``"(untracked)"``.  The
    returned µs sum to the trace's critical-path wall time (or the span-sum
    when clock skew pushes the union past the wall window), so blame shares
    over many traces sum to ~1.0."""
    spans = {s["span_id"]: s for s in doc.get("spans") or []}
    path = [spans[sid] for sid in doc.get("critical_path") or [] if sid in spans]
    out: dict[str, int] = {}
    covered = 0
    for i, sp in enumerate(path):
        self_us = _exclusive_us(sp, path[i + 1:])
        out[sp["name"]] = out.get(sp["name"], 0) + self_us
        covered += self_us
    total = int(doc.get("critical_path_us") or 0)
    if total > covered:
        out[UNTRACKED_STAGE] = out.get(UNTRACKED_STAGE, 0) + (total - covered)
    return out


def _exclusive_us(sp: dict[str, Any], deeper: list[dict[str, Any]]) -> int:
    """``sp``'s duration minus its overlap with the union of the ``deeper``
    path spans' intervals (merged sweep; path lengths are small)."""
    start, end = int(sp["start_us"]), int(sp["end_us"])
    if end <= start:
        return 0
    windows = sorted(
        (max(start, int(d["start_us"])), min(end, int(d["end_us"])))
        for d in deeper
    )
    overlap = 0
    cursor = start
    for w0, w1 in windows:
        w0 = max(w0, cursor)
        if w1 > w0:
            overlap += w1 - w0
            cursor = w1
    return max(0, (end - start) - overlap)


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def aggregate_critical_paths(
    docs: list[dict[str, Any]], *, slowest: int = 5
) -> dict[str, Any]:
    """Merge many traces' ``critical_path`` results into per-stage blame.

    Returns a JSON-safe doc::

        {traces, critical_path_us_total,
         stages: {name: {blame_share, total_us, count, p50_ms, p99_ms}},
         slowest: [{trace_id, critical_path_us, total_us}, ...]}

    ``blame_share`` is each stage's fraction of the summed critical-path
    wall time — shares (including ``"(untracked)"``) sum to ~1.0, so the
    table answers "where does the tail go" directly.  ``p50_ms``/``p99_ms``
    are over the stage's per-trace exclusive times, so a stage that is
    cheap usually but catastrophic at p99 stands out against its share.
    """
    stages: dict[str, dict[str, Any]] = {}
    per_stage_ms: dict[str, list[float]] = {}
    grand = 0
    worst: list[tuple[int, str, int]] = []
    n = 0
    for doc in docs:
        if not doc.get("critical_path"):
            continue
        blame = critical_path_blame(doc)
        if not blame:
            continue
        n += 1
        trace_total = max(int(doc.get("critical_path_us") or 0),
                          sum(blame.values()))
        grand += trace_total
        for name, us in blame.items():
            st = stages.setdefault(name, {"total_us": 0, "count": 0})
            st["total_us"] += us
            st["count"] += 1
            per_stage_ms.setdefault(name, []).append(us / 1000.0)
        worst.append((trace_total, str(doc.get("trace_id", "")),
                      int(doc.get("total_us") or 0)))
    for name, st in stages.items():
        vals = sorted(per_stage_ms[name])
        st["blame_share"] = round(st["total_us"] / grand, 4) if grand else 0.0
        st["p50_ms"] = round(_quantile(vals, 0.50), 3)
        st["p99_ms"] = round(_quantile(vals, 0.99), 3)
    worst.sort(reverse=True)
    return {
        "traces": n,
        "critical_path_us_total": grand,
        "stages": dict(sorted(
            stages.items(),
            key=lambda kv: kv[1]["total_us"], reverse=True,
        )),
        # the slowest traces ARE the blame table's exemplars: each id
        # resolves via GET /api/v1/traces/{id} to a full waterfall
        "slowest": [
            {"trace_id": tid, "critical_path_us": cp, "total_us": tot}
            for cp, tid, tot in worst[:max(0, slowest)]
        ],
    }


def render_blame(doc: dict[str, Any], width: int = 32) -> str:
    """ASCII blame table for ``cordum traces blame`` from an
    :func:`aggregate_critical_paths` document."""
    n = doc.get("traces", 0)
    total_ms = (doc.get("critical_path_us_total") or 0) / 1000.0
    lines = [
        f"critical-path blame over {n} trace(s)  "
        f"(total critical-path time {total_ms:.2f}ms)"
    ]
    stages = doc.get("stages") or {}
    if not stages:
        return lines[0] + "\n(no traces with a critical path collected)"
    name_w = max(len(s) for s in stages) + 2
    lines.append(
        f"{'stage'.ljust(name_w)}{'share':>7}  {'p50ms':>9}  {'p99ms':>9}  "
        f"{'total_ms':>10}  {'n':>5}"
    )
    for name, st in stages.items():
        share = float(st.get("blame_share", 0.0))
        bar = "#" * max(0, int(share * width))
        lines.append(
            f"{name.ljust(name_w)}{share * 100:6.1f}%  "
            f"{st.get('p50_ms', 0.0):9.3f}  {st.get('p99_ms', 0.0):9.3f}  "
            f"{st.get('total_us', 0) / 1000.0:10.2f}  {st.get('count', 0):5d}  |{bar}"
        )
    slowest = doc.get("slowest") or []
    if slowest:
        lines.append("slowest traces: " + "  ".join(
            f"{t['trace_id']}={t['critical_path_us'] / 1000.0:.2f}ms"
            for t in slowest
        ))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# ASCII waterfall (CLI `cordum trace <id>`)
# ---------------------------------------------------------------------------


def _fmt_ms(us: int) -> str:
    return f"{us / 1000.0:.2f}ms"


def render_waterfall(doc: dict[str, Any], width: int = 48) -> str:
    """Render an :func:`assemble` document (or its JSON round-trip) as an
    ASCII waterfall, one row per span in start order."""
    rows = doc.get("spans") or []
    if not rows:
        return f"trace {doc.get('trace_id', '?')}: no spans collected"
    t0 = min(r["start_us"] for r in rows)
    total = max(1, int(doc.get("total_us") or 1))
    crit = set(doc.get("critical_path") or [])
    lines = [
        f"trace {doc.get('trace_id', '?')}  "
        f"{doc.get('span_count', len(rows))} spans  "
        f"services: {', '.join(doc.get('services') or [])}  "
        f"total {_fmt_ms(total)}  critical path {_fmt_ms(int(doc.get('critical_path_us') or 0))}"
    ]
    label_w = max(len(f"{r['depth'] * '  '}{r['name']}") for r in rows) + 2
    svc_w = max((len(r["service"]) for r in rows), default=0) + 2
    for r in rows:
        label = f"{r['depth'] * '  '}{r['name']}".ljust(label_w)
        svc = str(r["service"]).ljust(svc_w)
        off = int((r["start_us"] - t0) * width / total)
        bar_len = max(1, int(r["duration_us"] * width / total))
        bar_len = min(bar_len, width - min(off, width - 1))
        fill = "#" if r["span_id"] in crit else "="
        bar = (" " * min(off, width - 1) + fill * bar_len).ljust(width)
        mark = " !" if r.get("status") == "ERROR" else ""
        lines.append(
            f"{label}{svc}|{bar}| +{_fmt_ms(r['start_us'] - t0)} "
            f"{_fmt_ms(r['duration_us'])}{mark}"
        )
    stages = doc.get("stages") or {}
    if stages:
        lines.append("stages: " + "  ".join(
            f"{name}={_fmt_ms(st['total_us'])}" + (f" x{st['count']}" if st["count"] > 1 else "")
            for name, st in stages.items()
        ))
    return "\n".join(lines)
