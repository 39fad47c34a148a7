"""Span collector: the flight recorder's persistence side.

Consumes finished spans from the durable ``sys.trace.span`` subject (queue
group ``cordum-span-collector`` — one collector instance per deployment
persists each span) and stores them in KV as per-trace ring buffers:

* ``trace:spans:<trace_id>`` — list of span JSON blobs, capped at
  ``max_spans_per_trace`` (oldest spans fall off first) with a TTL so
  abandoned traces expire;
* ``trace:spans:index`` — z-set of trace ids scored by last-write µs; when
  it exceeds ``max_traces`` the oldest traces are evicted wholesale.

On persist the collector also feeds the ``cordum_stage_seconds{stage,
service}`` histograms, which is how per-stage latency reaches ``/metrics``
without every service double-observing locally.  Each stage observation
carries the span's trace id as an exemplar, so a bucket spike links
straight to an offending trace.

Tail-based retention: with ``tail_keep_fraction < 1.0`` the
collector keeps **every** trace whose end-to-end duration (the root span's)
reaches the rolling p95 of recent traces, and only a deterministic
``keep_fraction`` sample of the fast rest — so at scale the store holds the
traces worth debugging without storing the flood.  The default (1.0) keeps
everything.  Tail-dropped spans are
counted under ``cordum_spans_dropped_total{reason="tail_sampled"}`` and the
stage histograms still see every span (sampling bounds storage, not
measurement).
"""
from __future__ import annotations

import json
import zlib
from collections import OrderedDict, deque
from typing import Optional

from ..infra import logging as logx
from ..infra.bus import Bus, Subscription
from ..infra.kv import KV
from ..infra.metrics import Metrics
from ..protocol import subjects as subj
from ..protocol.types import BusPacket, Span
from ..utils.ids import now_us

DEFAULT_MAX_SPANS_PER_TRACE = 512
DEFAULT_MAX_TRACES = 2048
DEFAULT_TRACE_TTL_S = 3600.0
DEFAULT_TAIL_WINDOW = 256
DEFAULT_TAIL_PERCENTILE = 0.95
DEFAULT_TAIL_MIN_SAMPLES = 30

INDEX_KEY = "trace:spans:index"


def spans_key(trace_id: str) -> str:
    return f"trace:spans:{trace_id}"


class TailSampler:
    """Keep-all-slow / sample-the-fast trace retention decision.

    ``admit(trace_id, e2e_us)`` is called once per trace when its root span
    finishes.  A trace at or above the rolling p95 of the recent window is
    ALWAYS kept; a faster trace is kept iff a deterministic hash of its id
    lands under ``keep_fraction`` (deterministic so retries/tests agree and
    a multi-gateway deployment makes the same call).  Until the window has
    ``min_samples`` durations everything is kept — there is no meaningful
    p95 to protect yet.
    """

    def __init__(
        self,
        keep_fraction: float = 1.0,
        *,
        window: int = DEFAULT_TAIL_WINDOW,
        percentile: float = DEFAULT_TAIL_PERCENTILE,
        min_samples: int = DEFAULT_TAIL_MIN_SAMPLES,
    ) -> None:
        self.keep_fraction = min(1.0, max(0.0, keep_fraction))
        self.percentile = percentile
        self.min_samples = max(1, min_samples)
        self._window: deque[int] = deque(maxlen=max(self.min_samples, window))

    @property
    def active(self) -> bool:
        return self.keep_fraction < 1.0

    def threshold_us(self) -> Optional[int]:
        """Rolling p95 (None until the window is warm)."""
        if len(self._window) < self.min_samples:
            return None
        ordered = sorted(self._window)
        idx = min(len(ordered) - 1, int(self.percentile * len(ordered)))
        return ordered[idx]

    @staticmethod
    def _hash01(trace_id: str) -> float:
        return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32

    def admit(self, trace_id: str, e2e_us: int) -> bool:
        thr = self.threshold_us()
        self._window.append(max(0, e2e_us))
        if not self.active or thr is None or e2e_us >= thr:
            return True
        return self._hash01(trace_id) < self.keep_fraction


class SpanCollector:
    def __init__(
        self,
        kv: KV,
        bus: Bus,
        *,
        metrics: Optional[Metrics] = None,
        max_spans_per_trace: int = DEFAULT_MAX_SPANS_PER_TRACE,
        max_traces: int = DEFAULT_MAX_TRACES,
        trace_ttl_s: float = DEFAULT_TRACE_TTL_S,
        tail_keep_fraction: float = 1.0,
        tail_window: int = DEFAULT_TAIL_WINDOW,
        tail_min_samples: int = DEFAULT_TAIL_MIN_SAMPLES,
    ) -> None:
        self.kv = kv
        self.bus = bus
        self.metrics = metrics
        self.max_spans_per_trace = max_spans_per_trace
        self.max_traces = max_traces
        self.trace_ttl_s = trace_ttl_s
        self.tail_sampler = TailSampler(
            tail_keep_fraction, window=tail_window, min_samples=tail_min_samples
        )
        # traces the sampler dropped: late spans of a dropped trace are
        # skipped instead of resurrecting a half-empty ring (LRU-capped)
        self._tail_dropped: OrderedDict[str, None] = OrderedDict()
        self._tail_dropped_cap = 4096
        self._sub: Optional[Subscription] = None

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._sub = await self.bus.subscribe(
            subj.TRACE_SPAN, self._on_span, queue=subj.QUEUE_SPAN_COLLECTOR
        )

    async def stop(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
            self._sub = None

    # ------------------------------------------------------------------
    async def _on_span(self, subject: str, pkt: BusPacket) -> None:
        sp = pkt.span
        if sp is None or not sp.trace_id or not sp.span_id:
            return
        await self.add(sp)

    async def add(self, sp: Span) -> None:
        # stage measurement sees EVERY span — tail sampling bounds trace
        # storage, not the latency histograms (the span's trace id rides as
        # an exemplar so bucket spikes resolve to a stored trace)
        if self.metrics is not None:
            self.metrics.stage_seconds.observe(
                sp.duration_us / 1e6, exemplar=sp.trace_id,
                stage=sp.name, service=sp.service,
            )
        if sp.trace_id in self._tail_dropped:
            # late span of a tail-dropped trace: don't resurrect the ring
            self._tail_dropped.move_to_end(sp.trace_id)
            if self.metrics is not None:
                self.metrics.spans_dropped.inc(reason="tail_sampled")
            return
        # tail retention decision at the trace's root-span finish (the root
        # lands last: children finished before their parent published)
        if (
            self.tail_sampler.active
            and not sp.parent_span_id
            and sp.end_us
            and not self.tail_sampler.admit(sp.trace_id, sp.duration_us)
        ):
            n = await self.kv.llen(spans_key(sp.trace_id))
            await self.kv.delete(spans_key(sp.trace_id))
            await self.kv.zrem(INDEX_KEY, sp.trace_id)
            self._tail_dropped[sp.trace_id] = None
            while len(self._tail_dropped) > self._tail_dropped_cap:
                self._tail_dropped.popitem(last=False)
            if self.metrics is not None:
                self.metrics.spans_dropped.inc(
                    amount=float(n + 1), reason="tail_sampled"
                )
            return
        key = spans_key(sp.trace_id)
        length = await self.kv.rpush(
            key, json.dumps(sp.to_dict(), sort_keys=True).encode()
        )
        # ring-buffer retention: keep the newest max_spans_per_trace; the
        # drop is counted so silent truncation is observable
        # (cordum_spans_dropped_total — platform_smoke asserts it stays 0)
        if length > self.max_spans_per_trace:
            await self.kv.ltrim(key, -self.max_spans_per_trace, -1)
            if self.metrics is not None:
                self.metrics.spans_dropped.inc(
                    amount=float(length - self.max_spans_per_trace),
                    reason="per_trace_cap",
                )
        await self.kv.expire(key, self.trace_ttl_s)
        await self.kv.zadd(INDEX_KEY, sp.trace_id, float(now_us()))
        await self._evict_over_cap()
        if self.metrics is not None:
            self.metrics.spans_collected.inc(service=sp.service)

    async def _evict_over_cap(self) -> None:
        over = await self.kv.zcard(INDEX_KEY) - self.max_traces
        if over <= 0:
            return
        oldest = await self.kv.zrange(INDEX_KEY, 0, over - 1)
        for tid in oldest:
            await self._drop_trace(tid, reason="trace_evicted")
        logx.debug("span collector evicted traces", count=len(oldest))

    async def _drop_trace(self, trace_id: str, *, reason: str) -> None:
        key = spans_key(trace_id)
        if self.metrics is not None:
            n = await self.kv.llen(key)
            if n:
                self.metrics.spans_dropped.inc(amount=float(n), reason=reason)
        await self.kv.delete(key)
        await self.kv.zrem(INDEX_KEY, trace_id)

    # ------------------------------------------------------------------
    # read side (gateway trace API / bench)
    # ------------------------------------------------------------------
    async def spans(self, trace_id: str) -> list[Span]:
        out: list[Span] = []
        for b in await self.kv.lrange(spans_key(trace_id)):
            try:
                sp = Span.from_dict(json.loads(b))
            except (ValueError, TypeError) as e:
                logx.warn("undecodable span in trace", trace_id=trace_id, err=str(e))
                continue
            if sp is not None:
                out.append(sp)
        return out

    async def purge_older_than(self, cutoff_us: int) -> int:
        """Drop traces whose last span landed at or before ``cutoff_us``."""
        stale = await self.kv.zrangebyscore(INDEX_KEY, 0, float(cutoff_us))
        for tid in stale:
            await self._drop_trace(tid, reason="trace_purged")
        return len(stale)

    async def recent_trace_ids(self, n: int = 50) -> list[str]:
        """Newest ``n`` trace ids (the analysis endpoint's working set)."""
        return await self.kv.zrange(INDEX_KEY, 0, max(0, n - 1), desc=True)

    async def recent(self, n: int = 20) -> list[dict]:
        """The newest ``n`` traces as summaries (`cordum traces --last N`):
        trace id, root span name/service, span count, service count, wall
        duration, last-write age."""
        ids = await self.kv.zrange(INDEX_KEY, 0, max(0, n - 1), desc=True)
        out = []
        for tid in ids:
            spans = await self.spans(tid)
            if not spans:
                continue
            root = next(
                (s for s in spans if not s.parent_span_id),
                min(spans, key=lambda s: s.start_us),
            )
            start = min(s.start_us for s in spans)
            end = max(s.end_us or s.start_us for s in spans)
            out.append({
                "trace_id": tid,
                "root": root.name,
                "root_service": root.service,
                "span_count": len(spans),
                "services": sorted({s.service for s in spans if s.service}),
                "duration_ms": round((end - start) / 1000.0, 3),
                "age_s": round(max(0, now_us() - end) / 1e6, 1),
            })
        return out
