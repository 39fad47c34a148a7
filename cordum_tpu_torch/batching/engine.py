"""The micro-batcher: per-(op, length-bucket) queues + adaptive flush window.

Flow (see ``docs/BATCHING.md``):

  * :meth:`MicroBatcher.submit` parks a job's rows in the queue keyed by
    ``(op, length_bucket)`` and returns an awaitable per-job result;
  * a queue flushes when its accumulated rows reach ``max_batch_rows`` OR
    when the adaptive window expires — the window is sized from the observed
    arrival rate (EWMA of inter-arrival gaps): fast arrivals wait long
    enough to fill the batch, slow arrivals flush almost immediately so a
    lone job never sits out the full ``max_wait_ms``;
  * one flush = one call of ``flush_fn(op, bucket, items)`` (the padded
    bf16 device call, executed off-loop by the caller's executor);
  * a whole-batch failure falls back to per-item execution so one poison
    job cannot fail its batch-mates;
  * :meth:`cancel` removes a still-queued job and resolves its waiter with
    :class:`BatchCancelled` — the job never rides in the flush.

Each flush emits a ``batch-flush`` flight-recorder span (trace of the
oldest member; parent = that member's execute span) carrying ``batch_size``
/ ``queue_wait_ms`` attributes, and feeds the ``cordum_batch_size`` /
``cordum_batch_queue_depth`` metrics.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional, Sequence

from ..infra import logging as logx
from ..obs.tracer import Tracer
from .buckets import bucket_for, pow2_buckets

# flush_fn(op, seq_bucket, items) -> one result per item, same order
FlushFn = Callable[[str, int, "list[BatchItem]"], Awaitable[Sequence[Any]]]


@dataclass(frozen=True)
class BatchParts:
    """A payload decomposed for batching: op + its rows + queue length key."""

    op: str
    rows: Any
    n_rows: int
    length: int


# parts_fn(payload) -> BatchParts when the payload is batchable, else None.
# Injected by the handler layer (it knows model configs); keeps this engine
# free of op-specific knowledge.
PartsFn = Callable[[Any], Optional[BatchParts]]

DEFAULT_MAX_BATCH_ROWS = 32
DEFAULT_MAX_WAIT_MS = 25.0
MIN_WAIT_MS = 0.5
ARRIVAL_EWMA_ALPHA = 0.3


class BatchCancelled(Exception):
    """Job was cancelled while waiting in a batch queue."""


@dataclass
class BatchItem:
    """One queued job's contribution to a batch."""

    job_id: str
    rows: Any  # op-specific row payload (texts / token rows)
    n_rows: int
    enqueued_at: float
    future: asyncio.Future
    trace_id: str = ""
    parent_span_id: str = ""  # the job's execute span (flush span parent)
    # written at flush time (batch_size / queue_wait_ms); the worker folds
    # these into the job's execute-span attrs
    attr_sink: dict = field(default_factory=dict)


@dataclass
class _Queue:
    items: list[BatchItem] = field(default_factory=list)
    n_rows: int = 0
    timer: Optional[asyncio.TimerHandle] = None


@dataclass
class BatcherStats:
    flushes: int = 0
    flushed_jobs: int = 0
    flushed_rows: int = 0
    max_batch_rows_seen: int = 0
    item_fallbacks: int = 0
    cancelled_in_queue: int = 0


class MicroBatcher:
    def __init__(
        self,
        flush_fn: FlushFn,
        *,
        parts_fn: Optional[PartsFn] = None,
        max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        len_buckets: Sequence[int] = (),
        metrics: Optional[Any] = None,
        tracer: Optional[Tracer] = None,
    ) -> None:
        self.flush_fn = flush_fn
        self.parts_fn = parts_fn
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.len_buckets = tuple(len_buckets) or pow2_buckets(16, 128)
        self.metrics = metrics
        self.tracer = tracer
        self.stats = BatcherStats()
        self._queues: dict[tuple[str, int], _Queue] = {}
        # EWMA inter-arrival gap per queue key (seconds); the adaptive window
        self._arrival_ewma: dict[tuple[str, int], float] = {}
        self._last_arrival: dict[tuple[str, int], float] = {}
        self._flush_tasks: set[asyncio.Task] = set()
        self._closed = False

    # ------------------------------------------------------------------
    def parts(self, payload: Any) -> Optional[BatchParts]:
        """Decompose a job payload for batching; None = not batchable (the
        worker falls back to its ordinary per-job handler path)."""
        if self.parts_fn is None:
            return None
        return self.parts_fn(payload)

    # ------------------------------------------------------------------
    def queue_depth(self, op: str = "") -> int:
        """Queued rows (for ``op``, or all ops when empty) — observability."""
        return sum(
            q.n_rows for (qop, _), q in self._queues.items() if not op or qop == op
        )

    def window_s(self, key: tuple[str, int], queued_rows: int) -> float:
        """Adaptive wait for a queue: the EWMA-predicted time for the batch
        to fill, clamped to [MIN_WAIT_MS, max_wait_ms].  No arrival history
        yet → the full window (first jobs pay the exploratory wait once)."""
        gap = self._arrival_ewma.get(key)
        if gap is None:
            return self.max_wait_s
        expected_fill = gap * max(1, self.max_batch_rows - queued_rows)
        return min(self.max_wait_s, max(MIN_WAIT_MS / 1000.0, expected_fill))

    # ------------------------------------------------------------------
    async def submit(
        self,
        op: str,
        rows: Any,
        *,
        job_id: str,
        length: int,
        n_rows: int = 1,
        trace_id: str = "",
        parent_span_id: str = "",
        attr_sink: Optional[dict] = None,
    ) -> Any:
        """Queue a job's rows and await its scattered result."""
        if self._closed:
            raise RuntimeError("batcher is stopped")
        bucket = bucket_for(length, self.len_buckets)
        key = (op, bucket)
        now = time.monotonic()
        prev = self._last_arrival.get(key)
        if prev is not None:
            gap = now - prev
            ewma = self._arrival_ewma.get(key)
            self._arrival_ewma[key] = (
                gap if ewma is None
                else (1 - ARRIVAL_EWMA_ALPHA) * ewma + ARRIVAL_EWMA_ALPHA * gap
            )
        self._last_arrival[key] = now

        item = BatchItem(
            job_id=job_id,
            rows=rows,
            n_rows=max(1, n_rows),
            enqueued_at=now,
            future=asyncio.get_running_loop().create_future(),
            trace_id=trace_id,
            parent_span_id=parent_span_id,
            attr_sink=attr_sink if attr_sink is not None else {},
        )
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = _Queue()
        q.items.append(item)
        q.n_rows += item.n_rows
        if self.metrics is not None:
            self.metrics.batch_queue_depth.set(
                q.n_rows, op=op, bucket=str(bucket)
            )
        if q.n_rows >= self.max_batch_rows:
            self._start_flush(key, q)
        elif q.timer is None:
            delay = self.window_s(key, q.n_rows)
            q.timer = asyncio.get_running_loop().call_later(
                delay, self._start_flush, key, q
            )
        return await item.future

    # ------------------------------------------------------------------
    def cancel(self, job_id: str) -> bool:
        """Remove a still-queued job; its waiter gets :class:`BatchCancelled`
        so the worker publishes an ordinary CANCELLED result.  Returns False
        when the job is not queued (already flushing or never batched)."""
        for key, q in list(self._queues.items()):
            for i, item in enumerate(q.items):
                if item.job_id != job_id:
                    continue
                q.items.pop(i)
                q.n_rows -= item.n_rows
                self.stats.cancelled_in_queue += 1
                if not item.future.done():
                    item.future.set_exception(BatchCancelled(job_id))
                if self.metrics is not None:
                    self.metrics.batch_queue_depth.set(
                        q.n_rows, op=key[0], bucket=str(key[1])
                    )
                if not q.items:
                    if q.timer is not None:
                        q.timer.cancel()
                    self._queues.pop(key, None)
                return True
        return False

    # ------------------------------------------------------------------
    def _start_flush(self, key: tuple[str, int], q: _Queue) -> None:
        # a stale timer for an already-flushed queue must not flush its
        # replacement early: only act when `q` is still the live queue
        if self._queues.get(key) is not q:
            return
        if q.timer is not None:
            q.timer.cancel()
            q.timer = None
        self._queues.pop(key, None)
        if not q.items:
            return
        t = asyncio.ensure_future(self._flush(key, q.items))
        self._flush_tasks.add(t)
        t.add_done_callback(self._flush_tasks.discard)

    async def _flush(self, key: tuple[str, int], items: list[BatchItem]) -> None:
        op, bucket = key
        n_rows = sum(it.n_rows for it in items)
        now = time.monotonic()
        queue_wait_ms = max(0.0, (now - min(it.enqueued_at for it in items)) * 1000)
        self.stats.flushes += 1
        self.stats.flushed_jobs += len(items)
        self.stats.flushed_rows += n_rows
        self.stats.max_batch_rows_seen = max(self.stats.max_batch_rows_seen, n_rows)
        for it in items:
            it.attr_sink["batch_size"] = str(n_rows)
            it.attr_sink["batch_jobs"] = str(len(items))
            it.attr_sink["batch_queue_wait_ms"] = f"{queue_wait_ms:.2f}"
        if self.metrics is not None:
            self.metrics.batch_size.observe(float(n_rows), op=op)
            self.metrics.batch_flushes.inc(op=op, bucket=str(bucket))
            self.metrics.batch_queue_depth.set(0, op=op, bucket=str(bucket))
        oldest = min(items, key=lambda it: it.enqueued_at)
        span = None
        if self.tracer is not None and oldest.trace_id:
            span = self.tracer.begin(
                "batch-flush",
                trace_id=oldest.trace_id,
                parent_span_id=oldest.parent_span_id,
                attrs={
                    "op": op,
                    "bucket": str(bucket),
                    "batch_size": str(n_rows),
                    "batch_jobs": str(len(items)),
                    "queue_wait_ms": f"{queue_wait_ms:.2f}",
                },
            )
        try:
            results = await self.flush_fn(op, bucket, items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"flush_fn returned {len(results)} results for {len(items)} items"
                )
            for it, res in zip(items, results):
                if not it.future.done():
                    it.future.set_result(res)
            if span is not None and self.tracer is not None:
                await self.tracer.finish(span)
        except Exception as batch_err:  # noqa: BLE001 - isolated per item below
            if span is not None and self.tracer is not None:
                span.attrs["error"] = type(batch_err).__name__
                await self.tracer.finish(span, status="ERROR")
            if len(items) == 1:
                if not items[0].future.done():
                    items[0].future.set_exception(batch_err)
                return
            # whole-batch failure: isolate — rerun each member alone so only
            # the job that actually poisons the program fails
            logx.warn(
                "batch flush failed; isolating per item",
                op=op, bucket=bucket, jobs=len(items), err=str(batch_err),
            )
            for it in items:
                if it.future.done():
                    continue
                self.stats.item_fallbacks += 1
                try:
                    single = await self.flush_fn(op, bucket, [it])
                    if not it.future.done():
                        it.future.set_result(single[0])
                except Exception as item_err:  # noqa: BLE001 - per-job verdict
                    if not it.future.done():
                        it.future.set_exception(item_err)

    # ------------------------------------------------------------------
    async def flush_now(self) -> None:
        """Flush every queue immediately (tests / shutdown drain)."""
        for key, q in list(self._queues.items()):
            self._start_flush(key, q)
        while self._flush_tasks:
            await asyncio.gather(*list(self._flush_tasks), return_exceptions=True)

    async def stop(self) -> None:
        """Drain: flush queued work, then refuse new submits."""
        self._closed = True
        await self.flush_now()
