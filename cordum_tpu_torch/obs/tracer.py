"""Span creation + context propagation (the flight recorder's write side).

A :class:`Tracer` is cheap and service-local: each control-plane service
owns one (``Tracer("scheduler", bus)``) and wraps its hot-path segments in
``async with tracer.span("policy-check"): ...``.  Span context flows two
ways:

* **in-process** — a ``contextvars.ContextVar`` holds the active
  ``(trace_id, span_id)`` pair, so nested spans parent themselves
  automatically (asyncio tasks inherit the context at creation time);
* **cross-process** — publishers stamp ``BusPacket.span_id`` /
  ``parent_span_id`` (see ``protocol/types.py``) and receivers pass
  ``pkt.span_id`` as ``parent_span_id`` when they open their own span.

Finished spans are published on the durable ``sys.trace.span`` subject,
fire-and-forget: tracing must never fail the traced work, so publish errors
are logged and swallowed.  Spans without a trace id are timed but not
published (nothing to attach them to).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import AsyncIterator, Optional

from ..infra import logging as logx
from ..infra.bus import Bus
from ..protocol import subjects as subj
from ..protocol.types import SPAN_ERROR, SPAN_OK, BusPacket, Span
from ..utils.ids import fast_id, now_us

# active (trace_id, span_id) for the current asyncio task tree
_CTX: contextvars.ContextVar[tuple[str, str]] = contextvars.ContextVar(
    "cordum_span_ctx", default=("", "")
)

# last span ANY task entered, readable across tasks/threads: contextvars are
# task-local, so the runtime profiler's slow-tick dump (which runs in its own
# task while the stalled work is suspended) could never see the stalled
# task's _CTX — this module-level echo is the cross-task best-effort view
_LAST_ACTIVE: list[str] = ["", ""]


def current_trace_context() -> tuple[str, str]:
    """→ ``(trace_id, span_id)`` of the active span ("" when untraced).
    Used to propagate context into side channels the bus doesn't carry,
    e.g. the remote safety-kernel HTTP headers."""
    return _CTX.get()


def last_active_context() -> tuple[str, str]:
    """→ the last ``(trace_id, span_id)`` any span in this process entered
    (cross-task; the profiler's slow-tick attribution)."""
    return (_LAST_ACTIVE[0], _LAST_ACTIVE[1])


TRACE_HEADER = "X-Cordum-Trace-Id"
SPAN_HEADER = "X-Cordum-Span-Id"


def trace_headers() -> dict[str, str]:
    """HTTP header pair carrying the current span context (empty dict when
    untraced) — the RPC-side analogue of ``BusPacket.span_id``."""
    trace_id, span_id = _CTX.get()
    if not trace_id:
        return {}
    return {TRACE_HEADER: trace_id, SPAN_HEADER: span_id}


class Tracer:
    """Service-local span factory + publisher."""

    def __init__(self, service: str, bus: Optional[Bus] = None) -> None:
        self.service = service
        self.bus = bus

    # ------------------------------------------------------------------
    # primitives (for code whose control flow doesn't fit a CM, e.g. the
    # worker's run-job state machine)
    # ------------------------------------------------------------------
    def begin(
        self,
        name: str,
        *,
        trace_id: str = "",
        parent_span_id: str = "",
        attrs: Optional[dict[str, str]] = None,
    ) -> Span:
        ctx_trace, ctx_span = _CTX.get()
        tid = trace_id or ctx_trace
        parent = parent_span_id
        if not parent and ctx_span and tid == ctx_trace:
            parent = ctx_span
        return Span(
            span_id=fast_id(),
            parent_span_id=parent,
            trace_id=tid,
            name=name,
            service=self.service,
            start_us=now_us(),
            attrs=dict(attrs or {}),
        )

    async def finish(self, span: Span, *, status: str = SPAN_OK) -> None:
        if not span.end_us:
            span.end_us = now_us()
        span.status = status
        await self.emit(span)

    async def emit(self, span: Span) -> None:
        """Publish a finished span; never raises into the traced work."""
        if self.bus is None or not span.trace_id:
            return
        if not self.bus.has_listener(subj.TRACE_SPAN):
            # no collector attached (1×1 bench / span-less deployments):
            # skip the wrap+publish entirely — an unheard loopback publish
            # is dropped at publish time anyway, and wire-backed buses
            # always answer True
            return
        try:
            await self.bus.publish(
                subj.TRACE_SPAN,
                BusPacket.wrap(span, trace_id=span.trace_id, sender_id=self.service),
            )
        except Exception as e:  # noqa: BLE001 - tracing must not fail the work
            logx.warn("span publish failed", span=span.name, err=str(e))

    # ------------------------------------------------------------------
    @contextlib.asynccontextmanager
    async def span(
        self,
        name: str,
        *,
        trace_id: str = "",
        parent_span_id: str = "",
        attrs: Optional[dict[str, str]] = None,
    ) -> AsyncIterator[Span]:
        """Time the enclosed block as a span and publish it on exit.

        The span becomes the ambient context for the block, so nested
        ``tracer.span(...)`` calls (even in other services' code running in
        this task) parent themselves under it.  Exceptions mark the span
        ``ERROR`` with the exception type in ``attrs["error"]`` and are
        re-raised untouched.
        """
        sp = self.begin(
            name, trace_id=trace_id, parent_span_id=parent_span_id, attrs=attrs
        )
        # value-restore rather than ContextVar tokens: a token must be reset
        # in the exact Context that created it, but eagerly-driven coroutines
        # (utils/eager.py) may enter a span in the caller's context and exit
        # in the continuation task's — restoring the saved value is identical
        # in the single-context case and benign in the split case
        prev = _CTX.get() if sp.trace_id else None
        if sp.trace_id:
            _CTX.set((sp.trace_id, sp.span_id))
            _LAST_ACTIVE[0] = sp.trace_id
            _LAST_ACTIVE[1] = sp.span_id
        status = SPAN_OK
        try:
            yield sp
        except BaseException as e:
            status = SPAN_ERROR
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            if prev is not None:
                _CTX.set(prev)
            await self.finish(sp, status=status)
