"""Message bus abstraction (the framework's NATS-equivalent).

The control plane communicates through subjects carrying serialized
``BusPacket`` envelopes.  Reference behavior being recreated
(``core/infra/bus/nats.go``):

  * queue groups: one subscriber per group receives each message; plain
    subscriptions fan out
  * wildcard subjects (``job.*``, ``sys.job.>``, ``worker.*.jobs``)
  * durable subjects get at-least-once semantics: a handler raising
    :class:`RetryAfter` triggers redelivery after the given delay (the
    JetStream NAK-with-delay path, nats.go:154-163); other exceptions are
    logged and acked (no redelivery)
  * msg-id dedupe window: duplicate publishes of the same job/worker-scoped
    message id inside the window are dropped (nats.go:404-435)

Implementation here: :class:`LoopbackBus` (in-process; also the
integration-test bus, mirroring the reference's loopback test bus pattern,
``scheduler/integration_test.go:18-46``).  Unlike the JAX package's
loopback bus it never serialises: each subscriber gets a packet rebuilt
from a deep copy of the sender's ``to_dict()``, which gives subscribers
the same plain shapes a wire round trip would, without ``msgpack``.
"""
from __future__ import annotations

import asyncio
import copy
import itertools
import logging
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional

from ..protocol import subjects as subj
from ..protocol.types import BusPacket, LABEL_APPROVAL_GRANTED, LABEL_BUS_MSG_ID
from ..utils.globmatch import subject_match

log = logging.getLogger("cordum.bus")

Handler = Callable[[str, BusPacket], Awaitable[None]]

DEDUP_WINDOW_S = 120.0  # JetStream 2m dedup window equivalent
MAX_REDELIVERIES = 5
MAX_NAK_DELAY_S = 30.0  # cap on a single RetryAfter backoff sleep


class RetryAfter(Exception):
    """Raise from a durable-subject handler to request redelivery after a
    delay (reference scheduler/retry.go:9-47)."""

    def __init__(self, delay_s: float, reason: str = "") -> None:
        super().__init__(reason or f"retry after {delay_s}s")
        self.delay_s = delay_s


class _AttrGetter:
    """dict.get-shaped view over an object's attributes (msg-id derivation
    works on raw wire dicts AND typed payloads through one code path)."""

    __slots__ = ("_obj",)

    def __init__(self, obj: Any) -> None:
        self._obj = obj

    def __call__(self, name: str, default: Any = "") -> Any:
        return getattr(self._obj, name, default)


def compute_msg_id(subject: str, pkt: BusPacket) -> str:
    """Stable message id for dedupe: explicit label override, else derived
    from the payload's job/worker identity (reference nats.go:404-435).

    Works on the *raw* payload dict of a lazily decoded packet so the
    dedupe/routing path never forces the dataclass conversion."""
    p = pkt.raw_payload
    if p is None:
        p = pkt.payload
    if type(p) is dict:
        get = p.get
    else:
        get = _AttrGetter(p)
    labels = get("labels", None) or {}
    if isinstance(labels, dict):
        override = labels.get(LABEL_BUS_MSG_ID)
        if override:
            return f"{subject}|{override}"
    # spans: every span id is unique, so it IS the dedupe identity — two
    # spans of one trace finishing in the same microsecond must not collide
    # on the trace_id/created_at fall-through below
    span_id = get("span_id", "")
    if span_id:
        return f"{subject}|{pkt.kind}|{span_id}"
    job_id = get("job_id", "")
    if job_id:
        # Approval republishes reuse the job_id on the submit subject and must
        # NOT dedupe against the original submit — nor against each other (a
        # rejected tampered republish must not suppress the real approval),
        # so they are time-bucketed instead.  The engine's terminal
        # short-circuit + hash check make re-processing them idempotent.
        if isinstance(labels, dict) and labels.get(LABEL_APPROVAL_GRANTED) == "true":
            return f"{subject}|{pkt.kind}|{job_id}|approved|{pkt.created_at_us}"
        # Results carry a status: a terminal result must not dedupe against an
        # earlier non-terminal RUNNING hint for the same job.
        status = get("status", "")
        if status:
            return f"{subject}|{pkt.kind}|{job_id}|{status}"
        return f"{subject}|{pkt.kind}|{job_id}"
    worker_id = get("worker_id", "")
    if worker_id:
        # heartbeats must not dedupe against each other: include time bucket
        return f"{subject}|{pkt.kind}|{worker_id}|{pkt.created_at_us}"
    return f"{subject}|{pkt.kind}|{pkt.trace_id}|{pkt.created_at_us}"


@dataclass
class _Subscription:
    pattern: str
    handler: Handler
    queue: Optional[str]
    sid: int
    closed: bool = False


class Bus:
    """Async pub/sub interface."""

    async def publish(self, subject: str, pkt: BusPacket) -> None:
        raise NotImplementedError

    async def subscribe(
        self, pattern: str, handler: Handler, *, queue: Optional[str] = None
    ) -> "Subscription":
        raise NotImplementedError

    async def close(self) -> None:
        return None

    async def ping(self) -> bool:
        return True

    def has_listener(self, subject: str) -> bool:
        """Best-effort hint: may anything receive a publish to ``subject``?
        Wire-backed buses can't know their remote subscribers, so the
        default is the conservative True; the in-process bus answers
        exactly, letting hot-path publishers (span emission) skip building
        packets nobody will ever see."""
        return True


class Subscription:
    def __init__(self, unsub: Callable[[], None]) -> None:
        self._unsub = unsub

    def unsubscribe(self) -> None:
        self._unsub()


class LoopbackBus(Bus):
    """In-process bus.

    ``durable=True`` (default) gives at-least-once semantics on durable
    subjects: delivery happens on background tasks, RetryAfter causes delayed
    redelivery, and publishes are deduped by msg-id inside the window.
    ``sync=True`` delivers inline in ``publish`` (deterministic unit tests).
    """

    def __init__(self, *, sync: bool = False, durable: bool = True) -> None:
        self._subs: list[_Subscription] = []
        # exact-pattern index: most subscriptions are concrete subjects, and
        # matching every publish against every pattern (N_subs × N_publishes
        # subject_match calls) was a measurable slice of the 1×1 hot path
        self._exact: dict[str, list[_Subscription]] = {}
        self._wild: list[_Subscription] = []
        # subject → matched-subscription cache: with any wildcard subscriber
        # attached (gateway sys.job.> tap, telemetry aggregator), every
        # publish re-ran subject_match per wildcard — measurably ~3-8% of
        # the 1×1 hot path.  The subject set is small and stable, so the
        # match is computed once per subject and invalidated on any
        # (un)subscribe.
        self._target_cache: dict[str, list[_Subscription]] = {}
        self._sid = itertools.count(1)
        self._rr: dict[tuple[str, str], int] = {}
        self._sync = sync
        self._durable = durable
        self._dedup: dict[str, float] = {}
        self._tasks: set[asyncio.Task] = set()
        self._closed = False
        self.published: list[tuple[str, BusPacket]] = []  # test observability

    async def subscribe(
        self, pattern: str, handler: Handler, *, queue: Optional[str] = None
    ) -> Subscription:
        sub = _Subscription(pattern, handler, queue, next(self._sid))
        self._subs.append(sub)
        if "*" in pattern or ">" in pattern:
            self._wild.append(sub)
        else:
            self._exact.setdefault(pattern, []).append(sub)
        self._target_cache.clear()

        def _unsub() -> None:
            sub.closed = True
            if sub in self._subs:
                self._subs.remove(sub)
            if sub in self._wild:
                self._wild.remove(sub)
            bucket = self._exact.get(sub.pattern)
            if bucket and sub in bucket:
                bucket.remove(sub)
                if not bucket:
                    del self._exact[sub.pattern]
            self._target_cache.clear()

        return Subscription(_unsub)

    def _matched(self, subject: str) -> list[_Subscription]:
        matched = self._target_cache.get(subject)
        if matched is None:
            matched = [s for s in self._exact.get(subject, ()) if not s.closed]
            if self._wild:
                matched += [
                    s for s in self._wild
                    if not s.closed and subject_match(s.pattern, subject)
                ]
            if len(self._target_cache) > 4096:  # unbounded-subject backstop
                self._target_cache.clear()
            self._target_cache[subject] = matched
        return matched

    def has_listener(self, subject: str) -> bool:
        return bool(self._matched(subject))

    def _targets(self, subject: str) -> list[_Subscription]:
        matched = self._matched(subject)
        if not matched:
            return matched
        # collapse queue groups to one member (round-robin)
        out: list[_Subscription] = []
        groups: dict[tuple[str, str], list[_Subscription]] = {}
        for s in matched:
            if s.queue is None:
                out.append(s)
            else:
                groups.setdefault((s.pattern, s.queue), []).append(s)
        for key, members in groups.items():
            i = self._rr.get(key, 0)
            out.append(members[i % len(members)])
            self._rr[key] = i + 1
        return out

    def _dedup_hit(self, subject: str, pkt: BusPacket) -> bool:
        if not subj.is_durable_subject(subject):
            return False
        mid = compute_msg_id(subject, pkt)
        now = time.monotonic()
        # amortized prune: evict the oldest half (insertion-ordered dict)
        if len(self._dedup) > 8192:
            for k in list(itertools.islice(self._dedup, 4096)):
                del self._dedup[k]
        seen = self._dedup.get(mid)
        if seen is not None and now - seen < DEDUP_WINDOW_S:
            return True
        self._dedup[mid] = now
        return False

    async def publish(self, subject: str, pkt: BusPacket) -> None:
        if self._closed:
            return
        targets = self._targets(subject)
        if not targets:
            # nobody listening: skip dedupe bookkeeping AND the copy
            # (delivery happens at publish time,
            # so an unheard message is dropped either way)
            self.published.append((subject, pkt))
            return
        if self._durable and self._dedup_hit(subject, pkt):
            return
        self.published.append((subject, pkt))
        # rebuild from plain data so both sides see the same shapes (and no
        # subscriber shares a mutable object with the sender or another)
        plain = pkt.to_dict()
        for sub in targets:
            decoded = BusPacket.from_dict(copy.deepcopy(plain))
            if self._sync:
                await self._deliver(sub, subject, decoded)
            else:
                t = asyncio.ensure_future(self._deliver(sub, subject, decoded))
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)

    async def _deliver(self, sub: _Subscription, subject: str, pkt: BusPacket) -> None:
        # Iterative redelivery loop: the old recursive form grew one stack
        # frame per NAK, so a hot RetryAfter cycle (delay≈0) walked toward
        # the recursion limit across MAX_REDELIVERIES; the requested delay
        # is additionally capped so a handler can't park the delivery task
        # arbitrarily long.
        attempt = 1
        while True:
            try:
                await sub.handler(subject, pkt)
                return
            except RetryAfter as ra:
                durable = self._durable and subj.is_durable_subject(subject)
                if not durable or attempt >= MAX_REDELIVERIES or sub.closed or self._closed:
                    log.warning("dropping message on %s after %d attempts", subject, attempt)
                    return
                attempt += 1
                # handlers read this to back off exponentially (the tenant-
                # concurrency NAK path) instead of NAKing at a fixed cadence
                pkt.redelivery_count = attempt - 1
                await asyncio.sleep(min(max(ra.delay_s, 0.0), MAX_NAK_DELAY_S))
            except Exception:
                log.exception("handler error on %s (acked; no redelivery)", subject)
                return

    async def drain(self) -> None:
        """Wait for all in-flight async deliveries (tests)."""
        while True:
            pending = [t for t in list(self._tasks) if not t.done()]
            if not pending:
                break
            await asyncio.gather(*pending, return_exceptions=True)

    async def close(self) -> None:
        self._closed = True
        for t in list(self._tasks):
            t.cancel()
        self._subs.clear()
        self._exact.clear()
        self._wild.clear()
        self._target_cache.clear()
