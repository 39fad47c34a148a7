"""Job state store: atomic state machine + observability indexes.

Recreates the semantics of the reference Redis job store
(``core/infra/memory/job_store.go``, 1392 LoC):

  * per-job metadata hash ``job:meta:<id>`` (~30 fields)
  * optimistic (WATCH-equivalent) state transitions validated against the
    legal-transition table (job_store.go:71-92) — illegal transitions fail,
    terminal states are immutable
  * per-state sorted-set indexes ``job:index:<STATE>``, plus ``job:recent``
    and the ``job:deadline`` z-set scanned by the reconciler
  * append-only per-job event log ``job:events:<id>`` and trace sets
    ``trace:<id>`` (the tracing story — SURVEY.md §5)
  * tenant active-job counts for concurrency limits
  * scoped idempotency keys (SETNX), per-job locks (SETNX+TTL)
  * safety-decision and approval records binding approvals to job hashes
  * persisted JobRequest blobs so the pending replayer can resubmit
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..protocol.types import (
    JobRequest,
    JobState,
    TERMINAL_STATES,
    is_allowed_transition,
)
from ..utils.ids import now_us
from .codec import pack_record, unpack_record
from .kv import KV

DEFAULT_META_TTL_S = 7 * 24 * 3600.0
RECENT_CAP = 10_000
EVENTS_CAP = 200

_TERMINAL_VALUES = frozenset(s.value for s in TERMINAL_STATES)


class IllegalTransition(Exception):
    def __init__(self, job_id: str, prev: str, nxt: str) -> None:
        super().__init__(f"job {job_id}: illegal transition {prev or '<none>'} -> {nxt}")
        self.prev = prev
        self.next = nxt


def meta_key(job_id: str) -> str:
    return f"job:meta:{job_id}"


def index_key(state: str) -> str:
    return f"job:index:{state}"


def events_key(job_id: str) -> str:
    return f"job:events:{job_id}"


def trace_key(trace_id: str) -> str:
    return f"trace:{trace_id}"


def request_key(job_id: str) -> str:
    return f"job:request:{job_id}"


RECENT_KEY = "job:recent"
DEADLINE_KEY = "job:deadline"


@dataclass
class SafetyDecisionRecord:
    job_id: str = ""
    decision: str = ""
    reason: str = ""
    rule_id: str = ""
    policy_snapshot: str = ""
    job_hash: str = ""
    constraints: Optional[dict] = None
    remediations: list[dict] = field(default_factory=list)
    decided_at_us: int = 0


@dataclass
class ApprovalRecord:
    job_id: str = ""
    approved_by: str = ""
    approved: bool = False
    reason: str = ""
    job_hash: str = ""
    policy_snapshot: str = ""
    decided_at_us: int = 0


@dataclass
class MetaSnapshot:
    """Optimistic view of one job's ``job:meta`` hash: ``(version, fields)``.

    Returned by :meth:`JobStore.watch_meta` and threaded through
    :meth:`JobStore.apply_chain`, which refreshes it locally from the
    pipeline's post-commit version — so a sequence of transitions on one
    job needs exactly one read round trip (or zero, for the optimistic
    fresh-job path that starts from ``MetaSnapshot()`` = "key absent").
    """

    version: int = 0
    fields: dict[str, bytes] = field(default_factory=dict)

    @property
    def state(self) -> str:
        v = self.fields.get("state")
        return v.decode() if v else ""

    @property
    def is_terminal(self) -> bool:
        return self.state in _TERMINAL_VALUES

    def get(self, key: str, default: str = "") -> str:
        v = self.fields.get(key)
        return v.decode() if v else default

    def decoded(self) -> dict[str, str]:
        return {k: v.decode() for k, v in self.fields.items()}


# One validated state transition inside an apply_chain() call:
# (state, fields-or-None, event-name)
Transition = tuple[JobState, Optional[dict[str, str]], str]


class JobStore:
    def __init__(self, kv: KV, *, meta_ttl_s: float = DEFAULT_META_TTL_S) -> None:
        self.kv = kv
        self.meta_ttl_s = meta_ttl_s

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    async def get_state(self, job_id: str) -> str:
        v = await self.kv.hget(meta_key(job_id), "state")
        return v.decode() if v else ""

    async def get_meta(self, job_id: str) -> dict[str, str]:
        h = await self.kv.hgetall(meta_key(job_id))
        return {k: v.decode() for k, v in h.items()}

    async def watch_meta(self, job_id: str) -> MetaSnapshot:
        """One-round-trip ``(version, hash)`` snapshot of ``job:meta``."""
        ver, h = await self.kv.watch_read(meta_key(job_id))
        return MetaSnapshot(ver, h)

    def _chain_ops(
        self, job_id: str, snap: MetaSnapshot, steps: list[Transition]
    ) -> tuple[list[tuple], dict[str, bytes], bool]:
        """Build the pipelined op list for a chain of validated transitions
        applied on top of ``snap``.  Returns ``(ops, overlay, changed)``
        where ``overlay`` is the field delta for refreshing the snapshot
        locally after a successful commit.  Raises
        :class:`IllegalTransition` on the first invalid step."""
        key = meta_key(job_id)
        ops: list[tuple] = []
        overlay: dict[str, bytes] = {}
        cur = dict(snap.fields)
        prev = (cur.get("state") or b"").decode()
        exists = bool(cur)
        changed = False
        for state, fields, event in steps:
            if prev == state.value:
                # idempotent re-apply: update fields only, no transition ops
                if fields:
                    m = {k: v.encode() for k, v in fields.items()}
                    ops.append(("hset", key, m))
                    overlay.update(m)
                    cur.update(m)
                continue
            if not is_allowed_transition(prev, state):
                raise IllegalTransition(job_id, prev, state.value)
            ts = now_us()
            mapping: dict[str, bytes] = {
                "state": state.value.encode(),
                "updated_at_us": str(ts).encode(),
            }
            if not exists:
                mapping["created_at_us"] = str(ts).encode()
            if state in TERMINAL_STATES:
                mapping["finished_at_us"] = str(ts).encode()
            for k, v in (fields or {}).items():
                mapping[k] = v.encode()
            ops.append(("hset", key, mapping))
            if prev:
                ops.append(("zrem", index_key(prev), job_id))
            ops.append(("zadd", index_key(state.value), job_id, float(ts)))
            ops.append(("zadd", RECENT_KEY, job_id, float(ts)))
            ev = {
                "ts_us": ts,
                "state": state.value,
                "prev": prev,
                "event": event or f"state:{state.value}",
            }
            ops.append(("rpush", events_key(job_id), pack_record(ev)))
            if state in TERMINAL_STATES:
                ops.append(("zrem", DEADLINE_KEY, job_id))
                tenant = (cur.get("tenant_id") or b"").decode()
                if tenant and prev and prev not in _TERMINAL_VALUES:
                    ops.append(("zrem", f"job:tenant_active:{tenant}", job_id))
            overlay.update(mapping)
            cur.update(mapping)
            prev = state.value
            exists = True
            changed = True
        if changed:
            ops.append(("ltrim", events_key(job_id), -EVENTS_CAP, -1))
            ops.append(("expire", key, self.meta_ttl_s))
        return ops, overlay, changed

    def build_chain_ops(
        self, job_id: str, snap: MetaSnapshot, steps: list[Transition]
    ) -> tuple[list[tuple], dict[str, bytes], bool]:
        """Public transition-op builder for callers that fold SEVERAL jobs'
        chains into one grouped pipelined commit (scheduler tick batching):
        returns ``(ops, overlay, changed)`` exactly like the internal
        builder, leaving the commit (and its watches) to the caller."""
        return self._chain_ops(job_id, snap, steps)

    async def apply_chain(
        self,
        job_id: str,
        steps: list[Transition],
        *,
        snap: Optional[MetaSnapshot] = None,
        extra_ops: Optional[list[tuple]] = None,
        max_retries: int = 16,
    ) -> tuple[Optional[bool], MetaSnapshot]:
        """Apply a chain of validated transitions (plus any ``extra_ops``
        record writes) as ONE pipelined, version-checked commit.

        ``snap`` (from :meth:`watch_meta`, a previous ``apply_chain``, or
        ``MetaSnapshot()`` for the optimistic "job does not exist yet" fast
        path) makes the first attempt read-free; a conflict re-reads and
        retries.  Returns ``(changed, snap)``: ``True`` if any step moved
        the state, ``False`` if every step was an idempotent re-apply, and
        ``None`` when ``max_retries`` attempts all lost the race (the
        returned snapshot is then a fresh read the caller can inspect).
        Raises :class:`IllegalTransition` on an invalid step."""
        key = meta_key(job_id)
        for attempt in range(max_retries):
            if snap is None:
                snap = await self.watch_meta(job_id)
            ops, overlay, changed = self._chain_ops(job_id, snap, steps)
            if extra_ops:
                ops = [*ops, *extra_ops]
            if not ops:
                return False, snap
            # direct pipe_execute: _chain_ops only emits PIPELINE_OPS names
            # (re-validated store-side), so the Pipeline buffering/validation
            # layer is pure overhead on this hot path (BENCH_r05 regression)
            ok, versions = await self.kv.pipe_execute({key: snap.version}, ops)
            if ok:
                merged = dict(snap.fields)
                merged.update(overlay)
                return changed, MetaSnapshot(versions.get(key, 0), merged)
            snap = None  # lost the race: re-read on the next attempt
        return None, await self.watch_meta(job_id)

    async def set_state(
        self,
        job_id: str,
        state: JobState,
        *,
        fields: Optional[dict[str, str]] = None,
        event: str = "",
        max_retries: int = 16,
        snap: Optional[MetaSnapshot] = None,
        extra_ops: Optional[list[tuple]] = None,
    ) -> bool:
        """Atomic validated transition.  Returns True if the state changed,
        False if the job is already in ``state`` (idempotent re-apply).
        Raises :class:`IllegalTransition` otherwise."""
        changed, _ = await self.apply_chain(
            job_id, [(state, fields, event)],
            snap=snap, extra_ops=extra_ops, max_retries=max_retries,
        )
        if changed is None:
            raise RuntimeError(
                f"job {job_id}: transition to {state.value} lost race repeatedly"
            )
        return changed

    def set_fields_ops(self, job_id: str, fields: dict[str, str]) -> list[tuple]:
        return [
            ("hset", meta_key(job_id), {k: v.encode() for k, v in fields.items()}),
            ("expire", meta_key(job_id), self.meta_ttl_s),
        ]

    async def set_fields(self, job_id: str, fields: dict[str, str]) -> None:
        await self.kv.pipe_execute({}, self.set_fields_ops(job_id, fields))

    async def is_terminal(self, job_id: str) -> bool:
        st = await self.get_state(job_id)
        return bool(st) and st in _TERMINAL_VALUES

    # ------------------------------------------------------------------
    # indexes / listing
    # ------------------------------------------------------------------
    async def list_by_state(self, state: str, limit: int = 100) -> list[str]:
        ids = await self.kv.zrange(index_key(state), 0, limit - 1 if limit else -1)
        return ids

    async def list_by_state_older_than(
        self, state: str, cutoff_us: int, limit: int = 200
    ) -> list[str]:
        return await self.kv.zrangebyscore(index_key(state), 0, float(cutoff_us), limit=limit)

    async def list_recent(self, limit: int = 100) -> list[str]:
        return await self.kv.zrange(RECENT_KEY, 0, limit - 1, desc=True)

    # ------------------------------------------------------------------
    # deadlines
    # ------------------------------------------------------------------
    def register_deadline_ops(self, job_id: str, deadline_unix_ms: int) -> list[tuple]:
        return [("zadd", DEADLINE_KEY, job_id, float(deadline_unix_ms))]

    async def register_deadline(self, job_id: str, deadline_unix_ms: int) -> None:
        await self.kv.zadd(DEADLINE_KEY, job_id, float(deadline_unix_ms))

    async def expired_deadlines(self, now_ms: int, limit: int = 100) -> list[str]:
        return await self.kv.zrangebyscore(DEADLINE_KEY, 0, float(now_ms), limit=limit)

    async def clear_deadline(self, job_id: str) -> None:
        await self.kv.zrem(DEADLINE_KEY, job_id)

    # ------------------------------------------------------------------
    # events / traces
    # ------------------------------------------------------------------
    async def append_event(self, job_id: str, event: str, **kw: Any) -> None:
        ev = {"ts_us": now_us(), "event": event, **kw}
        await self.kv.pipe_execute({}, [
            ("rpush", events_key(job_id), pack_record(ev)),
            ("ltrim", events_key(job_id), -EVENTS_CAP, -1),
        ])

    async def events(self, job_id: str) -> list[dict]:
        # unpack_record reads both the msgpack entries this build
        # writes and legacy JSON entries from older AOF/KV data
        return [unpack_record(b) for b in await self.kv.lrange(events_key(job_id))]

    def add_to_trace_ops(self, trace_id: str, job_id: str) -> list[tuple]:
        return [("sadd", trace_key(trace_id), job_id)] if trace_id else []

    async def add_to_trace(self, trace_id: str, job_id: str) -> None:
        if trace_id:
            await self.kv.sadd(trace_key(trace_id), job_id)

    async def trace(self, trace_id: str) -> set[str]:
        return await self.kv.smembers(trace_key(trace_id))

    # ------------------------------------------------------------------
    # tenant concurrency
    # ------------------------------------------------------------------
    def tenant_active_add_ops(self, tenant_id: str, job_id: str) -> list[tuple]:
        return [("zadd", f"job:tenant_active:{tenant_id}", job_id, float(now_us()))]

    async def tenant_active_add(self, tenant_id: str, job_id: str) -> int:
        key = f"job:tenant_active:{tenant_id}"
        await self.kv.zadd(key, job_id, float(now_us()))
        return await self.kv.zcard(key)

    async def tenant_active_remove(self, tenant_id: str, job_id: str) -> None:
        await self.kv.zrem(f"job:tenant_active:{tenant_id}", job_id)

    async def tenant_active_count(self, tenant_id: str) -> int:
        return await self.kv.zcard(f"job:tenant_active:{tenant_id}")

    # ------------------------------------------------------------------
    # idempotency + locks
    # ------------------------------------------------------------------
    async def try_set_idempotency_key(
        self, scope: str, key: str, job_id: str, ttl_s: float = 24 * 3600
    ) -> tuple[bool, str]:
        """Reserve ``key`` in ``scope``; returns (reserved, existing_job_id)."""
        k = f"idem:{scope}:{key}"
        ok = await self.kv.setnx(k, job_id.encode(), ttl_s)
        if ok:
            return True, job_id
        cur = await self.kv.get(k)
        return False, cur.decode() if cur else ""

    async def acquire_job_lock(self, job_id: str, owner: str, ttl_s: float = 30.0) -> bool:
        return await self.kv.setnx(f"lock:job:{job_id}", owner.encode(), ttl_s)

    async def release_job_lock(self, job_id: str, owner: str) -> None:
        # atomic compare-and-delete: one round trip, and no window where a
        # TTL-expired-and-reacquired lock could be deleted out from under
        # its new owner between the read and the delete
        await self.kv.del_eq(f"lock:job:{job_id}", owner.encode())

    # ------------------------------------------------------------------
    # persisted requests (for replays + approvals)
    # ------------------------------------------------------------------
    def put_request_ops(self, req: JobRequest) -> list[tuple]:
        return [("set", request_key(req.job_id), req.to_wire(), self.meta_ttl_s)]

    async def put_request(self, req: JobRequest) -> None:
        await self.kv.set(request_key(req.job_id), req.to_wire(), self.meta_ttl_s)

    async def get_request(self, job_id: str) -> Optional[JobRequest]:
        b = await self.kv.get(request_key(job_id))
        return JobRequest.from_wire(b) if b else None

    # ------------------------------------------------------------------
    # safety decisions + approvals
    # ------------------------------------------------------------------
    def put_safety_decision_ops(self, rec: SafetyDecisionRecord) -> list[tuple]:
        rec.decided_at_us = rec.decided_at_us or now_us()
        return [(
            "set", f"job:safety:{rec.job_id}",
            pack_record(rec.__dict__), self.meta_ttl_s,
        )]

    async def put_safety_decision(self, rec: SafetyDecisionRecord) -> None:
        rec.decided_at_us = rec.decided_at_us or now_us()
        await self.kv.set(
            f"job:safety:{rec.job_id}", pack_record(rec.__dict__), self.meta_ttl_s
        )

    async def get_safety_decision(self, job_id: str) -> Optional[SafetyDecisionRecord]:
        b = await self.kv.get(f"job:safety:{job_id}")
        return SafetyDecisionRecord(**unpack_record(b)) if b else None

    async def put_approval(self, rec: ApprovalRecord) -> None:
        rec.decided_at_us = rec.decided_at_us or now_us()
        await self.kv.set(
            f"job:approval:{rec.job_id}", pack_record(rec.__dict__), self.meta_ttl_s
        )

    async def get_approval(self, job_id: str) -> Optional[ApprovalRecord]:
        b = await self.kv.get(f"job:approval:{job_id}")
        return ApprovalRecord(**unpack_record(b)) if b else None

    # ------------------------------------------------------------------
    async def cancel_job(self, job_id: str) -> bool:
        """Move a non-terminal job to CANCELLED; False if terminal/unknown."""
        snap = await self.watch_meta(job_id)
        if not snap.state or snap.is_terminal:
            return False
        try:
            await self.set_state(job_id, JobState.CANCELLED, event="cancel", snap=snap)
            return True
        except IllegalTransition:
            return False
