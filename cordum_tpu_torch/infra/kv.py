"""State store abstraction (the framework's Redis-equivalent).

All control-plane state lives behind this interface: job metadata hashes,
state indexes (sorted sets), event logs (lists), pointers (``ctx:``/``res:``/
``art:`` strings), locks (set-if-absent), and optimistic transactions
(version-checked multi-key commits — the WATCH/MULTI equivalent the
reference job store builds on, ``core/infra/memory/job_store.go``).

Implementations here: :class:`MemoryKV` — in-process asyncio store with
TTLs and per-key versions, for single-process deployments and tests.  The
worker reads and writes through this interface only, so any store with the
same coroutine methods (a TCP statebus client) can stand in for it.

Pointer scheme: ``kv://<key>`` (reference uses ``redis://<key>``,
``core/infra/memory/redis_store.go:139-158``).
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Iterable, Optional

from .codec import packb, unpackb

POINTER_SCHEME = "kv://"


def pointer_for_key(key: str) -> str:
    return POINTER_SCHEME + key


def key_from_pointer(ptr: str) -> str:
    for scheme in (POINTER_SCHEME, "redis://"):
        if ptr.startswith(scheme):
            return ptr[len(scheme):]
    return ptr


class TxnConflict(Exception):
    """Optimistic transaction lost the race; caller retries."""


# Mutating ops a Pipeline may buffer (superset of the old commit() op table).
# frozenset: membership checks sit on the scheduler hot path (one per
# buffered op), and a tuple scan was measurable at bench job rates.
PIPELINE_OPS = frozenset((
    "set", "delete", "hset", "hdel", "zadd", "zrem", "rpush", "ltrim",
    "sadd", "expire", "del_eq",
))


class Pipeline:
    """Buffered multi-op batch with optional version watches.

    Ops are queued client-side and applied in ONE backend round trip:
    ``MemoryKV`` executes the whole batch inside a single lock acquisition;
    ``StateBusKV`` ships it as a single ``PIPE`` wire frame that the server
    applies atomically (the Redis MULTI/EXEC + pipelining equivalent the
    reference job store leans on for its hot path).

    ``watch(key, version)`` turns the batch into an optimistic transaction:
    it applies iff every watched key still carries the given version
    (version 0 = key absent).  ``execute()`` returns True on success and
    False on conflict; after a successful execute, ``new_versions`` maps
    each watched key to its post-commit version so chained transactions on
    the same key need no re-read round trip.

    Ops are validated (by name) before anything is applied — an unknown op
    rejects the WHOLE batch with ``ValueError`` and leaves state untouched.
    """

    __slots__ = ("_kv", "_watches", "_ops", "new_versions")

    def __init__(self, kv: "KV") -> None:
        self._kv = kv
        self._watches: dict[str, int] = {}
        self._ops: list[tuple] = []
        self.new_versions: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._ops)

    @property
    def ops(self) -> list[tuple]:
        return list(self._ops)

    def watch(self, key: str, version: int) -> "Pipeline":
        self._watches[key] = version
        return self

    def op(self, name: str, *args: Any) -> "Pipeline":
        if name not in PIPELINE_OPS:
            raise ValueError(f"op {name!r} is not pipelineable")
        self._ops.append((name, *args))
        return self

    def extend(self, ops: Iterable[tuple]) -> "Pipeline":
        for o in ops:
            self.op(*o)
        return self

    # buffered op builders ------------------------------------------------
    def set(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> "Pipeline":
        return self.op("set", key, value, ttl_s)

    def delete(self, *keys: str) -> "Pipeline":
        return self.op("delete", *keys)

    def del_eq(self, key: str, expect: bytes) -> "Pipeline":
        return self.op("del_eq", key, expect)

    def hset(self, key: str, mapping: dict[str, bytes]) -> "Pipeline":
        return self.op("hset", key, mapping)

    def hdel(self, key: str, *fields: str) -> "Pipeline":
        return self.op("hdel", key, *fields)

    def zadd(self, key: str, member: str, score: float) -> "Pipeline":
        return self.op("zadd", key, member, score)

    def zrem(self, key: str, *members: str) -> "Pipeline":
        return self.op("zrem", key, *members)

    def rpush(self, key: str, *values: bytes) -> "Pipeline":
        return self.op("rpush", key, *values)

    def ltrim(self, key: str, start: int, stop: int) -> "Pipeline":
        return self.op("ltrim", key, start, stop)

    def sadd(self, key: str, *members: str) -> "Pipeline":
        return self.op("sadd", key, *members)

    def expire(self, key: str, ttl_s: float) -> "Pipeline":
        return self.op("expire", key, ttl_s)

    async def execute(self) -> bool:
        ok, versions = await self._kv.pipe_execute(dict(self._watches), list(self._ops))
        self.new_versions = versions
        return ok



class KV:
    """Async key-value interface.  Values are bytes; hashes map str->bytes."""

    #: bound by services that want `cordum_kv_roundtrips_total{op}` /
    #: `cordum_kv_pipeline_size` emitted (see infra/metrics.py)
    metrics: Any = None

    def bind_metrics(self, metrics: Any) -> None:
        self.metrics = metrics

    def _observe_op(self, op: str, pipeline_size: int = 0) -> None:
        m = self.metrics
        if m is not None:
            m.kv_roundtrips.inc(op=op)
            if pipeline_size:
                m.kv_pipeline_size.observe(float(pipeline_size))

    # strings -------------------------------------------------------------
    async def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    async def set(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> None:
        raise NotImplementedError

    async def setnx(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> bool:
        raise NotImplementedError

    async def delete(self, *keys: str) -> int:
        raise NotImplementedError

    async def del_eq(self, key: str, expect: bytes) -> bool:
        """Delete ``key`` iff its current value equals ``expect`` (atomic
        compare-and-delete — the owner-checked lock release in one round
        trip instead of get+delete)."""
        raise NotImplementedError

    async def expire(self, key: str, ttl_s: float) -> bool:
        raise NotImplementedError

    async def keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    # hashes --------------------------------------------------------------
    async def hset(self, key: str, mapping: dict[str, bytes]) -> None:
        raise NotImplementedError

    async def hget(self, key: str, field: str) -> Optional[bytes]:
        raise NotImplementedError

    async def hgetall(self, key: str) -> dict[str, bytes]:
        raise NotImplementedError

    async def hdel(self, key: str, *fields: str) -> int:
        raise NotImplementedError

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        raise NotImplementedError

    # sorted sets ---------------------------------------------------------
    async def zadd(self, key: str, member: str, score: float) -> None:
        raise NotImplementedError

    async def zrem(self, key: str, *members: str) -> int:
        raise NotImplementedError

    async def zrange(
        self, key: str, start: int = 0, stop: int = -1, desc: bool = False
    ) -> list[str]:
        raise NotImplementedError

    async def zrangebyscore(
        self, key: str, min_score: float, max_score: float, limit: int = 0
    ) -> list[str]:
        raise NotImplementedError

    async def zcard(self, key: str) -> int:
        raise NotImplementedError

    async def zscore(self, key: str, member: str) -> Optional[float]:
        raise NotImplementedError

    # lists ---------------------------------------------------------------
    async def rpush(self, key: str, *values: bytes) -> int:
        raise NotImplementedError

    async def lrange(self, key: str, start: int = 0, stop: int = -1) -> list[bytes]:
        raise NotImplementedError

    async def ltrim(self, key: str, start: int, stop: int) -> None:
        raise NotImplementedError

    async def llen(self, key: str) -> int:
        raise NotImplementedError

    # sets ----------------------------------------------------------------
    async def sadd(self, key: str, *members: str) -> int:
        raise NotImplementedError

    async def smembers(self, key: str) -> set[str]:
        raise NotImplementedError

    # transactions --------------------------------------------------------
    async def version(self, key: str) -> int:
        """Monotonic per-key version (bumped on every mutation); 0 if absent."""
        raise NotImplementedError

    async def watch_read(self, key: str) -> tuple[int, dict[str, bytes]]:
        """Atomic (version, hash-contents) snapshot — one round trip for the
        optimistic read-modify-write loop."""
        ver = await self.version(key)
        return ver, await self.hgetall(key)

    async def commit(
        self,
        watches: dict[str, int],
        ops: list[tuple],
    ) -> bool:
        """Atomically apply `ops` iff every watched key still has the given
        version.  Each op is ``(method_name, *args)``.  Returns False on
        conflict (the WATCH-abort equivalent)."""
        raise NotImplementedError

    # pipelining ----------------------------------------------------------
    def pipeline(self) -> Pipeline:
        """Start a buffered multi-op batch (see :class:`Pipeline`)."""
        return Pipeline(self)

    def pipe_group(self, key: str) -> int:
        """Grouping hint for CROSS-KEY pipelined commits: keys mapping to the
        same group may be folded into one ``pipe_execute`` and commit
        atomically (the scheduler's tick batching relies on this).  Single-
        server stores put every key in group 0; the partitioned client
        returns the key's partition index."""
        return 0

    async def pipe_execute(
        self, watches: dict[str, int], ops: list[tuple]
    ) -> tuple[bool, dict[str, int]]:
        """Apply a pipeline batch in one round trip.  Returns ``(ok,
        new_versions)`` where ``new_versions`` maps each watched key to its
        post-commit version (chained optimistic transactions read-free)."""
        raise NotImplementedError

    async def ping(self) -> bool:
        return True

    async def close(self) -> None:
        return None


class _Entry:
    __slots__ = ("value", "expires_at", "version")

    def __init__(self, value: Any, expires_at: Optional[float], version: int) -> None:
        self.value = value
        self.expires_at = expires_at
        self.version = version


class MemoryKV(KV):
    """In-process store with TTL and per-key version counters."""

    def __init__(self) -> None:
        self._data: dict[str, _Entry] = {}
        self._lock = asyncio.Lock()
        self._global_version = 0
        # bound-method op table: resolved once here instead of a name →
        # attr-name → getattr chain per op inside every pipelined commit
        self._bound_ops = {name: getattr(self, attr) for name, attr in self._OPS.items()}

    # internal helpers (caller holds lock) --------------------------------
    def _live(self, key: str) -> Optional[_Entry]:
        e = self._data.get(key)
        if e is None:
            return None
        if e.expires_at is not None and e.expires_at <= time.monotonic():
            del self._data[key]
            return None
        return e

    def _bump(self, key: str, value: Any, ttl_s: Optional[float] = None, keep_ttl: bool = False) -> _Entry:
        self._global_version += 1
        prev = self._data.get(key)
        expires_at = None
        if ttl_s is not None:
            expires_at = time.monotonic() + ttl_s
        elif keep_ttl and prev is not None:
            expires_at = prev.expires_at
        e = _Entry(value, expires_at, self._global_version)
        self._data[key] = e
        return e

    def _touch(self, e: _Entry) -> None:
        """Bump the version of an in-place-mutated container (no copy —
        containers can be large: indexes, event logs)."""
        self._global_version += 1
        e.version = self._global_version

    def _container(self, key: str, factory) -> _Entry:
        e = self._live(key)
        if e is None or not isinstance(e.value, type(factory())):
            e = self._bump(key, factory())
        return e

    # strings -------------------------------------------------------------
    async def get(self, key: str) -> Optional[bytes]:
        async with self._lock:
            e = self._live(key)
            return e.value if e is not None and isinstance(e.value, bytes) else None

    async def set(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> None:
        async with self._lock:
            self._set_op(key, value, ttl_s)

    async def setnx(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> bool:
        async with self._lock:
            if self._live(key) is not None:
                return False
            self._bump(key, value, ttl_s)
            return True

    async def delete(self, *keys: str) -> int:
        async with self._lock:
            return self._delete_op(*keys)

    async def del_eq(self, key: str, expect: bytes) -> bool:
        async with self._lock:
            return bool(self._del_eq_op(key, expect))

    async def expire(self, key: str, ttl_s: float) -> bool:
        async with self._lock:
            e = self._live(key)
            if e is None:
                return False
            e.expires_at = time.monotonic() + ttl_s
            return True

    async def keys(self, prefix: str = "") -> list[str]:
        async with self._lock:
            return [k for k in list(self._data) if self._live(k) is not None and k.startswith(prefix)]

    # hashes --------------------------------------------------------------
    async def hset(self, key: str, mapping: dict[str, bytes]) -> None:
        async with self._lock:
            self._hset_op(key, mapping)

    async def hget(self, key: str, field: str) -> Optional[bytes]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, dict):
                return None
            return e.value.get(field)

    async def hgetall(self, key: str) -> dict[str, bytes]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, dict):
                return {}
            return dict(e.value)

    async def hdel(self, key: str, *fields: str) -> int:
        async with self._lock:
            return self._hdel_op(key, *fields)

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        async with self._lock:
            e = self._container(key, dict)
            cur = int(e.value.get(field, b"0")) + amount
            e.value[field] = str(cur).encode()
            self._touch(e)
            return cur

    # sorted sets ---------------------------------------------------------
    async def zadd(self, key: str, member: str, score: float) -> None:
        async with self._lock:
            self._zadd_op(key, member, score)

    async def zrem(self, key: str, *members: str) -> int:
        async with self._lock:
            return self._zrem_op(key, *members)

    async def zrange(self, key: str, start: int = 0, stop: int = -1, desc: bool = False) -> list[str]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, dict):
                return []
            items = sorted(e.value.items(), key=lambda kv: (kv[1], kv[0]), reverse=desc)
            members = [m for m, _ in items]
            if stop == -1:
                return members[start:]
            return members[start : stop + 1]

    async def zrangebyscore(self, key: str, min_score: float, max_score: float, limit: int = 0) -> list[str]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, dict):
                return []
            items = sorted(
                ((m, s) for m, s in e.value.items() if min_score <= s <= max_score),
                key=lambda kv: (kv[1], kv[0]),
            )
            members = [m for m, _ in items]
            return members[:limit] if limit else members

    async def zcard(self, key: str) -> int:
        async with self._lock:
            e = self._live(key)
            return len(e.value) if e is not None and isinstance(e.value, dict) else 0

    async def zscore(self, key: str, member: str) -> Optional[float]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, dict):
                return None
            return e.value.get(member)

    # lists ---------------------------------------------------------------
    async def rpush(self, key: str, *values: bytes) -> int:
        async with self._lock:
            return self._rpush_op(key, *values)

    async def lrange(self, key: str, start: int = 0, stop: int = -1) -> list[bytes]:
        async with self._lock:
            e = self._live(key)
            if e is None or not isinstance(e.value, list):
                return []
            lst = e.value
            if stop == -1:
                return list(lst[start:] if start >= 0 else lst[start:])
            if start < 0:
                start = max(0, len(lst) + start)
            return list(lst[start : stop + 1])

    async def ltrim(self, key: str, start: int, stop: int) -> None:
        async with self._lock:
            self._ltrim_op(key, start, stop)

    async def llen(self, key: str) -> int:
        async with self._lock:
            e = self._live(key)
            return len(e.value) if e is not None and isinstance(e.value, list) else 0

    # sets ----------------------------------------------------------------
    async def sadd(self, key: str, *members: str) -> int:
        async with self._lock:
            return self._sadd_op(key, *members)

    async def smembers(self, key: str) -> set[str]:
        async with self._lock:
            e = self._live(key)
            return set(e.value) if e is not None and isinstance(e.value, set) else set()

    # transactions --------------------------------------------------------
    async def version(self, key: str) -> int:
        async with self._lock:
            e = self._live(key)
            return e.version if e is not None else 0

    async def watch_read(self, key: str) -> tuple[int, dict[str, bytes]]:
        async with self._lock:
            e = self._live(key)
            if e is None:
                return 0, {}
            h = dict(e.value) if isinstance(e.value, dict) else {}
            return e.version, h

    # op appliers used by commit(); all assume lock held
    def _set_op(self, key: str, value: bytes, ttl_s: Optional[float] = None) -> None:
        self._bump(key, value, ttl_s)

    def _delete_op(self, *keys: str) -> int:
        n = 0
        for k in keys:
            if self._live(k) is not None:
                del self._data[k]
                n += 1
        return n

    def _del_eq_op(self, key: str, expect: bytes) -> int:
        e = self._live(key)
        if e is not None and e.value == expect:
            del self._data[key]
            return 1
        return 0

    def _hdel_op(self, key: str, *fields: str) -> int:
        e = self._live(key)
        if e is None or not isinstance(e.value, dict):
            return 0
        n = 0
        for f in fields:
            if f in e.value:
                del e.value[f]
                n += 1
        if n:
            self._touch(e)
        return n

    def _ltrim_op(self, key: str, start: int, stop: int) -> None:
        e = self._live(key)
        if e is None or not isinstance(e.value, list):
            return
        lst = e.value
        e.value = lst[start:] if stop == -1 else lst[start : stop + 1]
        self._touch(e)

    def _sadd_op(self, key: str, *members: str) -> int:
        e = self._container(key, set)
        before = len(e.value)
        e.value.update(members)
        self._touch(e)
        return len(e.value) - before

    def _hset_op(self, key: str, mapping: dict[str, bytes]) -> None:
        e = self._container(key, dict)
        e.value.update(mapping)
        self._touch(e)

    def _zadd_op(self, key: str, member: str, score: float) -> None:
        e = self._container(key, dict)
        e.value[member] = score
        self._touch(e)

    def _zrem_op(self, key: str, *members: str) -> int:
        e = self._live(key)
        if e is None or not isinstance(e.value, dict):
            return 0
        n = 0
        for m in members:
            if m in e.value:
                del e.value[m]
                n += 1
        if n:
            self._touch(e)
        return n

    def _rpush_op(self, key: str, *values: bytes) -> int:
        e = self._container(key, list)
        e.value.extend(values)
        self._touch(e)
        return len(e.value)

    def _expire_op(self, key: str, ttl_s: float) -> None:
        e = self._live(key)
        if e is not None:
            e.expires_at = time.monotonic() + ttl_s

    _OPS = {
        "set": "_set_op",
        "delete": "_delete_op",
        "del_eq": "_del_eq_op",
        "hset": "_hset_op",
        "hdel": "_hdel_op",
        "zadd": "_zadd_op",
        "zrem": "_zrem_op",
        "rpush": "_rpush_op",
        "ltrim": "_ltrim_op",
        "sadd": "_sadd_op",
        "expire": "_expire_op",
    }

    def _pipe_locked(
        self, watches: dict[str, int], ops: list[tuple]
    ) -> tuple[bool, dict[str, int]]:
        """Caller holds the lock.  Validates op names BEFORE applying so an
        unknown op rejects the whole batch (never a partial application),
        then checks watches and applies.  Returns post-commit versions of
        the watched keys."""
        bound = self._bound_ops
        appliers = []
        for op in ops:
            applier = bound.get(op[0])
            if applier is None:
                raise ValueError(f"unknown pipeline op {op[0]!r}")
            appliers.append((applier, op))
        for key, ver in watches.items():
            e = self._live(key)
            cur = e.version if e is not None else 0
            if cur != ver:
                return False, {}
        for applier, op in appliers:
            applier(*op[1:])
        versions: dict[str, int] = {}
        for key in watches:
            e = self._live(key)
            versions[key] = e.version if e is not None else 0
        return True, versions

    async def commit(self, watches: dict[str, int], ops: list[tuple]) -> bool:
        async with self._lock:
            ok, _ = self._pipe_locked(watches, ops)
            return ok

    # replication snapshot (infra/replication.py) -------------------------
    async def snapshot(self) -> bytes:
        """Full-state dump for replica bootstrap: every live entry with its
        VERSION preserved, so a replica loaded from a snapshot and then fed
        the primary's op stream stays byte-for-byte version-identical —
        clients that fail over mid-pipeline keep their watched versions
        valid instead of conflicting on the first post-failover commit.
        The blob is the reference's bytes (the port's msgpack codec)."""
        async with self._lock:
            now = time.monotonic()
            items = []
            for k, e in self._data.items():
                if e.expires_at is not None and e.expires_at <= now:
                    continue
                tag, v = ("set", sorted(e.value)) if isinstance(e.value, set) else ("raw", e.value)
                ttl = None if e.expires_at is None else e.expires_at - now
                items.append([k, tag, v, e.version, ttl])
            return packb([self._global_version, items])

    async def load_snapshot(self, blob: bytes) -> None:
        """Replace the whole store with a :meth:`snapshot` dump (replica
        bootstrap / rejoin-after-divergence).  TTLs resume from now."""
        gv, items = unpackb(blob)
        async with self._lock:
            self._data.clear()
            now = time.monotonic()
            for k, tag, v, ver, ttl in items:
                if tag == "set":
                    v = set(v)
                self._data[k] = _Entry(v, None if ttl is None else now + ttl, int(ver))
            self._global_version = int(gv)

    async def pipe_execute(
        self, watches: dict[str, int], ops: list[tuple]
    ) -> tuple[bool, dict[str, int]]:
        self._observe_op("pipe", pipeline_size=len(ops))
        async with self._lock:
            return self._pipe_locked(watches, ops)


# Per-op round-trip accounting: every public MemoryKV op takes the store lock
# exactly once, so it is the in-process analogue of one wire round trip —
# instrumented uniformly so `cordum_kv_roundtrips_total{op}` means the same
# thing it means for StateBusKV (one TCP request) and bench.py can compute
# kv_roundtrips_per_job against either backend.
_COUNTED_OPS = (
    "get", "set", "setnx", "delete", "del_eq", "expire", "keys",
    "hset", "hget", "hgetall", "hdel", "hincrby",
    "zadd", "zrem", "zrange", "zrangebyscore", "zcard", "zscore",
    "rpush", "lrange", "ltrim", "llen", "sadd", "smembers",
    "version", "watch_read", "commit",
)


def _counted(name: str, fn: Any) -> Any:
    async def method(self: MemoryKV, *args: Any, **kwargs: Any) -> Any:
        self._observe_op(name)
        return await fn(self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = fn.__doc__
    return method


for _name in _COUNTED_OPS:
    setattr(MemoryKV, _name, _counted(_name, getattr(MemoryKV, _name)))
