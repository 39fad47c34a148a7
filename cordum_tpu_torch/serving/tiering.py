"""Session tiering: hibernate idle conversations to a host-RAM cold arena.

The other half of prefix sharing.  Prefix caching (serving/prefixcache.py)
keeps a retired conversation's KV pages resident so the next turn skips
their prefill — but resident-in-HBM caps how many conversations a worker
can hold at ``serving_cache_pages``.  Chat think time is measured in
minutes; device memory should not be.  This module tiers idle resident
state down:

  * **hibernate** — :class:`SessionTiering.sweep` demotes warm prefix
    nodes idle past ``hibernate_after_s``: each page is exported with the
    exact migration record format (``{"i", "used", "k", "v",
    "shape"}``, float32-upcast — docs/PROTOCOL.md §Page transfer) into
    host RAM and released back to the allocator.  The trie keeps the node
    as *cold*; max-resident-sessions becomes a cold-storage bound, not an
    HBM bound.
  * **restore** — the next turn's admission (same ``cordum.session_key``,
    routed back here by the pinned affinity entry) hits the cold node:
    the engine allocates a fresh page, scatters the record back, and the
    prefill skip proceeds as if the page had never left.  The restore
    pause is the alloc + scatter, measured by
    ``cordum_serving_hibernate_pause_seconds``.
  * **live sessions** — :class:`ColdArena` also stores whole frozen
    sessions (``ServingEngine.hibernate_session``): freeze → quiesce →
    export state + pages → retire ``reason="hibernated"``; restore rides
    the existing ``install_session`` path and replays carried tokens at
    offset 0, so offset-deduping stream consumers see an exactly-once
    sequence across the gap.

The registry also answers "how many conversations are resident here" for
the capacity beacon (warm = every page of the newest turn still in the
device arena; cold = at least one page tiered out).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from ..infra import codec
from ..infra import logging as logx
from .prefixcache import PrefixCache


class ColdArena:
    """Host-RAM store for hibernated state, with byte accounting.

    Keys are opaque (the engine uses ``job_id`` for live sessions); a
    value is the migration-format doc ``{"meta", "state", "records"}``.
    A per-process byte cap would slot in here; for now the bound is the
    host's RAM, which is the point — it is not the device arena."""

    def __init__(self) -> None:
        self._store: dict[str, dict] = {}
        self.bytes = 0

    @staticmethod
    def _doc_bytes(doc: dict) -> int:
        return sum(
            len(rec.get("k", b"")) + len(rec.get("v", b""))
            for rec in doc.get("records", ())
        )

    def put(self, key: str, doc: dict) -> None:
        self.pop(key)
        self._store[key] = doc
        self.bytes += self._doc_bytes(doc)

    def get(self, key: str) -> Optional[dict]:
        return self._store.get(key)

    def pop(self, key: str) -> Optional[dict]:
        doc = self._store.pop(key, None)
        if doc is not None:
            self.bytes -= self._doc_bytes(doc)
        return doc

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)


COLD_TIER_PREFIX = "serving:cold:"


class StatebusColdTier(ColdArena):
    """Cold arena mirrored through the statebus KV so hibernated sessions
    survive a worker restart (``serving_cold_tier: statebus``,
    docs/SERVING.md §Session tiering).

    The RAM copy stays authoritative on the hot path — ``put``/``pop``/
    ``get`` cost exactly what :class:`ColdArena` costs — while every
    mutation is journaled to ``serving:cold:<worker_id>:<key>`` by a
    fire-and-forget drain task (hibernation must never block on the bus;
    a persist failure only narrows restart durability, counted in
    ``persist_errors``).  On boot the worker calls :meth:`load` after
    ``start()``: surviving keys re-populate the mirror, and the live copy
    always wins over a stale journal.  Docs are msgpack (the port's codec,
    the same bytes the reference journals): the migration record format
    is bytes and scalars, so page payloads round-trip without
    re-encoding."""

    def __init__(self, kv, *, prefix: str = COLD_TIER_PREFIX,
                 worker_id: str = "") -> None:
        super().__init__()
        self.kv = kv
        scope = f"{worker_id}:" if worker_id else ""
        self.prefix = f"{prefix}{scope}"
        # key -> doc (persist) or None (delete); insertion order preserved
        self._dirty: dict[str, Optional[dict]] = {}
        self._drain_task: Optional[asyncio.Task] = None
        self.persist_errors = 0
        self.loaded = 0

    # -- hot path (sync, mirrors ColdArena) ----------------------------
    def put(self, key: str, doc: dict) -> None:
        super().put(key, doc)
        self._mark(key, doc)

    def pop(self, key: str) -> Optional[dict]:
        doc = super().pop(key)
        if doc is not None:
            self._mark(key, None)
        return doc

    def _mark(self, key: str, doc: Optional[dict]) -> None:
        self._dirty[key] = doc
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tests): flush() persists later
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = loop.create_task(self._drain())

    # -- bus side ------------------------------------------------------
    async def _drain(self) -> None:
        while self._dirty:
            key, doc = next(iter(self._dirty.items()))
            del self._dirty[key]
            try:
                if doc is None:
                    await self.kv.delete(self.prefix + key)
                else:
                    await self.kv.set(self.prefix + key, codec.packb(doc))
            except Exception as e:  # noqa: BLE001 - durability is best-effort
                self.persist_errors += 1
                logx.warn("cold-tier persist failed", key=key, err=str(e))

    async def flush(self) -> None:
        """Await every pending persist — the deterministic hook tests and
        the drain path use before asserting on the bus copy."""
        while self._dirty or (
            self._drain_task is not None and not self._drain_task.done()
        ):
            if self._drain_task is not None and not self._drain_task.done():
                await self._drain_task
            elif self._dirty:
                await self._drain()

    async def load(self) -> int:
        """Re-populate the RAM mirror from the journal (worker boot, after
        the bus is up).  A key already live in RAM wins over the journal;
        an unreadable doc is dropped and counted.  Returns docs loaded."""
        n = 0
        for full in await self.kv.keys(self.prefix):
            key = full[len(self.prefix):]
            if key in self:
                continue
            raw = await self.kv.get(full)
            if raw is None:
                continue
            try:
                doc = codec.unpackb(raw)
            except Exception as e:  # noqa: BLE001 - a bad doc must not block boot
                self.persist_errors += 1
                logx.warn("cold-tier doc unreadable", key=key, err=str(e))
                continue
            ColdArena.put(self, key, doc)  # mirror only: no re-persist
            n += 1
        self.loaded += n
        if n:
            logx.info("cold tier restored", docs=n, bytes=self.bytes)
        return n


@dataclass
class _Resident:
    """One conversation with restorable KV on this worker."""

    tokens: tuple  # the newest turn's written positions (the trie path key)
    last_used: float
    turns: int = 0
    cold_notified: bool = False  # on_hibernated fired for the current idle


@dataclass
class TieringStats:
    sweeps: int = 0
    hibernated_pages: int = 0
    restored_pages: int = 0
    sessions_hibernated: int = 0  # resident entries that went cold
    sessions_restored: int = 0


class SessionTiering:
    """Owns the resident-session registry and the hibernate sweep; one
    per engine, driven from the worker's event loop."""

    def __init__(
        self,
        cache: PrefixCache,
        *,
        hibernate_after_s: float = 0.0,
        export_page: Optional[
            Callable[[int], Awaitable[Optional[dict]]]
        ] = None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cache = cache
        self.hibernate_after_s = max(0.0, hibernate_after_s)
        # async page -> migration record (the engine wraps backend.export_kv);
        # None = backend cannot export (test fakes): sweep is a no-op
        self.export_page = export_page
        self.metrics = metrics
        self.clock = clock
        self.arena = ColdArena()  # live-session cold storage
        self._resident: dict[str, _Resident] = {}
        self.stats = TieringStats()
        # the worker publishes SessionMoved(reason="hibernated") from this
        # hook so the scheduler pins the session's affinity entry past the
        # normal TTL (strategy.py SESSION_HIBERNATE_TTL_S) — a cold
        # session routed elsewhere would silently re-prefill from scratch
        self.on_hibernated: Optional[Callable[[str], None]] = None
        self.on_restored: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------
    @property
    def resident_sessions(self) -> int:
        return len(self._resident)

    def tier_counts(self) -> tuple[int, int]:
        """(warm, cold) resident conversations.  Walks each entry's trie
        path — O(resident × pages/session), called from the capacity
        beacon's periodic snapshot, not any per-token path."""
        warm = 0
        for ent in self._resident.values():
            nodes = self.cache.match(list(ent.tokens), touch=False)
            if nodes and all(n.warm for n in nodes):
                warm += 1
        return warm, len(self._resident) - warm

    def note_turn(self, session_key: str, tokens: list[int]) -> None:
        """A turn for ``session_key`` just retired with its full pages
        registered in the prefix cache: (re)mark the conversation
        resident.  ``tokens`` are the turn's written positions — the key
        the next turn's prompt will extend."""
        if not session_key:
            return
        ent = self._resident.get(session_key)
        if ent is None:
            ent = self._resident[session_key] = _Resident(
                tokens=(), last_used=0.0
            )
        ent.tokens = tuple(tokens)
        ent.last_used = self.clock()
        ent.turns += 1
        ent.cold_notified = False
        self._gauge()

    def touch(self, session_key: str) -> None:
        """A new turn arrived: the conversation is active again."""
        ent = self._resident.get(session_key)
        if ent is not None:
            ent.last_used = self.clock()
            was_cold = ent.cold_notified
            ent.cold_notified = False
            if was_cold:
                self.stats.sessions_restored += 1
                if self.on_restored is not None:
                    try:
                        self.on_restored(session_key)
                    except Exception as e:  # noqa: BLE001 - hook is best-effort
                        logx.warn("on_restored hook failed", err=str(e))

    def forget(self, session_key: str) -> None:
        self._resident.pop(session_key, None)
        self._gauge()

    def _gauge(self) -> None:
        if self.metrics is not None:
            warm, cold = self.tier_counts()
            self.metrics.serving_resident_sessions.set(float(warm), tier="warm")
            self.metrics.serving_resident_sessions.set(float(cold), tier="cold")

    # ------------------------------------------------------------------
    async def sweep(self, now: Optional[float] = None) -> int:
        """Demote warm prefix nodes idle past the threshold: export each
        page to its host-RAM record, then release the device page.  The
        export awaits the device, so every demotion re-checks that the
        node was not evicted — and did not gain a live sharer — while the
        gather was in flight (``PrefixCache.demote`` refuses otherwise).
        Returns pages demoted."""
        if self.hibernate_after_s <= 0 or self.export_page is None:
            return 0
        now = self.clock() if now is None else now
        cutoff = now - self.hibernate_after_s
        demoted = 0
        for node in self.cache.hibernate_candidates(cutoff):
            try:
                record = await self.export_page(node.page)
            except Exception as e:  # noqa: BLE001 - keep the node warm
                logx.warn("hibernate export failed", page=node.page, err=str(e))
                continue
            if record is None:
                continue
            if self.cache.demote(node, record):
                demoted += 1
        self.stats.sweeps += 1
        self.stats.hibernated_pages += demoted
        if demoted:
            self._notify_cold(now)
            self._gauge()
        return demoted

    def _notify_cold(self, now: float) -> None:
        """Fire on_hibernated once per conversation that just went cold
        (any path node demoted) — the affinity-pinning trigger."""
        cutoff = now - self.hibernate_after_s
        for key, ent in self._resident.items():
            if ent.cold_notified or ent.last_used >= cutoff:
                continue
            nodes = self.cache.match(list(ent.tokens), touch=False)
            if not nodes or all(n.warm for n in nodes):
                continue
            ent.cold_notified = True
            self.stats.sessions_hibernated += 1
            if self.on_hibernated is not None:
                try:
                    self.on_hibernated(key)
                except Exception as e:  # noqa: BLE001 - hook is best-effort
                    logx.warn("on_hibernated hook failed", err=str(e))
