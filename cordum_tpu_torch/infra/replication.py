"""Statebus primary/replica replication (docs/PROTOCOL.md §Replication).

The partitioned statebus made each partition the single point of durability
(one process, one AOF).  This module removes that: a **primary** ships every
committed AOF record — the PIPE frame is the atomic unit — to attached
**replicas** over the existing frame protocol, replicas apply + ack them,
and on primary failure a replica is promoted (admin ``promote`` frame or
automatic takeover on heartbeat timeout) while clients walk the partition's
replica set and fail over.

Replication stream model (Redis-style replication id ≈ ``epoch``):

* ``offset`` — count of committed data records since genesis.  The primary
  numbers every record; replicas adopt the primary's numbering, so equal
  (epoch, offset) ⇒ byte-identical state (versions included — snapshots
  preserve per-key versions so failed-over clients keep valid watches).
* ``epoch`` — bumped on every promotion and persisted in the AOF (a
  ``repl_meta`` record).  A rejoining server whose epoch differs from the
  current primary's has a potentially divergent history and is re-seeded
  with a full snapshot; same-epoch replicas catch up incrementally from
  the primary's record backlog.
* **ack modes** — async by default (commit acks the client immediately;
  loss on primary death is bounded to the unacked replication window);
  ``sync_replication`` makes every commit wait for one replica ack before
  the client sees ``ok``, so an acked commit can never be lost to a single
  node failure.  A replica that stops acking degrades sync→async after
  ``sync_timeout_s`` (counted) rather than holding the partition hostage.

Promotion is exclusive: promotion bumps the epoch, and a returning old
primary probes its peer set at startup — finding a live primary with a
higher epoch, it demotes itself to replica (its unreplicated tail, if any,
is discarded by the snapshot re-seed: exactly the async-mode loss window).

Wire additions (all ride the existing ``[len][msgpack]`` framing; the
msgpack is the port's codec, ``infra/codec.py``):

==================================  =======================================
``[rid,"repl_sync",id,epoch,off]``  replica handshake → ``["incremental",
                                    epoch, offset]`` or ``["snapshot",
                                    epoch, offset]`` (snapshot pushed next)
``[0,"repl",offset,record]``        one committed record (primary→replica)
``[0,"repl_snap",epoch,off,blob]``  full state snapshot (primary→replica)
``[0,"repl_hb",epoch,offset]``      primary liveness + lag beacon
``[0,"repl_ack",offset]``           replica applied-through ack
``[rid,"promote"]``                 admin promotion (replica → primary)
``[rid,"role"]``                    role/offset/epoch/lag status
``[0,"goaway"]``                    graceful shutdown: fail over NOW
==================================  =======================================
"""
from __future__ import annotations

import asyncio
import collections
import time
from typing import Any, Optional, TYPE_CHECKING

from . import logging as logx
from .codec import packb, unpackb
from .frames import FrameWriter, encode_frame, read_frame

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (statebus imports us)
    from .statebus import StateBusServer

#: committed records the primary retains for incremental replica catch-up;
#: a replica further behind than this is re-seeded with a full snapshot
DEFAULT_BACKLOG = 4096

#: how long a sync-mode commit waits for a replica ack before degrading to
#: async for that commit (counted via cordum_statebus_sync_ack_timeouts_total)
SYNC_ACK_TIMEOUT_S = 5.0


def pack_record(op: str, args: tuple) -> bytes:
    """One AOF/replication record: the same msgpack entry the AOF stores
    (the reference's bytes, through the port's codec)."""
    return packb([op, *args])


def unpack_record(rec: bytes) -> list:
    return unpackb(rec)


class _ReplicaSession:
    """Primary-side state for one attached replica connection."""

    __slots__ = ("replica_id", "fw", "acked_offset", "sent_offset",
                 "sent_bytes", "acked_bytes", "lag_published_at")

    def __init__(self, replica_id: str, fw: FrameWriter) -> None:
        self.replica_id = replica_id
        self.fw = fw
        self.acked_offset = 0
        self.sent_offset = 0
        self.sent_bytes = 0
        self.acked_bytes = 0
        self.lag_published_at = 0.0


class ReplicationState:
    """Primary-side replication bookkeeping, owned by a StateBusServer.

    Always active (even with zero replicas): ``offset`` numbers every
    committed record and the backlog retains the recent tail, so a replica
    may attach at any time and catch up incrementally.
    """

    def __init__(self, server: "StateBusServer", *, backlog: int = DEFAULT_BACKLOG,
                 sync_timeout_s: float = SYNC_ACK_TIMEOUT_S) -> None:
        self.server = server
        self.epoch = 0
        self.offset = 0
        self.bytes_total = 0
        self.sync_timeout_s = sync_timeout_s
        # (offset, record_bytes, cumulative_bytes) ring of the recent tail
        self.backlog: collections.deque[tuple[int, bytes, int]] = (
            collections.deque(maxlen=backlog))
        self.sessions: dict[Any, _ReplicaSession] = {}  # writer → session
        self._waiters: list[tuple[int, asyncio.Future]] = []

    # -- primary commit path -------------------------------------------
    @property
    def replica_count(self) -> int:
        return len(self.sessions)

    def advance(self, rec: bytes) -> int:
        """Number a freshly committed record and fan it out to replicas.

        Called synchronously right after the engine applied the mutation
        (no awaits in between — offset order IS commit order)."""
        self.offset += 1
        self.bytes_total += len(rec)
        self.backlog.append((self.offset, rec, self.bytes_total))
        if self.sessions:
            frame = encode_frame([0, "repl", self.offset, rec])
            for w, sess in list(self.sessions.items()):
                try:
                    sess.fw.send(frame)
                    sess.sent_offset = self.offset
                    sess.sent_bytes = self.bytes_total
                except ConnectionError:
                    self.detach(w)
            m = self.server.metrics
            m.statebus_repl_records.inc(amount=float(len(self.sessions) or 1))
        return self.offset

    def covers(self, offset: int) -> bool:
        """Can a replica at ``offset`` catch up from the backlog alone?"""
        return offset >= self.offset - len(self.backlog)

    def records_after(self, offset: int) -> list[bytes]:
        return [encode_frame([0, "repl", off, rec])
                for off, rec, _ in self.backlog if off > offset]

    # -- replica sessions ----------------------------------------------
    def attach(self, writer: Any, replica_id: str, fw: FrameWriter,
               start_offset: int) -> _ReplicaSession:
        sess = _ReplicaSession(replica_id or f"replica-{id(writer):x}", fw)
        sess.acked_offset = start_offset
        self.sessions[writer] = sess
        self._update_lag(sess)
        return sess

    def detach(self, writer: Any) -> None:
        sess = self.sessions.pop(writer, None)
        if sess is not None:
            logx.warn("replica detached", replica=sess.replica_id,
                      acked=sess.acked_offset, primary_offset=self.offset)

    def on_ack(self, writer: Any, offset: int) -> None:
        sess = self.sessions.get(writer)
        if sess is None:
            return
        sess.acked_offset = max(sess.acked_offset, int(offset))
        # cumulative bytes at the acked offset: backlog offsets are dense
        # and sequential, so the entry is at a computable index — O(1)-ish
        # deque access near the tail, never a scan (acks arrive once per
        # record on the hot path; an ack older than the backlog pins
        # lag_bytes at the full sent window)
        if self.backlog:
            first = self.offset - len(self.backlog) + 1
            idx = sess.acked_offset - first
            if 0 <= idx < len(self.backlog):
                sess.acked_bytes = self.backlog[idx][2]
        self._update_lag(sess)
        if self._waiters:
            still = []
            for target, fut in self._waiters:
                if sess.acked_offset >= target:
                    if not fut.done():
                        fut.set_result(True)
                else:
                    still.append((target, fut))
            self._waiters = still

    def _update_lag(self, sess: _ReplicaSession) -> None:
        # throttled: acks arrive once per committed record, and labeled
        # gauge sets are not free — lag is an observability surface, so a
        # 50ms-stale reading is fine (caught-up sessions always publish,
        # keeping the gauge exact at zero lag)
        now = time.monotonic()
        if sess.acked_offset < self.offset and now - sess.lag_published_at < 0.05:
            return
        sess.lag_published_at = now
        m = self.server.metrics
        m.statebus_repl_lag_ops.set(
            float(self.offset - sess.acked_offset), replica=sess.replica_id)
        m.statebus_repl_lag_bytes.set(
            float(max(0, self.bytes_total - (sess.acked_bytes or 0))),
            replica=sess.replica_id)

    def min_acked(self) -> int:
        if not self.sessions:
            return self.offset
        return min(s.acked_offset for s in self.sessions.values())

    # -- sync-ack mode --------------------------------------------------
    async def wait_synced(self, offset: int) -> bool:
        """Block a sync-mode commit until ONE replica acked ``offset``.

        Degrades (returns False, counted) after ``sync_timeout_s`` so a
        dead replica cannot make the partition unavailable for writes."""
        if not self.sessions:
            return False
        for sess in self.sessions.values():
            if sess.acked_offset >= offset:
                return True
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append((offset, fut))
        try:
            await asyncio.wait_for(fut, self.sync_timeout_s)
            return True
        except asyncio.TimeoutError:
            self.server.metrics.statebus_sync_ack_timeouts.inc()
            logx.warn("sync replication ack timed out; commit proceeds async",
                      offset=offset, replicas=len(self.sessions))
            return False

    def fail_waiters(self) -> None:
        for _, fut in self._waiters:
            if not fut.done():
                fut.set_result(False)
        self._waiters = []

    def status(self) -> dict:
        return {
            "epoch": self.epoch,
            "offset": self.offset,
            "replicas": [
                {"id": s.replica_id, "acked_offset": s.acked_offset,
                 "lag_ops": self.offset - s.acked_offset}
                for s in self.sessions.values()
            ],
        }


class ReplicaLink:
    """Replica-side pump: dial the primary, hand-shake at our (epoch,
    offset), apply the record stream, ack, and watch for primary death.

    Primary-dead detection: no frame (record, heartbeat or snapshot) inside
    ``heartbeat_timeout_s`` — including time spent failing to reconnect —
    promotes this server when ``auto_promote`` is set; a GOAWAY from a
    gracefully stopping primary promotes immediately.
    """

    def __init__(self, server: "StateBusServer", host: str, port: int, *,
                 replica_id: str = "", auto_promote: bool = True,
                 heartbeat_timeout_s: float = 3.0) -> None:
        self.server = server
        self.host = host
        self.port = port
        self.replica_id = replica_id or f"{server.host}:{server.port}"
        self.auto_promote = auto_promote
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.connected = asyncio.Event()
        self.primary_offset = 0
        self.last_sync_mode = ""  # "incremental" | "snapshot" (tests/status)
        self._last_seen = time.monotonic()
        self._stop = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._stop.clear()
        self._last_seen = time.monotonic()
        self._task = asyncio.ensure_future(self._run())

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        self._stop.set()
        task, self._task = self._task, None
        if task is None or task is asyncio.current_task():
            return
        # Cancel-until-dead: on 3.10 a cancel landing exactly as wait_for's
        # inner read completes is swallowed (bpo-42130) and the pump keeps
        # running — possibly into server.promote(), which needs the very
        # _role_lock our caller holds while joining us.  Re-cancel until the
        # task actually finishes so the join below cannot deadlock.
        while not task.done():
            task.cancel()
            await asyncio.wait([task], timeout=0.1)
        await logx.join_task(task, name="replica-link")

    # -- internals ------------------------------------------------------
    def _dead_for(self) -> float:
        return time.monotonic() - self._last_seen

    async def _maybe_promote(self, reason: str) -> bool:
        if not self.auto_promote:
            return False
        await self.server.promote(reason=reason)
        return True

    async def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set() and self.server.role == "replica":
            writer = None
            try:
                reader, writer = await asyncio.open_connection(self.host, self.port)
                fw = FrameWriter(writer)
                try:
                    await self._pump(reader, fw)
                finally:
                    await fw.close()
            except asyncio.CancelledError:
                raise
            except (OSError, ConnectionError):
                pass
            except Exception:
                logx.error("replica link failed; retrying")
            finally:
                self.connected.clear()
                if writer is not None:
                    writer.close()
            if self._stop.is_set() or self.server.role != "replica":
                return
            if self._dead_for() > self.heartbeat_timeout_s:
                if await self._maybe_promote("primary-dead"):
                    return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 1.0)

    async def _pump(self, reader: asyncio.StreamReader, fw: FrameWriter) -> None:
        repl = self.server.repl
        fw.send(encode_frame([1, "repl_sync", self.replica_id,
                              repl.epoch, repl.offset]))
        # the handshake reply precedes any stream push on this connection
        frame = await asyncio.wait_for(read_frame(reader),
                                       max(self.heartbeat_timeout_s, 5.0))
        if frame is None:
            raise ConnectionError("primary hung up during handshake")
        if frame[0] == 1 and frame[1] == "err":
            # peer is not (yet) a primary — back off and retry; promotion
            # or peer recovery will flip it
            raise ConnectionError(f"repl_sync rejected: {frame[2]}")
        mode, p_epoch, p_offset = frame[2]
        self.last_sync_mode = mode
        self.primary_offset = int(p_offset)
        if mode == "incremental":
            # same history: adopt the primary's epoch (first sync only)
            await self.server.adopt_epoch(int(p_epoch))
        self._last_seen = time.monotonic()
        self.connected.set()
        logx.info("replica link established", primary=f"{self.host}:{self.port}",
                  mode=mode, offset=repl.offset, primary_offset=p_offset)
        while not self._stop.is_set():
            try:
                frame = await asyncio.wait_for(read_frame(reader), 0.25)
            except asyncio.TimeoutError:
                if self._dead_for() > self.heartbeat_timeout_s:
                    if await self._maybe_promote("primary-dead"):
                        return
                    raise ConnectionError("primary heartbeat timeout")
                continue
            if frame is None:
                raise ConnectionError("primary connection lost")
            self._last_seen = time.monotonic()
            kind = frame[1] if len(frame) > 1 else ""
            if frame[0] == 0 and kind == "repl":
                _, _, offset, rec = frame
                await self.server.apply_replicated(rec, int(offset))
                fw.send(encode_frame([0, "repl_ack", self.server.repl.offset]))
            elif frame[0] == 0 and kind == "repl_snap":
                _, _, epoch, offset, blob = frame
                await self.server.load_replicated_snapshot(
                    int(epoch), int(offset), blob)
                fw.send(encode_frame([0, "repl_ack", self.server.repl.offset]))
            elif frame[0] == 0 and kind == "repl_hb":
                self.primary_offset = int(frame[3])
            elif frame[0] == 0 and kind == "goaway":
                # graceful primary shutdown: promote NOW instead of waiting
                # out the heartbeat timeout
                if await self._maybe_promote("primary-goaway"):
                    return
                raise ConnectionError("primary sent goaway")
            # replies to stray requests and unknown pushes are ignored


async def admin_call(host: str, port: int, op: str, *args: Any,
                     timeout_s: float = 1.0) -> Optional[Any]:
    """One-shot request against a statebus endpoint on a fresh connection.

    Returns the ``ok`` result or None when the endpoint is unreachable,
    unresponsive, or answered ``err`` — used by startup peer probing
    (split-brain demotion) and the chaos harness's readiness probe.
    """
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s)
    except (OSError, asyncio.TimeoutError):
        return None
    try:
        writer.write(encode_frame([1, op, *args]))
        await asyncio.wait_for(writer.drain(), timeout_s)
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            frame = await asyncio.wait_for(read_frame(reader), remaining)
            if frame is None:
                return None
            if frame[0] == 1:
                return frame[2] if frame[1] == "ok" else None
    except (OSError, ConnectionError, asyncio.TimeoutError):
        return None
    finally:
        writer.close()


async def probe_role(host: str, port: int, *, timeout_s: float = 1.0) -> Optional[dict]:
    """One-shot ``role`` query ({role, epoch, offset, ...}) or None."""
    doc = await admin_call(host, port, "role", timeout_s=timeout_s)
    return doc if isinstance(doc, dict) else None


def parse_endpoint(url: str) -> tuple[str, int]:
    """``statebus://host:port`` (scheme optional) → ``(host, port)``."""
    hostport = url.split("://", 1)[-1]
    host, _, port = hostport.partition(":")
    return host or "127.0.0.1", int(port or 7420)


def parse_replica_set(url: str) -> list[tuple[str, int]]:
    """One partition's ``|``-separated replica set → endpoint list.

    ``statebus://h:7420|statebus://h:7520`` lists the primary first; clients
    walk the list on connection loss until they find the current primary.
    """
    return [parse_endpoint(u.strip()) for u in url.split("|") if u.strip()]
