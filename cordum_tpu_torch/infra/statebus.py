"""Statebus: the framework's standalone state + message-bus server, and the
client a port process reaches it with.

One asyncio TCP server speaking a msgpack-framed protocol provides BOTH

  * the :class:`~cordum_tpu_torch.infra.kv.KV` surface (strings, hashes,
    z-sets, lists, sets, TTLs, versioned optimistic ``commit`` and the
    atomic ``pipe``) backed by the in-process :class:`MemoryKV` engine, and
  * pub/sub with NATS-style wildcard subjects and queue groups
    (:class:`StateBusBus` delivers into local handlers with the same
    RetryAfter redelivery semantics as the loopback bus).

Wire format: ``[4-byte BE length][msgpack array]`` (the port's codec,
``infra/codec.py``).  Requests: ``[req_id, op, *args]`` → ``[req_id,
"ok"|"err", result]``.  Server pushes: ``[0, "msg", sid, subject,
packet_bytes]`` and ``[0, "goaway"]`` on a graceful stop.

The port's server is one standalone partition (always primary): it has no
append-only file, no replication and no ``promote``/``demote``/
``repl_sync`` (ROADMAP: still to port).  The client half is whole: it
walks a ``|``-separated replica set, role-checks each dial when the set has
more than one endpoint, reconnects with jittered backoff, re-issues its
subscriptions and retransmits unacked requests after a failover, so it
runs against the reference's replicated servers as well as this one.
"""
from __future__ import annotations

import asyncio
import itertools
import os
import random
import time
from typing import Any, Optional

from ..protocol.partition import partition_of
from ..protocol.types import BusPacket
from ..utils.globmatch import subject_match
from . import logging as logx
from .bus import (
    Bus,
    DEDUP_WINDOW_S,
    MAX_NAK_DELAY_S,
    MAX_REDELIVERIES,
    RetryAfter,
    Subscription,
    compute_msg_id,
)
from .frames import FrameWriter as _FrameWriter, encode_frame as _encode, read_frame as _read_frame
from .kv import KV, MemoryKV
from .metrics import Metrics

# KV ops forwarded verbatim to the MemoryKV engine
_KV_OPS = frozenset((
    "get", "set", "setnx", "delete", "del_eq", "expire", "keys", "hset", "hget",
    "hgetall", "hdel", "hincrby", "zadd", "zrem", "zrange", "zrangebyscore", "zcard",
    "zscore", "rpush", "lrange", "ltrim", "llen", "sadd", "smembers", "version",
    "watch_read", "commit", "ping",
))


def _plain(v: Any) -> Any:
    """msgpack-safe: sets → sorted lists."""
    if isinstance(v, set):
        return sorted(v)
    return v


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


class StateBusServer:
    """One statebus partition: the KV engine and subscription routing."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7420, *,
                 partition: int = -1) -> None:
        self.host = host
        self.port = port
        # keyspace partition index this server serves (-1 = standalone);
        # rides the telemetry health beacon
        self.partition = partition
        self.kv = MemoryKV()
        self._server: Optional[asyncio.base_events.Server] = None
        # sid → (writer, pattern, queue)
        self._subs: dict[int, tuple[asyncio.StreamWriter, str, Optional[str]]] = {}
        self._sid = itertools.count(1)
        self._rr: dict[tuple[str, str], int] = {}
        self._dedup: dict[str, float] = {}
        self._writers: set[asyncio.StreamWriter] = set()
        self._fws: dict[asyncio.StreamWriter, _FrameWriter] = {}
        # per-op execution latency and pipeline sizes, rendered by the
        # `metrics` wire op (cordum_statebus_op_seconds)
        self.metrics = Metrics()
        self._telemetry = None  # TelemetryExporter, created at start()

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logx.info("statebus listening", host=self.host, port=self.port)
        # fleet telemetry beacon: the statebus IS the bus, so its exporter
        # routes snapshots straight to this server's own subscribers
        from ..obs.telemetry import TelemetryExporter

        async def _pub(subject: str, pkt: BusPacket) -> None:
            await self._route(subject, pkt.to_wire())

        self._telemetry = TelemetryExporter(
            "statebus", None, self.metrics,
            instance_id=f"statebus-{self.host}:{self.port}",
            health_fn=self._telemetry_health, publish=_pub,
        )
        await self._telemetry.start()

    async def stop(self) -> None:
        """GOAWAY to every client (they fail over or reconnect at once
        instead of waiting out call timeouts), then close."""
        if self._telemetry is not None:
            exporter, self._telemetry = self._telemetry, None
            await exporter.stop()
        goaway = _encode([0, "goaway"])
        for w in list(self._writers):
            try:
                w.write(goaway)
            except (ConnectionError, OSError, RuntimeError):
                pass  # peer already gone
        if self._server:
            self._server.close()
        # close client writers BEFORE wait_closed: Server.wait_closed() waits
        # for connection handlers, which block reading from live clients
        for w in list(self._writers):
            w.close()
        if self._server:
            await self._server.wait_closed()
            self._server = None

    def _telemetry_health(self) -> dict:
        return {"role": "statebus-primary", "partition": self.partition,
                "endpoint": f"{self.host}:{self.port}"}

    def _role_doc(self) -> dict:
        return {"role": "primary", "endpoint": f"{self.host}:{self.port}"}

    # -- connection handling -------------------------------------------
    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        fw = _FrameWriter(writer, self.metrics)
        self._fws[writer] = fw
        try:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    break
                # inline dispatch: KV ops are pure memory and replies are
                # buffered, so a connection's ops apply in arrival order
                await self._dispatch(frame, writer)
        finally:
            self._writers.discard(writer)
            self._fws.pop(writer, None)
            await fw.close()
            dead = [sid for sid, (w, _, _) in self._subs.items() if w is writer]
            for sid in dead:
                del self._subs[sid]
            writer.close()

    async def _send(self, writer: asyncio.StreamWriter, obj: list) -> None:
        fw = self._fws.get(writer)
        if fw is None:
            return
        try:
            fw.send(_encode(obj))
        except ConnectionError:
            pass  # peer mid-teardown; its handler cleans up

    async def _dispatch(self, frame: list, writer: asyncio.StreamWriter) -> None:
        req_id, op, *args = frame
        try:
            if req_id == 0:
                return  # a client notification (replica acks): no replica here
            if op in _KV_OPS:
                t0 = time.perf_counter()
                result = await getattr(self.kv, op)(*args)
                self.metrics.statebus_op_seconds.observe(time.perf_counter() - t0, op=op)
                await self._send(writer, [req_id, "ok", _plain(result)])
            elif op == "pipe":
                # one wire frame = one atomic multi-op batch: N mutations,
                # one round trip
                watches, ops = args
                t0 = time.perf_counter()
                ok, versions = await self.kv.pipe_execute(watches, ops)
                self.metrics.statebus_op_seconds.observe(time.perf_counter() - t0, op="pipe")
                self.metrics.kv_pipeline_size.observe(float(len(ops)))
                await self._send(writer, [req_id, "ok", [ok, versions]])
            elif op == "metrics":
                await self._send(writer, [req_id, "ok", self.metrics.render()])
            elif op == "role":
                await self._send(writer, [req_id, "ok", self._role_doc()])
            elif op == "sub":
                pattern, queue = args
                sid = next(self._sid)
                self._subs[sid] = (writer, pattern, queue or None)
                await self._send(writer, [req_id, "ok", sid])
            elif op == "unsub":
                self._subs.pop(args[0], None)
                await self._send(writer, [req_id, "ok", True])
            elif op == "pub":
                subject, packet_bytes = args
                await self._route(subject, packet_bytes)
                await self._send(writer, [req_id, "ok", True])
            else:
                await self._send(writer, [req_id, "err", f"unknown op {op!r}"])
        except Exception as e:  # noqa: BLE001
            try:
                await self._send(writer, [req_id, "err", str(e)])
            except Exception as send_err:  # noqa: BLE001 - peer already gone
                logx.debug("could not deliver error reply", err=str(send_err))

    async def _route(self, subject: str, packet_bytes: bytes) -> None:
        from ..protocol import subjects as subj

        if subj.is_durable_subject(subject):
            try:
                pkt = BusPacket.from_wire(packet_bytes)
                mid = compute_msg_id(subject, pkt)
            except Exception:
                mid = ""
            if mid:
                now = time.monotonic()
                if len(self._dedup) > 16384:
                    for k in list(itertools.islice(self._dedup, 8192)):
                        del self._dedup[k]
                seen = self._dedup.get(mid)
                if seen is not None and now - seen < DEDUP_WINDOW_S:
                    return
                self._dedup[mid] = now
        plain: list[tuple[int, asyncio.StreamWriter]] = []
        groups: dict[tuple[str, str], list[tuple[int, asyncio.StreamWriter]]] = {}
        for sid, (w, pattern, queue) in self._subs.items():
            if not subject_match(pattern, subject):
                continue
            if queue is None:
                plain.append((sid, w))
            else:
                groups.setdefault((pattern, queue), []).append((sid, w))
        for key, members in groups.items():
            members.sort()
            i = self._rr.get(key, 0)
            plain.append(members[i % len(members)])
            self._rr[key] = i + 1
        for sid, w in plain:
            try:
                await self._send(w, [0, "msg", sid, subject, packet_bytes])
            except Exception as e:  # noqa: BLE001 - one dead peer must not stop fanout
                logx.debug("dropping subscriber mid-fanout", sid=sid, err=str(e))


class _NotPrimary(ConnectionError):
    """Dialed endpoint is a replica; the failover walk tries the next one."""


#: ops never retransmitted across a reconnect: sub/unsub would duplicate or
#: kill the wrong sid (the registry re-issues subs itself), ping/role are
#: liveness probes whose answer is stale by definition after a failover
_NO_RETRANSMIT = frozenset(("sub", "unsub", "ping", "role"))


class StateBusConn:
    """Shared TCP connection: request/response + push routing + failover.

    Auto-reconnects with jittered exponential backoff when the connection
    drops, walking the partition's ``|``-separated replica set until it
    finds the current PRIMARY (each dial is role-checked when the set has
    more than one endpoint).  Unacked in-flight request frames are
    retransmitted on the fresh connection (version watches make a retried
    commit conflict, not double-apply).  Subscriptions are re-issued
    server-side on every reconnect; a server GOAWAY fails over
    immediately, and an optional ping loop turns black-holed connections
    (host died without FIN/RST) into failovers too.
    """

    def __init__(self, host: str, port: int, *, reconnect: bool = True,
                 max_backoff_s: float = 2.0,
                 endpoints: Optional[list[tuple[str, int]]] = None,
                 ping_interval_s: float = 0.0,
                 verify_primary: Optional[bool] = None) -> None:
        self.endpoints = [tuple(e) for e in (endpoints or [(host, port)])]
        self._ep_i = 0
        self.host, self.port = self.endpoints[0]
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._req_id = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        # unacked in-flight frames, replayed after failover: req_id → (op, frame)
        self._inflight: dict[int, tuple[str, bytes]] = {}
        self._handlers: dict[int, Any] = {}  # server sid → async handler(subject, bytes)
        self._reader_task: Optional[asyncio.Task] = None
        self._fw: Optional[_FrameWriter] = None
        self._closed = False
        self._reconnect = reconnect
        self._max_backoff_s = max_backoff_s
        self._connected = asyncio.Event()
        self._reconnect_task: Optional[asyncio.Task] = None
        # client-side subscription registry (survives reconnects):
        # local id → {pattern, queue, handler, sid, epoch}
        self._local_sid = itertools.count(1)
        self._subs: dict[int, dict] = {}
        self.reconnect_count = 0
        # bound via StateBusKV.bind_metrics: cordum_statebus_reconnects_total
        self.metrics: Any = None
        self._loss_reason = "connection_lost"
        # a single-endpoint conn skips the role round trip (standalone
        # servers are always primary); replica sets must verify, or a write
        # could land on a READONLY replica mid-promotion
        self._verify_primary = (len(self.endpoints) > 1
                                if verify_primary is None else verify_primary)
        self._ping_interval_s = ping_interval_s
        self._ping_task: Optional[asyncio.Task] = None
        # connection epoch: bumped on every successful dial; server sids are
        # only meaningful within the epoch that created them
        self._epoch = 0

    async def connect(self) -> None:
        await self._connect_cycle()
        self._connected.set()
        if self._ping_interval_s > 0:
            self._ping_task = asyncio.ensure_future(self._ping_loop())

    async def _dial(self) -> None:
        if self._reader_task is not None and not self._reader_task.done():
            # a reader for a dead connection must not linger (its tail would
            # spawn a second reconnect loop)
            self._reader_task.cancel()
        if self._fw is not None:
            await self._fw.close()
        if self._writer is not None:
            self._writer.close()
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._fw = _FrameWriter(self._writer)
        self._epoch += 1
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _connect_cycle(self) -> None:
        """One walk over the replica set; connects to the first PRIMARY, or
        raises the last failure."""
        last: Optional[Exception] = None
        for _ in range(len(self.endpoints)):
            self.host, self.port = self.endpoints[self._ep_i]
            try:
                await self._dial()
                if self._verify_primary:
                    doc = await self._call_now("role", timeout_s=3.0)
                    if not isinstance(doc, dict) or doc.get("role") != "primary":
                        raise _NotPrimary(f"{self.host}:{self.port} is not primary")
                return
            except (OSError, ConnectionError) as e:
                last = e
                self._ep_i = (self._ep_i + 1) % len(self.endpoints)
        raise last if last is not None else ConnectionError("no statebus endpoints")

    async def close(self) -> None:
        self._closed = True
        self._connected.set()  # release any call() waiting on reconnect
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._ping_task:
            self._ping_task.cancel()
        if self._reader_task:
            self._reader_task.cancel()
        if self._fw is not None:
            await self._fw.close()
        if self._writer:
            self._writer.close()
        # deliberate close: resolve pending calls quietly
        for fut in self._pending.values():
            if not fut.done():
                fut.set_result(None)
        self._pending.clear()
        self._inflight.clear()

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await _read_frame(self._reader)
                if frame is None:
                    break
                if frame[0] == 0:
                    kind = frame[1] if len(frame) > 1 else ""
                    if kind == "msg":
                        _, _, sid, subject, packet_bytes = frame
                        handler = self._handlers.get(sid)
                        if handler is not None:
                            asyncio.ensure_future(handler(subject, packet_bytes))
                        continue
                    if kind == "goaway":
                        # graceful server shutdown / demotion: fail over NOW
                        self._loss_reason = "goaway"
                        break
                    continue  # unknown push (replication traffic): not ours
                req_id, status, result = frame
                fut = self._pending.pop(req_id, None)
                self._inflight.pop(req_id, None)
                if fut is not None and not fut.done():
                    if status == "ok":
                        fut.set_result(result)
                    else:
                        fut.set_exception(RuntimeError(f"statebus: {result}"))
        except asyncio.CancelledError:
            raise  # deliberate teardown (close/_dial); no recovery tail
        except Exception:
            # ANY reader failure (OSError, a corrupt frame) falls into the
            # recovery tail below, or the client wedges with _connected set
            logx.warn("statebus read loop failed; treating as connection loss")
        # connection lost: keep in-flight calls parked for retransmission
        # (each still bounded by its own call timeout); only non-replayable
        # ops fail at once.  Then, unless closed, start the failover walk.
        self._connected.clear()
        for req_id, (op, _) in list(self._inflight.items()):
            if op in _NO_RETRANSMIT:
                fut = self._pending.pop(req_id, None)
                self._inflight.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_exception(ConnectionError("statebus connection lost"))
        if not self._closed and self._reconnect:
            t = self._reconnect_task
            if t is None or t.done():  # never two concurrent reconnect loops
                logx.warn("statebus connection lost; reconnecting",
                          host=self.host, port=self.port, reason=self._loss_reason)
                self._reconnect_task = asyncio.ensure_future(self._reconnect_loop())
        elif not self._closed:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("statebus connection lost"))
            self._pending.clear()
            self._inflight.clear()

    async def _reconnect_loop(self) -> None:
        backoff = 0.05
        reason = self._loss_reason
        while not self._closed:
            try:
                await self._connect_cycle()
                await self._resubscribe()
                self._retransmit_inflight()
                self.reconnect_count += 1
                if self.metrics is not None:
                    self.metrics.statebus_reconnects.inc(reason=reason)
                self._loss_reason = "connection_lost"
                logx.info("statebus reconnected", host=self.host, port=self.port,
                          subs=len(self._subs), inflight=len(self._inflight), reason=reason)
                self._connected.set()
                return
            except (OSError, ConnectionError):
                # jittered exponential backoff: a fleet failing over together
                # must not dial in lockstep
                self._connected.clear()
                await asyncio.sleep(backoff * (0.5 + random.random() / 2))
                backoff = min(backoff * 2, self._max_backoff_s)

    async def _resubscribe(self) -> None:
        """Re-issue every registered subscription on the fresh connection."""
        self._handlers.clear()
        for entry in list(self._subs.values()):
            sid = await self._call_now("sub", entry["pattern"], entry["queue"] or "")
            entry["sid"] = sid
            entry["epoch"] = self._epoch
            self._handlers[sid] = entry["handler"]

    def _retransmit_inflight(self) -> None:
        """Replay unacked request frames on the fresh connection, in send
        order (at-least-once, like bus redelivery)."""
        for req_id in sorted(self._inflight):
            _, frame = self._inflight[req_id]
            self._fw.send(frame)

    async def _ping_loop(self) -> None:
        """Liveness probe: a failed ping forces the transport closed so the
        recovery tail runs the failover walk."""
        while not self._closed:
            await asyncio.sleep(self._ping_interval_s)
            if self._closed or not self._connected.is_set():
                continue
            try:
                await self._call_now("ping", timeout_s=max(1.0, self._ping_interval_s))
            except ConnectionError:
                if self._connected.is_set() and self._writer is not None:
                    self._loss_reason = "ping_timeout"
                    logx.warn("statebus ping timed out; forcing failover",
                              host=self.host, port=self.port)
                    self._writer.close()

    # -- subscriptions (registry survives reconnects) -------------------
    async def subscribe(self, pattern: str, queue: str, handler) -> int:
        local = next(self._local_sid)
        # registered only AFTER the server ack: a subscribe that rides a
        # reconnect must not also be issued by _resubscribe
        sid = await self.call("sub", pattern, queue or "")
        self._subs[local] = {"pattern": pattern, "queue": queue,
                             "handler": handler, "sid": sid, "epoch": self._epoch}
        self._handlers[sid] = handler
        return local

    async def unsubscribe(self, local: int) -> None:
        entry = self._subs.pop(local, None)
        if entry is None:
            return
        sid = entry.get("sid")
        if sid is not None:
            self._handlers.pop(sid, None)
            if entry.get("epoch") != self._epoch or not self._connected.is_set():
                return  # the sid belongs to a dead connection
            try:
                await self._call_now("unsub", sid, timeout_s=2.0)
            except (ConnectionError, RuntimeError):
                pass  # the server cleans up on disconnect anyway

    # -- calls ----------------------------------------------------------
    async def call(self, op: str, *args: Any, timeout_s: float = 15.0) -> Any:
        if self._closed:
            raise ConnectionError("statebus connection closed")
        remaining = timeout_s
        if not self._connected.is_set():
            # disconnected: wait (bounded, out of the caller's budget) for
            # the reconnect loop to win
            t0 = time.monotonic()
            try:
                await asyncio.wait_for(self._connected.wait(), timeout_s)
            except asyncio.TimeoutError:
                raise ConnectionError(f"statebus call {op!r}: not connected after {timeout_s}s")
            if self._closed:
                raise ConnectionError("statebus connection closed")
            remaining = max(0.05, timeout_s - (time.monotonic() - t0))
        return await self._call_now(op, *args, timeout_s=remaining)

    async def _call_now(self, op: str, *args: Any, timeout_s: float = 15.0) -> Any:
        req_id = next(self._req_id)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        frame = _encode([req_id, op, *args])
        self._pending[req_id] = fut
        self._inflight[req_id] = (op, frame)
        try:
            # coalesced write: concurrent calls share one socket write a tick
            self._fw.send(frame)
        except (AttributeError, ConnectionError, OSError) as e:
            if op in _NO_RETRANSMIT or self._closed or not self._reconnect:
                self._pending.pop(req_id, None)
                self._inflight.pop(req_id, None)
                raise ConnectionError(f"statebus call {op!r} failed: {e}")
            # connection mid-teardown: the failover walk retransmits it
        try:
            # bounded: a half-open connection surfaces as an error
            return await asyncio.wait_for(fut, timeout_s)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            self._inflight.pop(req_id, None)
            raise ConnectionError(f"statebus call {op!r} timed out after {timeout_s}s")


def _str_keys(d: Optional[dict]) -> dict:
    return {k if isinstance(k, str) else k.decode(): v for k, v in (d or {}).items()}


class StateBusKV(KV):
    """KV interface over a statebus connection."""

    def __init__(self, conn: StateBusConn) -> None:
        self.conn = conn

    def bind_metrics(self, metrics: Any) -> None:
        super().bind_metrics(metrics)
        # the connection emits cordum_statebus_reconnects_total{reason}
        self.conn.metrics = metrics

    async def close(self) -> None:
        await self.conn.close()

    async def commit(self, watches: dict[str, int], ops: list[tuple]) -> bool:
        self._observe_op("commit")
        return await self.conn.call("commit", watches, [list(o) for o in ops])

    async def pipe_execute(
        self, watches: dict[str, int], ops: list[tuple]
    ) -> tuple[bool, dict[str, int]]:
        """One PIPE wire frame: the whole batch rides a single request and
        gets a single ``[ok, new_versions]`` reply."""
        self._observe_op("pipe", pipeline_size=len(ops))
        ok, versions = await self.conn.call("pipe", watches, [list(o) for o in ops])
        return bool(ok), _str_keys(versions)

    async def server_metrics(self) -> str:
        """Server-side metrics exposition (cordum_statebus_op_seconds etc.)."""
        return str(await self.conn.call("metrics"))


def _make_kv_method(op: str) -> Any:
    import inspect

    sig = inspect.signature(getattr(MemoryKV, op))

    async def method(self: StateBusKV, *args: Any, **kwargs: Any) -> Any:
        if kwargs:  # the server applies ops positionally: bind kwargs through
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            args = bound.args[1:]
            if bound.kwargs:
                args = (*args, *bound.kwargs.values())
        self._observe_op(op)
        result = await self.conn.call(op, *args)
        if op == "smembers" and isinstance(result, list):
            return set(result)
        if op == "hgetall" and isinstance(result, dict):
            return _str_keys(result)
        if op == "watch_read" and isinstance(result, (list, tuple)):
            ver, h = result
            return ver, _str_keys(h)
        return result

    method.__name__ = op
    return method


for _op in _KV_OPS - {"commit"}:
    setattr(StateBusKV, _op, _make_kv_method(_op))


class StateBusBus(Bus):
    """Bus interface over a statebus connection, with client-side RetryAfter
    redelivery (at-least-once on durable subjects)."""

    def __init__(self, conn: StateBusConn) -> None:
        self.conn = conn

    async def publish(self, subject: str, pkt: BusPacket) -> None:
        await self.conn.call("pub", subject, pkt.to_wire())

    async def subscribe(self, pattern: str, handler, *, queue: Optional[str] = None) -> Subscription:
        from ..protocol import subjects as subj

        async def deliver(subject: str, packet_bytes: bytes) -> None:
            # iterative redelivery, the requested delay capped
            attempt = 1
            while True:
                try:
                    pkt = BusPacket.from_wire(packet_bytes)
                    pkt.redelivery_count = attempt - 1
                    await handler(subject, pkt)
                    return
                except RetryAfter as ra:
                    if not subj.is_durable_subject(subject) or attempt >= MAX_REDELIVERIES:
                        logx.warn("dropping message after retries", subject=subject)
                        return
                    attempt += 1
                    await asyncio.sleep(min(max(ra.delay_s, 0.0), MAX_NAK_DELAY_S))
                except Exception:
                    logx.error("bus handler error", subject=subject)
                    return

        local = await self.conn.subscribe(pattern, queue or "", deliver)

        def _unsub() -> None:
            asyncio.ensure_future(self.conn.unsubscribe(local))

        return Subscription(_unsub)

    async def ping(self) -> bool:
        try:
            return bool(await self.conn.call("ping"))
        except Exception:
            return False


#: liveness-ping cadence for replica-set connections (black-hole detection);
#: single-endpoint connections skip the ping loop entirely
FAILOVER_PING_INTERVAL_S = 5.0


async def connect(url: str = "", *,
                  ping_interval_s: Optional[float] = None,
                  ) -> tuple[StateBusKV, StateBusBus, StateBusConn]:
    """Parse one partition's endpoint(s) (env CORDUM_STATEBUS_URL) and connect.

    ``url`` may be a single ``statebus://host:port`` or a ``|``-separated
    replica set (primary listed first); the connection walks the set on
    every connection loss until it finds the current primary.
    """
    url = url or os.environ.get("CORDUM_STATEBUS_URL", "statebus://127.0.0.1:7420")
    endpoints = parse_replica_set(url)
    if ping_interval_s is None:
        ping_interval_s = FAILOVER_PING_INTERVAL_S if len(endpoints) > 1 else 0.0
    conn = StateBusConn(*endpoints[0], endpoints=endpoints, ping_interval_s=ping_interval_s)
    await conn.connect()
    return StateBusKV(conn), StateBusBus(conn), conn


# ---------------------------------------------------------------------------
# partitioned statebus: N independent servers, clients route by keyspace
# ---------------------------------------------------------------------------

# Keys whose trailing segment is the routing id: every key of one job (or
# trace) lands on ONE partition, which keeps pipelined commits (always
# watched on job:meta:<id>) atomic on a single server.
_ID_ROUTED_PREFIXES = (
    "job:meta:", "job:events:", "job:request:", "job:safety:",
    "job:approval:", "lock:job:", "trace:spans:",
)

# Shared index containers whose members are job ids: each partition holds
# the slice for the ids it owns; writes route by member, reads fan out.
_MEMBER_ROUTED_EXACT = frozenset(("job:recent", "job:deadline"))
_MEMBER_ROUTED_PREFIXES = ("job:index:", "job:tenant_active:", "trace:")


def _route_key(key: str) -> str:
    for p in _ID_ROUTED_PREFIXES:
        if key.startswith(p):
            return key[len(p):] or key
    # workflow state co-locates on ONE partition (a run's pipelined commit
    # spans its blob and shared indexes)
    if key.startswith("wf:"):
        return "wf:"
    return key


def _member_routed(key: str) -> bool:
    if key in _MEMBER_ROUTED_EXACT:
        return True
    if key.startswith("trace:spans:"):
        return False  # id-routed
    return key.startswith(_MEMBER_ROUTED_PREFIXES)


class PartitionedKV(KV):
    """KV facade over N statebus partitions (docs/PROTOCOL.md §Partitioning).

    Point ops route by :func:`_route_key` hash; member-routed index
    containers write to ``partition_of(member)`` and merge reads across
    every partition (union / sum).  A pipeline executes atomically on the
    partition of its first watched key.  One partition is that partition's
    own client: no routing layer.
    """

    def __new__(cls, parts: list[KV]) -> Any:
        parts = list(parts)
        if len(parts) == 1:
            return parts[0]
        return super().__new__(cls)

    def __init__(self, parts: list[KV]) -> None:
        self.parts = list(parts)
        self.n = len(self.parts)

    def bind_metrics(self, metrics: Any) -> None:
        self.metrics = metrics
        for p in self.parts:
            p.bind_metrics(metrics)

    def _one(self, key: str) -> KV:
        if _member_routed(key):
            return self.parts[0]  # deterministic home for member-routed point ops
        return self.parts[partition_of(_route_key(key), self.n)]

    def _by_member(self, member: str) -> KV:
        return self.parts[partition_of(member, self.n)]

    async def _grouped(self, op: str, key: str, members: tuple) -> int:
        grouped: dict[int, list[str]] = {}
        for m in members:
            grouped.setdefault(partition_of(m, self.n), []).append(m)
        counts = await asyncio.gather(
            *(getattr(self.parts[i], op)(key, *ms) for i, ms in grouped.items()))
        return sum(counts)

    # strings -------------------------------------------------------------
    async def get(self, key):
        return await self._one(key).get(key)

    async def set(self, key, value, ttl_s=None):
        return await self._one(key).set(key, value, ttl_s)

    async def setnx(self, key, value, ttl_s=None):
        return await self._one(key).setnx(key, value, ttl_s)

    async def delete(self, *keys):
        grouped: dict[int, list[str]] = {}
        for k in keys:
            if _member_routed(k):
                for i in range(self.n):  # slices live on every partition
                    grouped.setdefault(i, []).append(k)
            else:
                grouped.setdefault(partition_of(_route_key(k), self.n), []).append(k)
        counts = await asyncio.gather(*(self.parts[i].delete(*ks) for i, ks in grouped.items()))
        return sum(counts)

    async def del_eq(self, key, expect):
        return await self._one(key).del_eq(key, expect)

    async def expire(self, key, ttl_s):
        if _member_routed(key):
            return any(await asyncio.gather(*(p.expire(key, ttl_s) for p in self.parts)))
        return await self._one(key).expire(key, ttl_s)

    async def keys(self, prefix=""):
        lists = await asyncio.gather(*(p.keys(prefix) for p in self.parts))
        return sorted({k for ks in lists for k in ks})

    # hashes --------------------------------------------------------------
    async def hset(self, key, mapping):
        return await self._one(key).hset(key, mapping)

    async def hget(self, key, field):
        return await self._one(key).hget(key, field)

    async def hgetall(self, key):
        return await self._one(key).hgetall(key)

    async def hdel(self, key, *fields):
        return await self._one(key).hdel(key, *fields)

    async def hincrby(self, key, field, amount=1):
        return await self._one(key).hincrby(key, field, amount)

    # sorted sets ---------------------------------------------------------
    async def zadd(self, key, member, score):
        if _member_routed(key):
            return await self._by_member(member).zadd(key, member, score)
        return await self._one(key).zadd(key, member, score)

    async def zrem(self, key, *members):
        if _member_routed(key):
            return await self._grouped("zrem", key, members)
        return await self._one(key).zrem(key, *members)

    async def zrange(self, key, start=0, stop=-1, desc=False):
        if not _member_routed(key):
            return await self._one(key).zrange(key, start, stop, desc)
        # merged listing: per-partition order exact, cross-partition
        # approximate (observability surfaces only)
        lists = await asyncio.gather(*(p.zrange(key, 0, stop, desc) for p in self.parts))
        merged = [m for ms in lists for m in ms]
        return merged[start:] if stop == -1 else merged[start: stop + 1]

    async def zrangebyscore(self, key, min_score, max_score, limit=0):
        if not _member_routed(key):
            return await self._one(key).zrangebyscore(key, min_score, max_score, limit)
        lists = await asyncio.gather(
            *(p.zrangebyscore(key, min_score, max_score, limit) for p in self.parts))
        merged = [m for ms in lists for m in ms]
        return merged[:limit] if limit else merged

    async def zcard(self, key):
        if not _member_routed(key):
            return await self._one(key).zcard(key)
        return sum(await asyncio.gather(*(p.zcard(key) for p in self.parts)))

    async def zscore(self, key, member):
        if _member_routed(key):
            return await self._by_member(member).zscore(key, member)
        return await self._one(key).zscore(key, member)

    # lists ---------------------------------------------------------------
    async def rpush(self, key, *values):
        return await self._one(key).rpush(key, *values)

    async def lrange(self, key, start=0, stop=-1):
        return await self._one(key).lrange(key, start, stop)

    async def ltrim(self, key, start, stop):
        return await self._one(key).ltrim(key, start, stop)

    async def llen(self, key):
        return await self._one(key).llen(key)

    # sets ----------------------------------------------------------------
    async def sadd(self, key, *members):
        if _member_routed(key):
            return await self._grouped("sadd", key, members)
        return await self._one(key).sadd(key, *members)

    async def smembers(self, key):
        if not _member_routed(key):
            return await self._one(key).smembers(key)
        out: set[str] = set()
        for s in await asyncio.gather(*(p.smembers(key) for p in self.parts)):
            out |= s
        return out

    # transactions --------------------------------------------------------
    async def version(self, key):
        return await self._one(key).version(key)

    async def watch_read(self, key):
        return await self._one(key).watch_read(key)

    def pipe_group(self, key: str) -> int:
        """Keys on the same partition may share one grouped pipe commit."""
        if _member_routed(key):
            return 0
        return partition_of(_route_key(key), self.n)

    def _pipe_part(self, watches: dict[str, int], ops: list[tuple]) -> KV:
        for key in watches:
            return self._one(key)
        for op in ops:
            if len(op) > 1 and isinstance(op[1], str):
                return self._one(op[1])
        return self.parts[0]

    async def commit(self, watches, ops):
        return await self._pipe_part(watches, ops).commit(watches, ops)

    async def pipe_execute(self, watches, ops):
        return await self._pipe_part(watches, ops).pipe_execute(watches, ops)

    async def ping(self):
        return all(await asyncio.gather(*(p.ping() for p in self.parts)))

    async def close(self):
        await asyncio.gather(*(p.close() for p in self.parts), return_exceptions=True)


class PartitionedBus(Bus):
    """Bus facade over N statebus partitions: a concrete subject lives on
    ONE partition (hash of the subject), so queue-group and dedupe
    semantics stay exact per subject; wildcard patterns are subscribed on
    every partition."""

    def __new__(cls, buses: list[Bus]) -> Any:
        buses = list(buses)
        if len(buses) == 1:
            return buses[0]
        return super().__new__(cls)

    def __init__(self, buses: list[Bus]) -> None:
        self.buses = list(buses)
        self.n = len(self.buses)

    def _bus_for(self, subject: str) -> Bus:
        return self.buses[partition_of(subject, self.n)]

    async def publish(self, subject: str, pkt: BusPacket) -> None:
        await self._bus_for(subject).publish(subject, pkt)

    def has_listener(self, subject: str) -> bool:
        return self._bus_for(subject).has_listener(subject)

    async def subscribe(self, pattern: str, handler, *, queue: Optional[str] = None) -> Subscription:
        if "*" in pattern or ">" in pattern:
            subs = await asyncio.gather(
                *(b.subscribe(pattern, handler, queue=queue) for b in self.buses))

            def _unsub_all() -> None:
                for s in subs:
                    s.unsubscribe()

            return Subscription(_unsub_all)
        return await self._bus_for(pattern).subscribe(pattern, handler, queue=queue)

    async def ping(self) -> bool:
        return all(await asyncio.gather(*(b.ping() for b in self.buses)))


class ConnGroup:
    """Close-handle over the N connections behind a partitioned client."""

    def __init__(self, conns: list[StateBusConn]) -> None:
        self.conns = list(conns)

    async def close(self) -> None:
        await asyncio.gather(*(c.close() for c in self.conns), return_exceptions=True)


async def connect_partitioned(url: str = "") -> tuple[KV, Bus, ConnGroup]:
    """Connect to one or more statebus partitions.

    ``url`` is a comma-separated list of partitions (env
    ``CORDUM_STATEBUS_URL``); each partition is a single
    ``statebus://host:port`` endpoint or a ``|``-separated replica set.  A
    single partition is the plain client in the same close-handle.
    """
    url = url or os.environ.get("CORDUM_STATEBUS_URL", "statebus://127.0.0.1:7420")
    endpoints = [u.strip() for u in url.split(",") if u.strip()]
    if len(endpoints) <= 1:
        kv, bus, conn = await connect(endpoints[0] if endpoints else "")
        return kv, bus, ConnGroup([conn])
    kvs: list[KV] = []
    buses: list[Bus] = []
    conns: list[StateBusConn] = []
    for ep in endpoints:
        kv, bus, conn = await connect(ep)
        kvs.append(kv)
        buses.append(bus)
        conns.append(conn)
    return PartitionedKV(kvs), PartitionedBus(buses), ConnGroup(conns)
