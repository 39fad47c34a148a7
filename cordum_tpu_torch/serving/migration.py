"""Live KV-page migration: the session-transfer protocol (docs/PROTOCOL.md
§Page transfer; docs/SERVING.md §Migration, drain, and failover).

A serving session's state — KV pages at their true lengths, page table
shape, positions, prefill progress, sampled tokens — streams worker→worker
as msgpack records over the statebus frame layer (``infra/frames``), the
same ``[4-byte BE length][msgpack array]`` framing the AOF-shipping
replication link uses.  The shape is deliberately the replication link's: pages
as records, a ``(session, offset)`` handshake so a severed link resumes
where it left off, and a final **freeze-and-delta** step so decode pauses
only for the last chunk:

  1. ``["hello", {session, meta}]`` → ``["ok", {session, offset}]`` — the
     receiver reports how many page records it already holds (0 for a
     fresh transfer; its partial count when the sender reconnects after a
     sever), and the sender resumes from there.
  2. ``["page", {session, offset, rec}]`` — one page record per frame,
     offset-sequenced.  Only pages FULLY below the decode position ride
     this live phase: they are immutable while the session keeps decoding,
     so the bulk of the KV cache ships with zero pause.
  3. ``["commit", {session, offset, state, delta}]`` — the sender freezes
     the session (it sits out the step loop), waits for the in-flight step
     to quiesce, then ships the remaining dirty pages plus the mutable
     decode state in one frame.  The receiver scatters everything into
     freshly allocated arena blocks, resumes the session, and replies
     ``["done", {session}]`` — from which point it owns the token stream
     and the terminal result.  ``["error", {session, msg}]`` aborts; the
     sender unfreezes and falls back to a scheduler requeue.
  4. ``["abort", {session}]`` — sender-side abandonment (session finished
     or was cancelled mid-transfer); the receiver drops its partial state.

The resumed session is token-identical to an unmigrated one: greedy decode
over the same pages at the same positions (property-tested against the
sequential oracle in tests/test_serving_failover.py).
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Awaitable, Callable, Optional

from ..infra import logging as logx
from ..infra.frames import encode_frame, read_frame

# install(meta, state, records) — adopt a committed session (worker side)
InstallFn = Callable[[dict, dict, list], Awaitable[None]]

DEFAULT_TIMEOUT_S = 30.0


class MigrationError(Exception):
    """The transfer failed (refused, capacity, protocol mismatch); the
    sender falls back to a scheduler requeue — never a lost session."""


class _Partial:
    """Page records received so far for one in-flight session transfer
    (survives connection drops: the (session, offset) resume state)."""

    __slots__ = ("meta", "records", "started_at")

    def __init__(self, meta: dict) -> None:
        self.meta = meta
        self.records: list[dict] = []
        self.started_at = time.monotonic()


class MigrationServer:
    """Per-worker listener adopting migrated-in sessions.

    Binds ``host:port`` (port 0 = OS-assigned; the worker advertises the
    bound address via its heartbeat ``cordum.migrate_addr`` label) and
    drives the receive side of the protocol above.  ``install`` is the
    worker's adoption callback — it raises to refuse (capacity, duplicate,
    stopped), which surfaces to the sender as an ``error`` frame."""

    def __init__(
        self,
        install: InstallFn,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics: Any = None,
        partial_ttl_s: float = 120.0,
    ) -> None:
        self.install = install
        self.host = host
        self.port = port
        self.metrics = metrics
        self.partial_ttl_s = partial_ttl_s
        self._server: Optional[asyncio.base_events.Server] = None
        self._partial: dict[str, _Partial] = {}

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logx.info("migration listener up", addr=self.addr)

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self._partial.clear()

    def _gc_partials(self) -> None:
        cutoff = time.monotonic() - self.partial_ttl_s
        for sid in [s for s, p in self._partial.items() if p.started_at < cutoff]:
            del self._partial[sid]

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        async def reply(frame: list) -> None:
            writer.write(encode_frame(frame))
            await writer.drain()

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    return
                op, body = frame[0], frame[1] if len(frame) > 1 else {}
                sid = str(body.get("session", ""))
                if op == "hello":
                    self._gc_partials()
                    part = self._partial.get(sid)
                    if part is None:
                        part = self._partial[sid] = _Partial(body.get("meta") or {})
                    else:
                        part.meta = body.get("meta") or part.meta
                    await reply(["ok", {"session": sid,
                                        "offset": len(part.records)}])
                elif op == "page":
                    part = self._partial.get(sid)
                    if part is None:
                        await reply(["error", {"session": sid,
                                               "msg": "no hello for session"}])
                        continue
                    off = int(body.get("offset", -1))
                    if off == len(part.records):
                        part.records.append(body.get("rec") or {})
                    elif off > len(part.records):
                        await reply(["error", {
                            "session": sid,
                            "msg": f"page offset {off} skips "
                                   f"{len(part.records)}"}])
                    # off < len(records): duplicate from a resume replay — drop
                elif op == "commit":
                    part = self._partial.pop(sid, None)
                    if part is None:
                        await reply(["error", {"session": sid,
                                               "msg": "no transfer state"}])
                        continue
                    off = int(body.get("offset", -1))
                    if off != len(part.records):
                        await reply(["error", {
                            "session": sid,
                            "msg": f"commit at offset {off}, have "
                                   f"{len(part.records)} records"}])
                        continue
                    records = [*part.records, *(body.get("delta") or [])]
                    try:
                        await self.install(
                            part.meta, body.get("state") or {}, records
                        )
                    except Exception as e:  # noqa: BLE001 - refusal → sender fallback
                        logx.warn("migration install refused",
                                  session=sid, err=str(e))
                        await reply(["error", {"session": sid, "msg": str(e)}])
                        continue
                    await reply(["done", {"session": sid}])
                elif op == "abort":
                    self._partial.pop(sid, None)
                else:
                    await reply(["error", {"session": sid,
                                           "msg": f"unknown op {op!r}"}])
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            pass  # sender reconnects and resumes from its acked offset
        finally:
            try:
                writer.close()
            except (OSError, RuntimeError):
                pass


async def _rpc(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    frame: list,
    *,
    timeout_s: float,
) -> list:
    writer.write(encode_frame(frame))
    await writer.drain()
    reply = await asyncio.wait_for(read_frame(reader), timeout_s)
    if reply is None:
        raise ConnectionError("migration peer closed mid-handshake")
    if reply[0] == "error":
        raise MigrationError(str((reply[1] or {}).get("msg", "refused")))
    return reply


async def migrate_session(
    engine: Any,
    job_id: str,
    host: str,
    port: int,
    *,
    meta_extra: Optional[dict] = None,
    metrics: Any = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    max_attempts: int = 2,
) -> bool:
    """Drive one session's live migration to ``host:port``.

    Returns True once the target committed (the session is retired locally
    as migrated — publish nothing); False on any failure, with the session
    unfrozen and decoding locally again so the caller can fall back to a
    scheduler requeue.  A connection drop during the live page phase
    reconnects and resumes from the receiver's acked offset (the
    ``(session, offset)`` handshake)."""
    meta = engine.describe_session(job_id)
    if meta is None:
        if metrics is not None:
            metrics.serving_migration_failures.inc(reason="no_session")
        return False
    if meta_extra:
        meta.update(meta_extra)
    ps = int(meta["page_size"])
    frozen = False
    t_freeze = 0.0
    outcome = "failed"
    fail_reason = "unknown"
    try:
        for attempt in range(max_attempts):
            reader = writer = None
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), timeout_s
                )
                ok = await _rpc(reader, writer,
                                ["hello", {"session": job_id, "meta": meta}],
                                timeout_s=timeout_s)
                offset = int(ok[1]["offset"])
                # live phase: stream every page fully below the current
                # decode position — immutable while the session keeps
                # decoding, so the bulk ships with zero pause
                state = engine.export_state(job_id)
                if state is None:
                    fail_reason = "session_gone"
                    await _abort(writer, job_id)
                    return False
                stable_tok = (int(state["pos"]) // ps) * ps
                if offset * ps < stable_tok:
                    for rec in await engine.export_pages(
                        job_id, offset * ps, stable_tok
                    ):
                        writer.write(encode_frame(
                            ["page", {"session": job_id, "offset": offset,
                                      "rec": rec}]))
                        offset += 1
                    await writer.drain()
                # freeze-and-delta: decode pauses only from here to `done`
                if not engine.freeze_session(job_id):
                    fail_reason = "session_gone"
                    await _abort(writer, job_id)
                    return False
                frozen = True
                t_freeze = time.monotonic()
                await engine.wait_quiesced(job_id)
                state = engine.export_state(job_id)
                if state is None:  # cancelled while freezing
                    fail_reason = "session_gone"
                    await _abort(writer, job_id)
                    return False
                delta = await engine.export_pages(
                    job_id, stable_tok, max(int(state["pos"]), stable_tok)
                )
                await _rpc(reader, writer, ["commit", {
                    "session": job_id, "offset": offset,
                    "state": state, "delta": delta,
                }], timeout_s=timeout_s)
                pause = time.monotonic() - t_freeze
                engine.complete_migration(job_id)
                frozen = False
                outcome = "ok"
                if metrics is not None:
                    metrics.serving_migration_pause.observe(pause)
                logx.info("session migrated out", job_id=job_id,
                          target=f"{host}:{port}", pages=offset,
                          pause_ms=round(pause * 1000, 2))
                return True
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                fail_reason = (
                    "timeout" if isinstance(e, asyncio.TimeoutError) else "io"
                )
                # freeze reached: no resume — unfreeze and let the caller
                # requeue (the receiver's partial state GCs)
                if frozen or attempt + 1 >= max_attempts:
                    logx.warn("migration failed", job_id=job_id, err=str(e))
                    return False
                logx.warn("migration link lost; resuming", job_id=job_id,
                          err=str(e))
            except MigrationError as e:
                fail_reason = "refused"
                logx.warn("migration refused", job_id=job_id, err=str(e))
                return False
            finally:
                if writer is not None:
                    try:
                        writer.close()
                    except (OSError, RuntimeError):
                        pass
        return False
    finally:
        if frozen:
            engine.unfreeze_session(job_id)
        if metrics is not None:
            metrics.serving_migrations.inc(role="out", outcome=outcome)
            if outcome != "ok":
                # the {reason} split (refused | timeout | io | session_gone
                # | unknown) tells an operator WHY hand-offs fail — the
                # callers (hand-off, rebalance, drain) additionally retry
                # once against their next-best target before falling back
                metrics.serving_migration_failures.inc(reason=fail_reason)


async def _abort(writer: asyncio.StreamWriter, job_id: str) -> None:
    try:
        writer.write(encode_frame(["abort", {"session": job_id}]))
        await writer.drain()
    except (ConnectionError, OSError):
        pass
