"""Fault-injection harness for statebus replication/failover testing.

Reusable building blocks for chaos tests (pytest marker ``chaos``),
``chip_smoke.py``'s phase 18 and operator drills:

* :class:`ChaosProxy` — a TCP proxy that sits between a client and a
  statebus endpoint and, on command, **delays**, **black-holes** (traffic
  stalls but the connection stays open: the half-open/dead-host failure
  mode that only liveness pings catch), **half-closes**, **severs** (RST
  every live connection once) or **drops** (sever + refuse new
  connections) the link — then ``restore()``s it.  Delay, blackhole and
  sever take a ``direction`` (``"both"`` | ``"c2s"`` | ``"s2c"``) so
  ASYMMETRIC partitions are expressible: requests flow but replies stall,
  acks vanish while data keeps arriving — the failure modes a migration
  handshake must survive (docs/SERVING.md §Migration).
* :class:`WorkerProc` — deterministic kill/restart around a real
  ``python -m cordum_tpu_torch.cmd.worker`` subprocess (SIGKILL = the
  crash the serving-session failover path exists to survive; SIGTERM =
  graceful drain).  It runs on the card unless the caller's ``env`` sets
  ``CORDUM_FORCE_CPU=1``, as the CPU tests do.
* :class:`ServerProc` — deterministic kill/restart around a real
  ``python -m cordum_tpu_torch.cmd.statebus`` subprocess: SIGKILL for crash
  semantics (no GOAWAY, no flush beyond the AOF's per-record policy),
  SIGTERM for the graceful path, and a readiness probe so restarts are
  race-free.

Everything here is asyncio-native and port-0 friendly so chaos tests can
run inside one pytest process without fixed ports.
"""
from __future__ import annotations

import asyncio
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

from . import logging as logx

_MODES = ("pass", "delay", "blackhole", "drop")


def free_port() -> int:
    """An OS-assigned free TCP port (bind-and-release)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _DirState:
    """Fault state for ONE direction of the proxied link (client→server or
    server→client): its blackhole gate and per-chunk delay."""

    __slots__ = ("gate", "delay_s")

    def __init__(self) -> None:
        self.gate = asyncio.Event()
        self.gate.set()
        self.delay_s = 0.0


class _Pipe:
    """One direction of one proxied connection."""

    def __init__(self, proxy: "ChaosProxy", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, direction: str) -> None:
        self.proxy = proxy
        self.reader = reader
        self.writer = writer
        self.direction = direction  # "c2s" | "s2c"
        self.task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        state = self.proxy._dirs[self.direction]
        try:
            while True:
                # black-hole gate: bytes stall here (kernel buffers fill,
                # the peer sees a live-but-silent connection) until restore
                await state.gate.wait()
                chunk = await self.reader.read(65536)
                if not chunk:
                    break
                if state.delay_s > 0:
                    await asyncio.sleep(state.delay_s)
                # re-check after the (possibly long) read: a blackhole set
                # while we were blocked reading must hold THIS chunk too —
                # without it one in-flight chunk leaks through the gate,
                # making loss-window tests racy
                await state.gate.wait()
                self.writer.write(chunk)
                await self.writer.drain()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                self.writer.close()
            except (OSError, RuntimeError):
                pass  # transport already torn down


_DIRECTIONS = ("c2s", "s2c")


def _dirs_for(direction: str) -> tuple[str, ...]:
    if direction == "both":
        return _DIRECTIONS
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction must be both|c2s|s2c, got {direction!r}")
    return (direction,)


class ChaosProxy:
    """Controllable TCP proxy in front of one ``(host, port)`` target."""

    def __init__(self, target_host: str, target_port: int, *,
                 listen_host: str = "127.0.0.1", listen_port: int = 0) -> None:
        self.target_host = target_host
        self.target_port = target_port
        self.listen_host = listen_host
        self.port = listen_port
        self.mode = "pass"
        self.connections_total = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._pipes: list[_Pipe] = []
        self._writers: list[asyncio.StreamWriter] = []
        self._dirs: dict[str, _DirState] = {d: _DirState() for d in _DIRECTIONS}

    @property
    def delay_s(self) -> float:
        """Back-compat view: the max per-direction delay."""
        return max(s.delay_s for s in self._dirs.values())

    @property
    def url(self) -> str:
        return f"statebus://{self.listen_host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.listen_host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logx.info("chaos proxy listening", port=self.port,
                  target=f"{self.target_host}:{self.target_port}")

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        self.sever()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        if self.mode == "drop":
            writer.close()  # accept-then-reset: the endpoint looks dead
            return
        try:
            up_reader, up_writer = await asyncio.open_connection(
                self.target_host, self.target_port)
        except (OSError, ConnectionError):
            writer.close()
            return
        self.connections_total += 1
        self._writers.extend((writer, up_writer))
        pipes = [_Pipe(self, reader, up_writer, "c2s"),
                 _Pipe(self, up_reader, writer, "s2c")]
        self._pipes.extend(pipes)
        await asyncio.gather(*(p.task for p in pipes), return_exceptions=True)

    # -- failure controls ------------------------------------------------
    # `direction` selects which half of the link the fault hits: "c2s"
    # (requests/data toward the server), "s2c" (replies/acks toward the
    # client), or "both".  Asymmetric faults are what distinguish "the
    # peer is dead" from "the peer is alive but I can't hear it" — the
    # cases a (session, offset) handshake must not confuse.
    def set_delay(self, seconds: float, direction: str = "both") -> None:
        """Add per-chunk latency in the given direction(s) (keeps ordering)."""
        for d in _dirs_for(direction):
            self._dirs[d].delay_s = max(0.0, seconds)
        self.mode = "delay" if self.delay_s > 0 else "pass"

    def blackhole(self, direction: str = "both") -> None:
        """Stop forwarding (in the given direction(s)) without closing
        anything: connections stay ESTABLISHED but go silent — the failure
        mode a crashed host behind a switch produces, detectable only by
        liveness pings.  ``direction="s2c"`` models the asymmetric partition
        where requests arrive but replies vanish."""
        self.mode = "blackhole"
        for d in _dirs_for(direction):
            self._dirs[d].gate.clear()

    def sever(self, direction: str = "both") -> None:
        """RST the live proxied flows (new connections still accepted in
        the current mode).  With a single direction this is a half-close:
        only that flow's pipes die; the opposite direction keeps moving
        until the endpoint reacts."""
        dirs = set(_dirs_for(direction))
        keep: list[_Pipe] = []
        for p in self._pipes:
            if p.direction in dirs:
                p.task.cancel()
                try:
                    p.writer.close()
                except (OSError, RuntimeError):
                    pass  # transport already torn down
            else:
                keep.append(p)
        self._pipes = keep
        if direction == "both":
            for w in self._writers:
                try:
                    w.close()
                except (OSError, RuntimeError):
                    pass  # transport already torn down
            self._writers.clear()

    def drop(self) -> None:
        """Sever everything AND refuse (accept-then-reset) new connections
        until ``restore()`` — the endpoint looks hard-down."""
        self.mode = "drop"
        for s in self._dirs.values():
            s.gate.set()
        self.sever()

    def restore(self) -> None:
        """Back to transparent pass-through for current + new connections,
        in both directions."""
        self.mode = "pass"
        for s in self._dirs.values():
            s.delay_s = 0.0
            s.gate.set()


class ServerProc:
    """A real ``cordum_tpu_torch.cmd.statebus`` subprocess with
    deterministic kill/restart.

    ``env`` carries the statebus configuration (STATEBUS_PORT,
    STATEBUS_AOF, STATEBUS_REPLICA_OF, STATEBUS_PEERS, ...).  ``start()``
    blocks until the server answers a ``role`` probe, so tests never race
    the bind; ``kill()`` is SIGKILL (crash semantics: no GOAWAY, no final
    fsync); ``terminate()`` is SIGTERM (graceful path).
    """

    def __init__(self, port: int, *, env: Optional[dict] = None,
                 cwd: str = "") -> None:
        self.port = port
        self.env = dict(env or {})
        self.cwd = cwd or os.getcwd()
        self.proc: Optional[subprocess.Popen] = None

    async def start(self, *, timeout_s: float = 20.0) -> None:
        from .replication import probe_role

        env = {**os.environ, "STATEBUS_PORT": str(self.port), **self.env}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cordum_tpu_torch.cmd.statebus"],
            env=env, cwd=self.cwd)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"statebus proc exited rc={self.proc.returncode} during start")
            if await probe_role("127.0.0.1", self.port, timeout_s=0.5) is not None:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError(f"statebus on :{self.port} never became ready")

    def kill(self) -> None:
        """SIGKILL: the process dies mid-whatever — the crash the
        replication layer exists to survive."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)

    def terminate(self) -> None:
        """SIGTERM: graceful shutdown (AOF fsync + GOAWAY broadcast)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)

    async def restart(self, *, timeout_s: float = 20.0) -> None:
        self.kill()
        await self.start(timeout_s=timeout_s)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class WorkerProc:
    """A real ``cordum_tpu_torch.cmd.worker`` subprocess with deterministic
    kill semantics — the serving-fleet half of the chaos harness
    (docs/SERVING.md §Migration, drain, and failover).

    ``env`` carries the worker configuration (WORKER_ID,
    CORDUM_STATEBUS_URL, WORKER_SERVING_*, ...).  The worker runs on the
    card it sees; ``CORDUM_FORCE_CPU=1`` in ``env`` runs it on the CPU (it
    raises without a card otherwise).  ``kill()`` is SIGKILL (a crashed
    worker: heartbeats just stop, sessions strand until the scheduler's
    WorkerFailover notices); ``terminate()`` is SIGTERM (graceful drain:
    sessions live-migrate to peers before exit).  Readiness is the
    caller's job — poll the scheduler registry or tail the log for the
    worker's first heartbeat."""

    def __init__(self, worker_id: str, *, env: Optional[dict] = None,
                 cwd: str = "", log_path: str = "") -> None:
        self.worker_id = worker_id
        self.env = dict(env or {})
        self.cwd = cwd or os.getcwd()
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_f = None

    def start(self) -> None:
        env = {**os.environ, "WORKER_ID": self.worker_id, **self.env}
        out = None
        if self.log_path:
            self._log_f = open(self.log_path, "ab")
            out = self._log_f
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cordum_tpu_torch.cmd.worker"],
            env=env, cwd=self.cwd, stdout=out, stderr=out)

    def kill(self) -> None:
        """SIGKILL: the crash mid-decode that serving-session failover
        exists to survive — no drain, no final heartbeat, nothing."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)
        self._close_log()

    def terminate(self, timeout_s: float = 60.0) -> None:
        """SIGTERM: graceful drain (live-migrate sessions, finish jobs,
        exit)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._close_log()

    def _close_log(self) -> None:
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None
