"""Statebus wire-frame primitives (``[4-byte BE length][msgpack array]`` —
docs/PROTOCOL.md §Statebus wire format), shared by the statebus server and
client (``infra/statebus.py``) and the serving session migration link
(``serving/migration.py``); the msgpack is the port's own codec
(``infra/codec.py``).
"""
from __future__ import annotations

import asyncio
import struct
from typing import Any, Optional

from .codec import packb, unpackb

LEN = struct.Struct(">I")


def encode_frame(obj: Any) -> bytes:
    b = packb(obj)
    return LEN.pack(len(b)) + b


async def read_frame(reader: asyncio.StreamReader) -> Optional[list]:
    try:
        head = await reader.readexactly(4)
        (n,) = LEN.unpack(head)
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return unpackb(body)


class FrameWriter:
    """Per-connection write coalescer.

    ``send()`` enqueues a frame synchronously; one flusher task drains the
    accumulated batch per wakeup.  N replies (or N pipelined requests)
    produced in one event-loop tick cost ONE socket write + drain instead
    of N lock/write/drain cycles — without this, pipelined commits arriving
    from many scheduler shards interleave into tiny writes and the
    per-frame ``drain()`` syscalls dominate the statebus hot path.
    Batch sizes surface as ``cordum_statebus_coalesced_batch``.
    """

    __slots__ = ("_writer", "_buf", "_wake", "_task", "_metrics", "_closed")

    def __init__(self, writer: asyncio.StreamWriter, metrics: Any = None) -> None:
        self._writer = writer
        self._buf: list[bytes] = []
        self._wake = asyncio.Event()
        self._metrics = metrics
        self._closed = False
        self._task = asyncio.ensure_future(self._run())

    def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("statebus frame writer closed")
        self._buf.append(frame)
        self._wake.set()

    async def _run(self) -> None:
        try:
            while not self._closed:
                await self._wake.wait()
                self._wake.clear()
                if not self._buf:
                    continue
                buf, self._buf = self._buf, []
                if self._metrics is not None:
                    self._metrics.statebus_coalesced_batch.observe(float(len(buf)))
                self._writer.write(buf[0] if len(buf) == 1 else b"".join(buf))
                # drain AFTER the batch: backpressure throttles the flusher
                # (and everything queued behind it), never individual sends
                await self._writer.drain()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            # peer gone mid-flush: subsequent send() raises; the owning
            # connection's read loop drives recovery/teardown
            self._closed = True

    async def close(self) -> None:
        self._closed = True
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass
