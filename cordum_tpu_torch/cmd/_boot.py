"""Shared bootstrap for the port's service binaries: env config, logging,
the statebus connection and signal-driven shutdown (the reference's
``cordum_tpu/cmd/_boot.py``)."""
from __future__ import annotations

import asyncio
import os
import signal

from ..infra import logging as logx
from ..infra.config import Config, load


def setup() -> Config:
    logx.setup()
    # SIGUSR1 dumps all thread stacks to stderr: where a binary is stuck
    # without restarting it under a debugger
    try:
        import faulthandler

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError):  # pragma: no cover - non-POSIX
        pass
    return load()


async def connect_statebus(cfg: Config):
    from ..infra import statebus

    # comma-separated CORDUM_STATEBUS_URL connects the partitioned client;
    # one endpoint is the plain client in the same close-handle
    url = cfg.statebus_url or "statebus://127.0.0.1:7420"
    kv, bus, conn = await statebus.connect_partitioned(url)
    logx.info("connected to statebus", url=url, partitions=len(conn.conns))
    return kv, bus, conn


async def wait_for_shutdown() -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    await stop.wait()


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
