"""Leveled key/value logger with optional JSON mode
(reference ``core/infra/logging/logging.go``; ``CORDUM_LOG_FORMAT=json``)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

_root = logging.getLogger("cordum")


class _KVFormatter(logging.Formatter):
    def __init__(self, json_mode: bool) -> None:
        super().__init__()
        self.json_mode = json_mode

    def format(self, record: logging.LogRecord) -> str:
        kv = getattr(record, "kv", {})
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        if self.json_mode:
            d = {
                "ts": ts,
                "level": record.levelname.lower(),
                "logger": record.name,
                "msg": record.getMessage(),
                **kv,
            }
            return json.dumps(d, default=str)
        pairs = " ".join(f"{k}={v}" for k, v in kv.items())
        return f"{ts} {record.levelname:<5} {record.name} {record.getMessage()}" + (
            f" {pairs}" if pairs else ""
        )


def setup(level: str = "") -> None:
    lvl = (level or os.environ.get("CORDUM_LOG_LEVEL", "INFO")).upper()
    json_mode = os.environ.get("CORDUM_LOG_FORMAT", "") == "json"
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(_KVFormatter(json_mode))
    _root.handlers[:] = [h]
    _root.setLevel(lvl)
    _root.propagate = False


def _log(level: int, msg: str, **kv: Any) -> None:
    _root.log(level, msg, extra={"kv": kv})


def debug(msg: str, **kv: Any) -> None:
    _log(logging.DEBUG, msg, **kv)


def info(msg: str, **kv: Any) -> None:
    _log(logging.INFO, msg, **kv)


def warn(msg: str, **kv: Any) -> None:
    _log(logging.WARNING, msg, **kv)


def error(msg: str, **kv: Any) -> None:
    _log(logging.ERROR, msg, **kv)


async def join_task(task: Any, *, name: str) -> None:
    """Await a just-cancelled background task.  Cancellation is the expected
    outcome; any other exception is a real crash that must not vanish in a
    ``stop()`` (CL002) — it is logged with the task name."""
    import asyncio

    try:
        await task
    except asyncio.CancelledError:
        pass
    except Exception as e:  # noqa: BLE001 - logged, never swallowed
        error("background task crashed during shutdown", task=name, err=str(e))
