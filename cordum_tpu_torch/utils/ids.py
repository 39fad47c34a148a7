"""ID and time helpers used across the control plane."""
from __future__ import annotations

import itertools
import os
import time
import uuid


def new_id() -> str:
    """Random job/run/trace identifier (UUID4, canonical string form)."""
    return str(uuid.uuid4())


# Span-id generation sits on the scheduler hot path (5+ spans per job), where
# uuid4's os.urandom call per id was measurable at bench job rates.  Spans
# only need process-lifetime uniqueness, not unpredictability: one random
# 64-bit prefix per process + a counter.
_FAST_PREFIX = os.urandom(8).hex()
_FAST_CTR = itertools.count(1)


def fast_id() -> str:
    """Cheap unique id (random process prefix + counter) for span ids and
    other identifiers that need uniqueness, not entropy per call."""
    return f"{_FAST_PREFIX}{next(_FAST_CTR):012x}"


def now_us() -> int:
    """Current wall time in microseconds (job-store timestamp unit)."""
    return time.time_ns() // 1_000


def now_s() -> float:
    return time.time()


def now_ms() -> int:
    return time.time_ns() // 1_000_000
