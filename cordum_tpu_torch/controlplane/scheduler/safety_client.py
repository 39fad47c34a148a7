"""Safety-kernel client: timeout + half-open circuit breaker, fail-closed.

Reference ``core/controlplane/scheduler/safety_client.go``: 2s check timeout;
breaker opens after 3 consecutive failures, stays open 30s, then allows 3
half-open probes and closes after 2 successes; every error path **denies**
(fail-closed).
"""
from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from ...protocol.types import Decision, PolicyCheckRequest, PolicyCheckResponse
from ...utils.eager import eager

CheckFn = Callable[[PolicyCheckRequest], Awaitable[PolicyCheckResponse]]

FAIL_THRESHOLD = 3
OPEN_SECONDS = 30.0
HALF_OPEN_PROBES = 3
CLOSE_SUCCESSES = 2


class CircuitBreaker:
    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        fail_threshold: int = FAIL_THRESHOLD,
        open_seconds: float = OPEN_SECONDS,
        half_open_probes: int = HALF_OPEN_PROBES,
        close_successes: int = CLOSE_SUCCESSES,
    ):
        self.state = self.CLOSED
        self.fail_threshold = fail_threshold
        self.open_seconds = open_seconds
        self.half_open_probes = half_open_probes
        self.close_successes = close_successes
        self._fails = 0
        self._successes = 0
        self._probes = 0
        self._opened_at = 0.0

    def allow(self) -> bool:
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if time.monotonic() - self._opened_at >= self.open_seconds:
                self.state = self.HALF_OPEN
                self._probes = 0
                self._successes = 0
            else:
                return False
        # half-open: limited probes
        if self._probes < self.half_open_probes:
            self._probes += 1
            return True
        return False

    def record_success(self) -> None:
        if self.state == self.HALF_OPEN:
            self._successes += 1
            if self._successes >= self.close_successes:
                self.state = self.CLOSED
                self._fails = 0
        else:
            self._fails = 0

    def record_failure(self) -> None:
        if self.state == self.HALF_OPEN:
            self._open()
            return
        self._fails += 1
        if self._fails >= self.fail_threshold:
            self._open()

    def _open(self) -> None:
        self.state = self.OPEN
        self._opened_at = time.monotonic()
        self._fails = 0


def _deny(reason: str) -> PolicyCheckResponse:
    return PolicyCheckResponse(decision=Decision.DENY.value, reason=reason)


class SafetyClient:
    """Wraps any async check function (in-process kernel or remote RPC)."""

    def __init__(self, check_fn: CheckFn, *, timeout_s: float = 2.0, breaker: CircuitBreaker | None = None):
        self._check = check_fn
        self.timeout_s = timeout_s
        self.breaker = breaker or CircuitBreaker()

    async def check(self, req: PolicyCheckRequest) -> PolicyCheckResponse:
        if not self.breaker.allow():
            return _deny("safety kernel circuit open (fail-closed)")
        try:
            # eager completion: an in-process kernel with a warm policy
            # cache finishes without suspending — no Task, no timer.  The
            # check timeout only matters for checks that actually park
            # (remote RPC, cold reload), which take the wait_for path.
            done, resp = eager(self._check(req))
            if not done:
                resp = await asyncio.wait_for(
                    asyncio.ensure_future(resp), self.timeout_s
                )
        except asyncio.TimeoutError:
            self.breaker.record_failure()
            return _deny("safety kernel check timed out (fail-closed)")
        except Exception as e:  # noqa: BLE001 - any kernel error denies
            self.breaker.record_failure()
            return _deny(f"safety kernel error: {e} (fail-closed)")
        self.breaker.record_success()
        return resp
