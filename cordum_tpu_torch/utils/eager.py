"""Eager coroutine completion: skip task/timer plumbing for coroutines that
never actually suspend.

Most hot-path awaits in the 1×1 control plane complete synchronously — an
in-process safety kernel with a warm cache, a MemoryKV op on an uncontended
lock, a loopback-bus publish with no slow subscriber.  Wrapping each of
those in ``asyncio.wait_for``/``asyncio.gather`` still costs a Task object,
a TimerHandle, and two loop callbacks per call, which was a measurable
slice of the scheduler hot path.

``eager(coro)`` advances a coroutine to its first *real* suspension point:

* completed → ``(True, result)`` — no Task, no timer, no loop round trip;
* suspended → ``(False, continuation)`` where the continuation is an
  awaitable that resumes the already-started coroutine with full exception
  and cancellation pass-through (the same protocol a Task speaks).

Synchronous exceptions propagate out of ``eager`` exactly as they would out
of the first ``await``.

CONTEXTVAR CAVEAT: the eager phase runs in the *caller's* context while the
continuation runs in whatever Task later drives it.  A coroutine that holds
a contextvar across its first suspension therefore executes split across
two contexts — ``ContextVar.reset(token)`` would raise.  Only use ``eager``
on coroutines whose contextvar windows are suspension-free (the tracer's
span context uses value-restore, not tokens, to stay benign here).
"""
from __future__ import annotations

import types
from typing import Any, Coroutine


def eager(coro: Coroutine) -> tuple[bool, Any]:
    """Run ``coro`` to its first suspension.  → ``(True, result)`` if it
    finished synchronously, else ``(False, continuation_awaitable)``."""
    try:
        first = coro.send(None)
    except StopIteration as si:
        return True, si.value
    return False, _drive(coro, first)


@types.coroutine
def _drive(coro: Coroutine, fut: Any):
    """Continue a coroutine that already yielded its first future.

    Pass-through of the Task protocol: re-yield each future the coroutine
    parks on, feed results back in, forward thrown exceptions (including
    cancellation) so ``finally`` blocks inside ``coro`` run normally."""
    while True:
        try:
            value = yield fut
        except BaseException as e:  # noqa: BLE001 - full pass-through
            try:
                fut = coro.throw(e)
            except StopIteration as si:
                return si.value
            continue
        try:
            fut = coro.send(value)
        except StopIteration as si:
            return si.value


async def eager_gather(coros: list[Coroutine]) -> None:
    """Gather for fire-and-forget coroutines that usually complete eagerly:
    each runs synchronously to its first real suspension; only the ones
    that actually suspend get Tasks.  Results are discarded (call sites
    handle their own errors); a synchronous exception propagates
    immediately, like the first ``await`` of a plain gather."""
    import asyncio

    conts: list[Any] = []
    for c in coros:
        done, r = eager(c)
        if not done:
            conts.append(r)
    if conts:
        await asyncio.gather(*conts)
