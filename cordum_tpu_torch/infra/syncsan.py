"""TSAN-lite interleave sanitizer for ``# cordum: guarded-by`` async state.

cordumlint's CL008 proves statically that a read-modify-write of shared
instance state never *spans an await* without its declared lock.  This
module is the dynamic half of that contract: with ``CORDUM_SYNC_SANITIZER=1``
every attribute carrying a ``# cordum: guarded-by(<lock>)`` annotation on an
:func:`instrument`-decorated class is replaced by a tracking descriptor, the
named lock is wrapped so ownership is attributable to an asyncio task, and
each access records ``(task, write-generation)``.  A *lost update* — task A
reads the attribute, task B commits a write at a later generation, then A
writes back without holding the lock — produces a :class:`Report` instead of
silently clobbering B's state.  The test harness asserts zero reports after
every test (``tests/conftest.py``), and CI runs the full tier-1 suite under
the sanitizer as a separate step.

Design constraints:

* **Zero cost when off.**  :func:`instrument` returns the class untouched
  unless the env var is set, so production import paths pay nothing.
* **No new dependencies.**  Annotations are recovered from the class source
  with :func:`inspect.getsource` + a regex — the same grammar cordumlint
  parses — so the two halves can never drift on syntax.
* **Attribution, not interception.**  Reports are collected, not raised, at
  the access site: raising inside a descriptor would turn a diagnosed race
  into a behavior change.  The harness decides when reports are fatal.
"""
from __future__ import annotations

import asyncio
import dataclasses
import inspect
import os
import re
from typing import Any, Optional

ENV_VAR = "CORDUM_SYNC_SANITIZER"

# same grammar cordumlint's program_rules._ANNOT_RE accepts for the
# attribute-level form: the annotation trails the `self.<attr> = ...` line
_GUARD_RE = re.compile(
    r"self\.(?P<attr>\w+)\s*[:=][^#\n]*#\s*cordum:\s*guarded-by\((?P<lock>\w+)\)"
)


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Report:
    """One diagnosed interleave conflict on a guarded attribute."""

    kind: str  # "lost-update" | "write-under-foreign-lock"
    cls: str
    attr: str
    lock: str
    writer_task: str
    other_task: str
    detail: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return (f"[syncsan:{self.kind}] {self.cls}.{self.attr} "
                f"(guarded-by {self.lock}): {self.detail}")


_reports: list[Report] = []
_gen = 0  # global write generation; bumped on every tracked write


def reports() -> list[Report]:
    return list(_reports)


def reset() -> None:
    _reports.clear()


def _task_label() -> str:
    t = _current_task()
    if t is None:
        return "<no-task>"
    return t.get_name() if hasattr(t, "get_name") else repr(t)


def _current_task() -> Optional[asyncio.Task]:
    try:
        return asyncio.current_task()
    except RuntimeError:
        return None


def _task_key() -> int:
    t = _current_task()
    return id(t) if t is not None else 0


# ---------------------------------------------------------------------------
# lock ownership
# ---------------------------------------------------------------------------

class TrackedLock:
    """Wraps the guarding lock so the sanitizer can attribute ownership to a
    task — asyncio.Lock knows *whether* it is held, never *by whom*."""

    def __init__(self, inner: Any):
        self._inner = inner
        self._owner: int = 0  # task key; 0 = unowned

    async def acquire(self) -> bool:
        got = await self._inner.acquire()
        self._owner = _task_key()
        return got

    def release(self) -> None:
        self._owner = 0
        self._inner.release()

    async def __aenter__(self) -> "TrackedLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_current(self) -> bool:
        return self.locked() and self._owner == _task_key()


class _LockAttr:
    """Data descriptor for the guarding lock attribute: wraps the assigned
    lock in a :class:`TrackedLock` at set time."""

    def __init__(self, name: str):
        self.name = name
        self.slot = "__ss_lock_" + name

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj: Any, value: Any) -> None:
        if value is not None and not isinstance(value, TrackedLock) \
                and hasattr(value, "__aenter__"):
            value = TrackedLock(value)
        obj.__dict__[self.slot] = value


# ---------------------------------------------------------------------------
# guarded attribute tracking
# ---------------------------------------------------------------------------

class _GuardedAttr:
    """Data descriptor replacing a guarded-by-annotated attribute.

    Per (object, attribute) it keeps the last write ``(generation, task)``
    and, per task, the generation current at that task's last *unprotected*
    read.  An unprotected write whose task read the attribute before a
    foreign write landed is a lost update."""

    def __init__(self, cls_name: str, name: str, lock_name: str):
        self.cls_name = cls_name
        self.name = name
        self.lock_name = lock_name
        self.slot = "__ss_val_" + name
        self.meta = "__ss_meta_" + name

    def _meta(self, obj: Any) -> dict:
        m = obj.__dict__.get(self.meta)
        if m is None:
            m = obj.__dict__[self.meta] = {"last_write": None, "reads": {}}
        return m

    def _lock(self, obj: Any) -> Optional[TrackedLock]:
        lk = obj.__dict__.get("__ss_lock_" + self.lock_name)
        return lk if isinstance(lk, TrackedLock) else None

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        try:
            val = obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None
        lock = self._lock(obj)
        if lock is None or not lock.held_by_current():
            self._meta(obj)["reads"][_task_key()] = _gen
        return val

    def __set__(self, obj: Any, value: Any) -> None:
        global _gen
        meta = self._meta(obj)
        lock = self._lock(obj)
        held = lock is not None and lock.held_by_current()
        tid = _task_key()
        if not held:
            last = meta["last_write"]
            my_read = meta["reads"].get(tid)
            if (last is not None and my_read is not None
                    and last[1] != tid and last[0] > my_read):
                _reports.append(Report(
                    kind="lost-update", cls=self.cls_name, attr=self.name,
                    lock=self.lock_name, writer_task=_task_label(),
                    other_task=f"task#{last[1]}",
                    detail=(f"write at gen {_gen + 1} is based on a read from "
                            f"gen {my_read}, but a foreign write landed at "
                            f"gen {last[0]} in between — hold "
                            f"`async with self.{self.lock_name}` across the "
                            f"read and the write"),
                ))
            if lock is not None and lock.locked() and lock._owner not in (0, tid):
                _reports.append(Report(
                    kind="write-under-foreign-lock", cls=self.cls_name,
                    attr=self.name, lock=self.lock_name,
                    writer_task=_task_label(),
                    other_task=f"task#{lock._owner}",
                    detail=(f"unlocked write while another task holds "
                            f"{self.lock_name} — the guarded section it "
                            f"protects can no longer trust the attribute"),
                ))
        _gen += 1
        meta["last_write"] = (_gen, tid)
        # our own write supersedes our stale-read bookkeeping; other tasks'
        # read marks stay so *their* next unlocked write is attributable
        meta["reads"].pop(tid, None)
        obj.__dict__[self.slot] = value


# ---------------------------------------------------------------------------
# class instrumentation
# ---------------------------------------------------------------------------

def guarded_attrs(cls: type) -> dict[str, str]:
    """``attr -> lock`` pairs declared in ``cls``'s source via
    ``# cordum: guarded-by(<lock>)`` trailing an assignment."""
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):  # built under exec / REPL: nothing to scan
        return {}
    return {m.group("attr"): m.group("lock") for m in _GUARD_RE.finditer(src)}


def instrument(cls: type) -> type:
    """Class decorator: installs tracking descriptors for every guarded-by
    declared attribute.  A no-op (returns ``cls`` unchanged) unless
    ``CORDUM_SYNC_SANITIZER=1`` — production pays nothing."""
    if not enabled():
        return cls
    pairs = guarded_attrs(cls)
    for attr, lock in pairs.items():
        setattr(cls, attr, _GuardedAttr(cls.__name__, attr, lock))
        if not isinstance(getattr(cls, lock, None), _LockAttr):
            setattr(cls, lock, _LockAttr(lock))
    return cls
