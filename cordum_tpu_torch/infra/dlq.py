"""Dead-letter queue store (reference ``core/infra/memory/dlq_store.go``)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from ..utils.ids import now_us
from .kv import KV

# per-job re-drive hook: takes a DLQ job id, returns the new job id when the
# retry was published (the gateway's retry path), or None when it could not
# be (missing original request etc.)
RetryFn = Callable[[str], Awaitable[Optional[str]]]


@dataclass
class DLQEntry:
    job_id: str = ""
    topic: str = ""
    status: str = ""
    reason: str = ""
    reason_code: str = ""
    last_state: str = ""
    attempts: int = 0
    tenant_id: str = ""
    created_at_us: int = 0
    labels: dict = field(default_factory=dict)


def entry_key(job_id: str) -> str:
    return f"dlq:entry:{job_id}"


INDEX_KEY = "dlq:index"


class DLQStore:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    async def add(self, e: DLQEntry) -> None:
        e.created_at_us = e.created_at_us or now_us()
        await self.kv.set(entry_key(e.job_id), json.dumps(e.__dict__).encode())
        await self.kv.zadd(INDEX_KEY, e.job_id, float(e.created_at_us))

    async def get(self, job_id: str) -> Optional[DLQEntry]:
        b = await self.kv.get(entry_key(job_id))
        return DLQEntry(**json.loads(b)) if b else None

    async def list(self, offset: int = 0, limit: int = 50) -> list[DLQEntry]:
        ids = await self.kv.zrange(INDEX_KEY, offset, offset + limit - 1, desc=True)
        out = []
        for jid in ids:
            e = await self.get(jid)
            if e:
                out.append(e)
        return out

    async def count(self) -> int:
        return await self.kv.zcard(INDEX_KEY)

    async def delete(self, job_id: str) -> bool:
        n = await self.kv.delete(entry_key(job_id))
        await self.kv.zrem(INDEX_KEY, job_id)
        return n > 0

    # ------------------------------------------------------------------
    # bulk operations
    # ------------------------------------------------------------------
    async def retry_all(
        self, retry_fn: RetryFn, *, limit: int = 0
    ) -> list[tuple[str, Optional[str]]]:
        """Re-drive every dead-lettered job through ``retry_fn`` (the
        existing per-job retry path), oldest first.  Returns
        ``[(job_id, new_job_id | None), ...]``; entries whose retry was
        published are removed from the queue, failed re-drives stay."""
        ids = await self.kv.zrange(INDEX_KEY, 0, (limit - 1) if limit else -1)
        out: list[tuple[str, Optional[str]]] = []
        for jid in ids:
            new_id = await retry_fn(jid)
            if new_id is not None:
                await self.delete(jid)
            out.append((jid, new_id))
        return out

    async def purge_older_than(self, cutoff_us: int) -> int:
        """Drop every entry dead-lettered at or before ``cutoff_us``; returns
        the number purged."""
        ids = await self.kv.zrangebyscore(INDEX_KEY, 0, float(cutoff_us))
        n = 0
        for jid in ids:
            if await self.delete(jid):
                n += 1
        return n
