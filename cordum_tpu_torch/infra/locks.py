"""Shared/exclusive resource locks with TTL and owner counts
(reference ``core/infra/locks/store.go:8-32`` + redis impl)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ..utils.ids import now_s
from .kv import KV


@dataclass
class LockInfo:
    resource: str = ""
    mode: str = "exclusive"  # exclusive | shared
    owners: dict[str, float] = field(default_factory=dict)  # owner -> expires_at (unix s)


def lock_key(resource: str) -> str:
    return f"lock:res:{resource}"


class LockStore:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    async def _load(self, resource: str) -> Optional[LockInfo]:
        b = await self.kv.get(lock_key(resource))
        if not b:
            return None
        info = LockInfo(**json.loads(b))
        now = now_s()
        info.owners = {o: exp for o, exp in info.owners.items() if exp > now}
        if not info.owners:
            return None
        return info

    async def _store(self, info: LockInfo) -> None:
        max_ttl = max(info.owners.values()) - now_s() if info.owners else 0
        if max_ttl <= 0:
            await self.kv.delete(lock_key(info.resource))
            return
        await self.kv.set(lock_key(info.resource), json.dumps(info.__dict__).encode(), max_ttl)

    async def acquire(
        self, resource: str, owner: str, *, mode: str = "exclusive", ttl_s: float = 30.0
    ) -> bool:
        info = await self._load(resource)
        exp = now_s() + ttl_s
        if info is None:
            await self._store(LockInfo(resource=resource, mode=mode, owners={owner: exp}))
            return True
        if owner in info.owners:  # re-entrant renew
            info.owners[owner] = exp
            await self._store(info)
            return True
        if info.mode == "shared" and mode == "shared":
            info.owners[owner] = exp
            await self._store(info)
            return True
        return False

    async def release(self, resource: str, owner: str) -> bool:
        info = await self._load(resource)
        if info is None or owner not in info.owners:
            return False
        del info.owners[owner]
        await self._store(info)
        return True

    async def renew(self, resource: str, owner: str, ttl_s: float = 30.0) -> bool:
        info = await self._load(resource)
        if info is None or owner not in info.owners:
            return False
        info.owners[owner] = now_s() + ttl_s
        await self._store(info)
        return True

    async def get(self, resource: str) -> Optional[LockInfo]:
        return await self._load(resource)

    async def list(self) -> list[LockInfo]:
        out = []
        for k in await self.kv.keys("lock:res:"):
            info = await self._load(k[len("lock:res:"):])
            if info:
                out.append(info)
        return out
