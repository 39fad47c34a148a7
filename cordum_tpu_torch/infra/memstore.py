"""Pointer-based payload store: "pass pointers, not blobs".

Contexts at ``ctx:<job_id>``, results at ``res:<job_id>``, pointers
``kv://ctx:<job_id>`` (reference ``core/infra/memory/redis_store.go:26-159``,
pointer scheme :139-158; data TTL default 24h).
"""
from __future__ import annotations

import json
from typing import Any, Optional

from .kv import KV, key_from_pointer, pointer_for_key

DEFAULT_DATA_TTL_S = 24 * 3600.0


class MemoryStore:
    def __init__(self, kv: KV, *, data_ttl_s: float = DEFAULT_DATA_TTL_S) -> None:
        self.kv = kv
        self.data_ttl_s = data_ttl_s

    @staticmethod
    def context_key(job_id: str) -> str:
        return f"ctx:{job_id}"

    @staticmethod
    def result_key(job_id: str) -> str:
        return f"res:{job_id}"

    async def put_context(self, job_id: str, payload: Any) -> str:
        key = self.context_key(job_id)
        await self.kv.set(key, json.dumps(payload).encode(), self.data_ttl_s)
        return pointer_for_key(key)

    async def get_context(self, ptr_or_job_id: str) -> Optional[Any]:
        return await self._get(ptr_or_job_id, self.context_key)

    async def put_result(self, job_id: str, payload: Any) -> str:
        key = self.result_key(job_id)
        await self.kv.set(key, json.dumps(payload).encode(), self.data_ttl_s)
        return pointer_for_key(key)

    async def get_result(self, ptr_or_job_id: str) -> Optional[Any]:
        return await self._get(ptr_or_job_id, self.result_key)

    async def get_pointer(self, ptr: str) -> Optional[Any]:
        b = await self.kv.get(key_from_pointer(ptr))
        return json.loads(b) if b is not None else None

    async def _get(self, ref: str, default_key) -> Optional[Any]:
        key = key_from_pointer(ref) if "://" in ref or ":" in ref else default_key(ref)
        b = await self.kv.get(key)
        return json.loads(b) if b is not None else None
