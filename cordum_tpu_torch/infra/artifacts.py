"""Artifact store with retention classes (reference
``core/infra/artifacts/store.go:5-27``: short/standard/audit retention →
TTLs; keys ``art:<id>``, pointers ``kv://art:<id>``)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ..utils.ids import new_id, now_us
from .kv import KV, pointer_for_key

RETENTION_TTLS = {
    "short": 3600.0,
    "standard": 7 * 24 * 3600.0,
    "audit": 90 * 24 * 3600.0,
}


@dataclass
class ArtifactMetadata:
    artifact_id: str = ""
    content_type: str = "application/octet-stream"
    size: int = 0
    retention: str = "standard"
    labels: dict = field(default_factory=dict)
    created_at_us: int = 0


class ArtifactStore:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    async def put(
        self,
        data: bytes,
        *,
        artifact_id: str = "",
        content_type: str = "application/octet-stream",
        retention: str = "standard",
        labels: Optional[dict] = None,
    ) -> ArtifactMetadata:
        aid = artifact_id or new_id()
        ttl = RETENTION_TTLS.get(retention, RETENTION_TTLS["standard"])
        meta = ArtifactMetadata(
            artifact_id=aid,
            content_type=content_type,
            size=len(data),
            retention=retention,
            labels=labels or {},
            created_at_us=now_us(),
        )
        await self.kv.set(f"art:{aid}", data, ttl)
        await self.kv.set(f"art:meta:{aid}", json.dumps(meta.__dict__).encode(), ttl)
        return meta

    async def get(self, artifact_id: str) -> tuple[Optional[bytes], Optional[ArtifactMetadata]]:
        data = await self.kv.get(f"art:{artifact_id}")
        mb = await self.kv.get(f"art:meta:{artifact_id}")
        meta = ArtifactMetadata(**json.loads(mb)) if mb else None
        return data, meta

    @staticmethod
    def pointer(artifact_id: str) -> str:
        return pointer_for_key(f"art:{artifact_id}")
