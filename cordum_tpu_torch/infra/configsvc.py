"""Dynamic config service: scoped, revisioned documents with shallow-merge
effective view (reference ``core/configsvc/service.go:14-170``).

Scopes merge system → org → team → workflow → step; ``effective()`` is the
shallow merge, ``effective_snapshot()`` is ``{version, hash}`` used to pin
policy decisions.  Documents live at ``cfg:<scope>:<id>``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Optional

from ..utils.ids import now_us
from .kv import KV

SCOPES = ("system", "org", "team", "workflow", "step")


def cfg_key(scope: str, doc_id: str) -> str:
    return f"cfg:{scope}:{doc_id}"


@dataclass
class ConfigDoc:
    scope: str
    doc_id: str
    revision: int
    data: dict[str, Any]
    updated_at_us: int = 0


class ConfigService:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    async def get(self, scope: str, doc_id: str) -> Optional[ConfigDoc]:
        b = await self.kv.get(cfg_key(scope, doc_id))
        if not b:
            return None
        d = json.loads(b)
        return ConfigDoc(scope, doc_id, d.get("revision", 0), d.get("data", {}), d.get("updated_at_us", 0))

    async def set(self, scope: str, doc_id: str, data: dict[str, Any]) -> ConfigDoc:
        if scope not in SCOPES:
            raise ValueError(f"unknown scope {scope!r}")
        cur = await self.get(scope, doc_id)
        rev = (cur.revision if cur else 0) + 1
        doc = ConfigDoc(scope, doc_id, rev, data, now_us())
        await self.kv.set(
            cfg_key(scope, doc_id),
            json.dumps({"revision": rev, "data": data, "updated_at_us": doc.updated_at_us}).encode(),
        )
        return doc

    async def patch(self, scope: str, doc_id: str, patch: dict[str, Any]) -> ConfigDoc:
        """RFC 7386-style JSON merge patch (pack overlays use this)."""
        cur = await self.get(scope, doc_id)
        data = dict(cur.data) if cur else {}
        _merge_patch(data, patch)
        return await self.set(scope, doc_id, data)

    async def delete(self, scope: str, doc_id: str) -> bool:
        return (await self.kv.delete(cfg_key(scope, doc_id))) > 0

    async def list(self, scope: str) -> list[str]:
        prefix = f"cfg:{scope}:"
        return [k[len(prefix):] for k in await self.kv.keys(prefix)]

    async def effective(
        self,
        *,
        org: str = "",
        team: str = "",
        workflow: str = "",
        step: str = "",
        system_id: str = "default",
    ) -> dict[str, Any]:
        """Shallow merge system→org→team→workflow→step (later wins per key)."""
        merged: dict[str, Any] = {}
        for scope, doc_id in (
            ("system", system_id),
            ("org", org),
            ("team", team),
            ("workflow", workflow),
            ("step", step),
        ):
            if not doc_id:
                continue
            doc = await self.get(scope, doc_id)
            if doc:
                merged.update(doc.data)
        return merged

    async def effective_snapshot(self, **kw: str) -> dict[str, str]:
        eff = await self.effective(**kw)
        canonical = json.dumps(eff, sort_keys=True, separators=(",", ":"))
        h = hashlib.sha256(canonical.encode()).hexdigest()[:16]
        return {"hash": h, "config": canonical}


def _merge_patch(target: dict, patch: dict) -> None:
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict) and isinstance(target.get(k), dict):
            _merge_patch(target[k], v)
        else:
            target[k] = v
