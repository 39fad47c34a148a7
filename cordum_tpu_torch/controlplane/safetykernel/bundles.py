"""Policy bundle administration: versioned bundles, snapshots, publish /
rollback with an audit trail.

Recreates reference ``core/controlplane/gateway/policy_bundles.go``
(:122-651 bundles, :671-931 snapshots, :1432-1465 audit):

  * bundles are named policy documents stored under ``cfg:system:policy/``
    (the same fragment namespace the kernel merges) — putting a bundle is a
    staged write: it lands DISABLED until published
  * snapshots capture the full merged policy doc at a point in time
    (``kernel.get_snapshot``); ``publish`` enables a bundle and records the
    resulting kernel snapshot; ``rollback`` re-installs a captured
    snapshot's fragment set
  * every admin mutation appends to the audit log ``policy:audit``
  * bundle ids may contain ``/`` (URL-escaped as ``~`` in routes,
    reference behavior)
"""
from __future__ import annotations

import json
from typing import Any, Optional

from ...infra.configsvc import ConfigService
from ...infra.kv import KV
from ...utils.ids import now_us
from .kernel import POLICY_FRAGMENT_PREFIX, SafetyKernel

AUDIT_KEY = "policy:audit"
AUDIT_CAP = 500
SNAPSHOT_PREFIX = "policy:snapshot:"


def unescape_bundle_id(raw: str) -> str:
    return raw.replace("~", "/")


class PolicyBundleAdmin:
    def __init__(self, kv: KV, configsvc: ConfigService, kernel: SafetyKernel):
        self.kv = kv
        self.configsvc = configsvc
        self.kernel = kernel

    # -- audit ----------------------------------------------------------
    async def _audit(self, action: str, actor: str, detail: str = "") -> None:
        ev = {"ts_us": now_us(), "action": action, "actor": actor, "detail": detail}
        await self.kv.rpush(AUDIT_KEY, json.dumps(ev).encode())
        await self.kv.ltrim(AUDIT_KEY, -AUDIT_CAP, -1)

    async def audit_log(self) -> list[dict]:
        return [json.loads(b) for b in await self.kv.lrange(AUDIT_KEY)]

    # -- bundles --------------------------------------------------------
    def _frag_id(self, bundle_id: str) -> str:
        return f"{POLICY_FRAGMENT_PREFIX}/{bundle_id}"

    async def list_bundles(self) -> list[dict]:
        out = []
        for frag_id in sorted(await self.configsvc.list("system")):
            if not frag_id.startswith(POLICY_FRAGMENT_PREFIX + "/"):
                continue
            doc = await self.configsvc.get("system", frag_id)
            if doc is None:
                continue
            out.append({
                "bundle_id": frag_id[len(POLICY_FRAGMENT_PREFIX) + 1:],
                "enabled": bool(doc.data.get("enabled", True)),
                "revision": doc.revision,
                "rules": len(doc.data.get("rules") or []),
            })
        return out

    async def get_bundle(self, bundle_id: str) -> Optional[dict]:
        doc = await self.configsvc.get("system", self._frag_id(bundle_id))
        if doc is None:
            return None
        return {"bundle_id": bundle_id, "revision": doc.revision, "data": doc.data}

    async def put_bundle(self, bundle_id: str, data: dict, *, actor: str) -> dict:
        """Staged write: new bundles land disabled until published."""
        data = dict(data)
        data.setdefault("enabled", False)
        doc = await self.configsvc.set("system", self._frag_id(bundle_id), data)
        await self._audit("put_bundle", actor, f"{bundle_id} rev {doc.revision}")
        await self.kernel.reload()
        return {"bundle_id": bundle_id, "revision": doc.revision, "enabled": data["enabled"]}

    async def delete_bundle(self, bundle_id: str, *, actor: str) -> bool:
        ok = await self.configsvc.delete("system", self._frag_id(bundle_id))
        if ok:
            await self._audit("delete_bundle", actor, bundle_id)
            await self.kernel.reload()
        return ok

    async def publish(self, bundle_id: str, *, actor: str) -> dict:
        doc = await self.configsvc.get("system", self._frag_id(bundle_id))
        if doc is None:
            raise KeyError(f"unknown bundle {bundle_id!r}")
        data = dict(doc.data)
        data["enabled"] = True
        await self.configsvc.set("system", self._frag_id(bundle_id), data)
        snap = await self.kernel.reload()
        await self._audit("publish", actor, f"{bundle_id} → snapshot {snap}")
        return {"bundle_id": bundle_id, "enabled": True, "policy_snapshot": snap}

    async def unpublish(self, bundle_id: str, *, actor: str) -> dict:
        doc = await self.configsvc.get("system", self._frag_id(bundle_id))
        if doc is None:
            raise KeyError(f"unknown bundle {bundle_id!r}")
        data = dict(doc.data)
        data["enabled"] = False
        await self.configsvc.set("system", self._frag_id(bundle_id), data)
        snap = await self.kernel.reload()
        await self._audit("unpublish", actor, f"{bundle_id} → snapshot {snap}")
        return {"bundle_id": bundle_id, "enabled": False, "policy_snapshot": snap}

    # -- draft simulation ------------------------------------------------
    async def simulate_draft(self, bundle_data: dict, requests: list) -> list[dict]:
        """Evaluate requests against current policy + draft bundle rules."""
        merged = dict(self.kernel._merged_doc)
        merged = json.loads(json.dumps(merged))  # deep copy
        merged.setdefault("rules", [])
        merged["rules"] = list(bundle_data.get("rules") or []) + merged["rules"]
        return await self.kernel.simulate(merged, requests)

    # -- snapshots -------------------------------------------------------
    async def capture_snapshot(self, *, actor: str, note: str = "") -> dict:
        """Persist the current merged policy + fragment set for rollback."""
        snap_id = await self.kernel.reload() or self.kernel.snapshot_id
        fragments = {}
        for frag_id in await self.configsvc.list("system"):
            if frag_id.startswith(POLICY_FRAGMENT_PREFIX + "/"):
                doc = await self.configsvc.get("system", frag_id)
                if doc:
                    fragments[frag_id] = doc.data
        record = {
            "snapshot_id": snap_id,
            "captured_at_us": now_us(),
            "note": note,
            "fragments": fragments,
            "merged": self.kernel.get_snapshot(snap_id) or {},
        }
        await self.kv.set(SNAPSHOT_PREFIX + snap_id, json.dumps(record).encode())
        await self.kv.zadd("policy:snapshot:index", snap_id, float(record["captured_at_us"]))
        await self._audit("capture_snapshot", actor, snap_id)
        return {"snapshot_id": snap_id, "fragments": len(fragments)}

    async def list_captured(self) -> list[dict]:
        out = []
        for snap_id in await self.kv.zrange("policy:snapshot:index", desc=True):
            b = await self.kv.get(SNAPSHOT_PREFIX + snap_id)
            if b:
                rec = json.loads(b)
                out.append({"snapshot_id": snap_id, "captured_at_us": rec["captured_at_us"],
                            "note": rec.get("note", ""), "fragments": len(rec.get("fragments", {}))})
        return out

    async def get_captured(self, snapshot_id: str) -> Optional[dict]:
        b = await self.kv.get(SNAPSHOT_PREFIX + snapshot_id)
        return json.loads(b) if b else None

    async def rollback(self, snapshot_id: str, *, actor: str) -> dict:
        """Restore the captured fragment set (removing fragments added since)."""
        rec = await self.get_captured(snapshot_id)
        if rec is None:
            raise KeyError(f"unknown snapshot {snapshot_id!r}")
        captured = rec.get("fragments", {})
        current = [
            f for f in await self.configsvc.list("system")
            if f.startswith(POLICY_FRAGMENT_PREFIX + "/")
        ]
        for frag_id in current:
            if frag_id not in captured:
                await self.configsvc.delete("system", frag_id)
        for frag_id, data in captured.items():
            await self.configsvc.set("system", frag_id, data)
        snap = await self.kernel.reload()
        await self._audit("rollback", actor, f"{snapshot_id} → snapshot {snap}")
        return {"rolled_back_to": snapshot_id, "policy_snapshot": snap}
