"""Safety kernel service: Check/Evaluate/Explain/Simulate/ListSnapshots.

Recreates reference ``core/controlplane/safetykernel/kernel.go`` behavior:

  * policy loaded from YAML file and/or config-service fragments stored
    under the ``cfg:system:policy`` namespace (each fragment has an
    ``enabled`` toggle; fragments append rules — kernel.go:590-655)
  * snapshot id = ``<version>:<sha256[:12]>`` of the merged policy
    (+ effective-config hash when present); last 10 snapshots retained
  * decision cache keyed by hash(request minus job_id) + snapshot with TTL
    (kernel.go:259-274)
  * hot reload: ``reload()`` recomputes the snapshot; callers poll
  * ed25519 signature verification for signed policy bundles
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from ...infra.configsvc import ConfigService
from ...protocol.types import SPAN_ERROR, SPAN_OK, PolicyCheckRequest, PolicyCheckResponse
from .policy import SafetyPolicy, evaluate

POLICY_FRAGMENT_PREFIX = "policy"  # cfg:system:policy/<fragment-id>
DEFAULT_CACHE_TTL_S = 5.0
MAX_SNAPSHOTS = 10


def _read_file(path: str) -> Optional[bytes]:
    """Read a policy artifact; None when absent (callers fail closed)."""
    try:
        with open(path, "rb") as f:  # cordumlint: disable=CL003 -- runs via asyncio.to_thread
            return f.read()
    except FileNotFoundError:
        return None


def _policy_hash(doc: dict) -> str:
    canonical = json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(canonical.encode()).hexdigest()


@dataclass
class Snapshot:
    snapshot_id: str
    policy_doc: dict
    created_at: float = field(default_factory=time.time)


class SafetyKernel:
    def __init__(
        self,
        *,
        policy_doc: Optional[dict] = None,
        policy_path: str = "",
        configsvc: Optional[ConfigService] = None,
        cache_ttl_s: float = DEFAULT_CACHE_TTL_S,
        public_key_path: str = "",
        tracer: Optional[Any] = None,
    ):
        # flight-recorder tracer (obs.Tracer) for embedded deployments; when
        # the kernel runs behind KernelService the SERVICE owns the span so
        # leave this unset there (one "evaluate" span per check either way)
        self._tracer = tracer
        # evaluate spans still being published (off the decision path)
        self._emits: set[asyncio.Task] = set()
        self._file_doc = policy_doc or {}
        self._policy_path = policy_path
        # signed bundles: when a pubkey is configured, the policy file must
        # carry a valid detached ed25519 signature at <path>.sig — fail
        # closed to the previous (or empty) policy otherwise
        import os as _os

        self._public_key_path = public_key_path or _os.environ.get("SAFETY_POLICY_PUBKEY", "")
        self._configsvc = configsvc
        self._cache_ttl_s = cache_ttl_s
        self._cache: dict[str, tuple[float, PolicyCheckResponse]] = {}
        self._version = 0
        self._policy = SafetyPolicy()
        self._snapshot_id = ""
        self._snapshots: list[Snapshot] = []
        self._merged_doc: dict = {}
        # last file-level doc that passed signature verification (signed mode):
        # reused when the file goes missing/tampered so fragments still merge
        self._last_verified_doc: Optional[dict] = None

    # ------------------------------------------------------------------
    async def reload(self) -> str:
        """Re-merge file policy + config-service fragments; returns snapshot id."""
        import copy

        # deep copy: fragment merging must never mutate the base document,
        # or disabled fragments' tenants/rules would persist across reloads
        doc = copy.deepcopy(self._file_doc)
        if self._policy_path:
            import asyncio

            raw = await asyncio.to_thread(_read_file, self._policy_path)
            if self._public_key_path:
                # Signed mode: a missing file fails closed exactly like a bad
                # signature — deleting/mis-pathing the file must not silently
                # disable enforcement. Both paths fall THROUGH to the fragment
                # merge below so configsvc policy updates keep applying.
                verified = False
                if raw is not None:
                    sig = await asyncio.to_thread(_read_file, self._policy_path + ".sig")
                    pub = await asyncio.to_thread(_read_file, self._public_key_path)
                    if sig is not None and pub is not None:
                        verified = verify_signature(raw, sig, pub)
                if verified:
                    doc = yaml.safe_load(raw) or {}
                    self._last_verified_doc = copy.deepcopy(doc)
                else:
                    import logging as _l

                    _l.getLogger("cordum").error(
                        "signed policy %s %s; fail-closed to %s",
                        self._policy_path,
                        "missing" if raw is None else "signature verification FAILED",
                        "previous verified policy" if self._last_verified_doc else "deny-all",
                    )
                    if self._last_verified_doc is not None:
                        doc = copy.deepcopy(self._last_verified_doc)
                    else:
                        # nothing verified has EVER been installed:
                        # deny-all until a signed policy arrives
                        doc = {
                            "rules": [{
                                "id": "unverified-policy-deny-all",
                                "match": {},
                                "decision": "deny",
                                "reason": "policy signature unverified (fail-closed)",
                            }]
                        }
            elif raw is not None:
                doc = yaml.safe_load(raw) or {}
        # Schema-validate the file-level policy before merging fragments: a
        # malformed safety.yaml fails startup with a pointed error; on hot
        # reload the previous good policy is kept (reference validation.go:11).
        from ...infra.configschema import SAFETY_SCHEMA, ConfigError, validate

        try:
            validate(doc, SAFETY_SCHEMA, self._policy_path or "policy_doc")
        except ConfigError as e:
            if self._merged_doc:
                import logging as _l

                _l.getLogger("cordum").error(
                    "invalid policy document on reload (%s); keeping previous", e
                )
                return self._snapshot_id
            raise
        rules = list(doc.get("rules") or [])
        if self._configsvc is not None:
            for frag_id in sorted(await self._configsvc.list("system")):
                if not frag_id.startswith(POLICY_FRAGMENT_PREFIX + "/"):
                    continue
                frag = await self._configsvc.get("system", frag_id)
                if not frag or not frag.data.get("enabled", True):
                    continue
                # fragments get the same schema treatment as the file: a
                # typo'd rule must not load silently — skip + log the
                # offending fragment, keep the rest (hot-path equivalent of
                # keep-previous-on-reload)
                frag_doc = {"rules": frag.data.get("rules") or [],
                            "tenants": frag.data.get("tenants") or {}}
                try:
                    validate(frag_doc, SAFETY_SCHEMA, f"policy fragment {frag_id}")
                except ConfigError as e:
                    import logging as _l

                    _l.getLogger("cordum").error(
                        "skipping invalid policy fragment: %s", e
                    )
                    continue
                rules.extend(frag_doc["rules"])
                for tname, tpol in frag_doc["tenants"].items():
                    doc.setdefault("tenants", {})[tname] = tpol
        doc["rules"] = rules
        h = _policy_hash(doc)
        if self._merged_doc and _policy_hash(self._merged_doc) == h:
            return self._snapshot_id
        self._version += 1
        self._merged_doc = doc
        self._policy = SafetyPolicy.from_dict(doc)
        self._snapshot_id = f"{self._version}:{h[:12]}"
        self._snapshots.append(Snapshot(self._snapshot_id, doc))
        del self._snapshots[:-MAX_SNAPSHOTS]
        self._cache.clear()
        return self._snapshot_id

    @property
    def snapshot_id(self) -> str:
        return self._snapshot_id

    def list_snapshots(self) -> list[dict]:
        return [
            {"snapshot_id": s.snapshot_id, "created_at": s.created_at}
            for s in self._snapshots
        ]

    def get_snapshot(self, snapshot_id: str) -> Optional[dict]:
        for s in self._snapshots:
            if s.snapshot_id == snapshot_id:
                return s.policy_doc
        return None

    # ------------------------------------------------------------------
    def _cache_key(self, req: PolicyCheckRequest) -> str:
        d = req.to_dict()
        d.pop("job_id", None)
        canonical = json.dumps(d, sort_keys=True, separators=(",", ":"), default=str)
        return hashlib.sha256(canonical.encode()).hexdigest() + "|" + self._snapshot_id

    async def check(self, req: PolicyCheckRequest) -> PolicyCheckResponse:
        """Evaluate with decision cache (the hot path the scheduler calls).
        Emits an ``evaluate`` span (service ``safety-kernel``) when a tracer
        is wired and an ambient trace context exists.

        The span is published off the decision path (a departure from the
        reference, which awaits the publish inside the check): across a
        statebus failover the publish parks until the bus reconnects, which
        outlasted the scheduler's check timeout and denied jobs fail-closed
        for want of a trace span."""
        if self._tracer is None:
            return await self._check_cached(req)
        sp = self._tracer.begin("evaluate", attrs={"topic": req.topic})
        try:
            resp = await self._check_cached(req)
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            self._emit(sp, SPAN_ERROR)
            raise
        sp.attrs["decision"] = resp.decision
        sp.attrs["snapshot"] = self._snapshot_id
        self._emit(sp, SPAN_OK)
        return resp

    def _emit(self, sp: Any, status: str) -> None:
        task = asyncio.ensure_future(self._tracer.finish(sp, status=status))
        self._emits.add(task)
        task.add_done_callback(self._emits.discard)

    async def _check_cached(self, req: PolicyCheckRequest) -> PolicyCheckResponse:
        if not self._snapshot_id:
            await self.reload()
        key = self._cache_key(req)
        now = time.monotonic()
        hit = self._cache.get(key)
        if hit is not None and now - hit[0] < self._cache_ttl_s:
            return hit[1]
        resp = evaluate(self._policy, req, self._snapshot_id)
        self._apply_effective_overrides(req, resp)
        if len(self._cache) > 8192:
            self._cache = {k: v for k, v in self._cache.items() if now - v[0] < self._cache_ttl_s}
        self._cache[key] = (now, resp)
        return resp

    def _apply_effective_overrides(self, req: PolicyCheckRequest, resp: PolicyCheckResponse) -> None:
        """Effective-config safety overrides: denied/allowed topic lists in the
        job's effective config can deny an otherwise-allowed job
        (reference kernel.go:218-231)."""
        eff = req.effective_config or {}
        safety = eff.get("safety") if isinstance(eff, dict) else None
        if not isinstance(safety, dict) or resp.decision == "DENY":
            return
        from ...utils.globmatch import glob_match

        denied = safety.get("denied_topics") or []
        if any(glob_match(p, req.topic) for p in denied):
            resp.decision = "DENY"
            resp.reason = f"effective config denies topic {req.topic}"
            return
        allowed = safety.get("allowed_topics") or []
        if allowed and not any(glob_match(p, req.topic) for p in allowed):
            resp.decision = "DENY"
            resp.reason = f"topic {req.topic} not in effective-config allowlist"

    async def evaluate_raw(self, req: PolicyCheckRequest) -> PolicyCheckResponse:
        """Uncached evaluation (Evaluate/Simulate RPC equivalent)."""
        if not self._snapshot_id:
            await self.reload()
        resp = evaluate(self._policy, req, self._snapshot_id)
        self._apply_effective_overrides(req, resp)
        return resp

    async def explain(self, req: PolicyCheckRequest) -> dict[str, Any]:
        """Decision plus per-rule match trail (Explain RPC equivalent)."""
        if not self._snapshot_id:
            await self.reload()
        from .policy import _matches  # noqa: internal reuse

        tenant = req.tenant_id or self._policy.default_tenant
        trail = [
            {"rule_id": r.id, "decision": r.decision, "matched": _matches(r.match, req, tenant)}
            for r in self._policy.rules
        ]
        resp = await self.evaluate_raw(req)
        return {"decision": resp.to_dict(), "trail": trail, "snapshot": self._snapshot_id}

    async def simulate(self, policy_doc: dict, reqs: list[PolicyCheckRequest]) -> list[dict]:
        """Evaluate requests against a *draft* policy without installing it."""
        pol = SafetyPolicy.from_dict(policy_doc)
        return [evaluate(pol, r, "draft").to_dict() for r in reqs]


def verify_signature(policy_bytes: bytes, signature: bytes, public_key_bytes: bytes) -> bool:
    """Ed25519 signature check for signed policy bundles
    (reference kernel.go:832-868).  Uses the cryptography backend when
    available, else the pure-Python verifier in ``utils.ed25519`` — a
    missing crypto library must not silently disable signed-policy
    enforcement on minimal worker images.  Any verification failure
    returns False (callers fail closed)."""
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
    except ImportError:
        from ...utils.ed25519 import verify as _pure_verify

        return _pure_verify(public_key_bytes, signature, policy_bytes)
    try:
        Ed25519PublicKey.from_public_bytes(public_key_bytes).verify(signature, policy_bytes)
        return True
    except Exception as e:  # noqa: BLE001 - bad sig/key/encoding all deny
        import logging as _l

        _l.getLogger("cordum").debug("policy signature rejected: %s", e)
        return False
