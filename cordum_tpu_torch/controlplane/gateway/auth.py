"""Gateway auth: pluggable provider, OSS flat API-key allowlist
(reference ``core/controlplane/gateway/basic_auth.go`` + ``auth_provider.go``).

The OSS provider trusts ``X-Principal-Id`` once the API key checks out, but
``X-Principal-Role`` may never ESCALATE a non-admin key to admin — admin
status is key-derived (``admin_keys``), and tenant selection is bounded by
the key's assigned tenant (reference ResolveTenant/RequireTenantAccess,
``basic_auth.go:100-122``).  Enterprise RBAC is explicitly out of scope
(reference keeps it out-of-repo too).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Principal:
    principal_id: str = "anonymous"
    role: str = "user"  # user | admin
    tenant_id: str = "default"
    authenticated: bool = False
    # True only when the admin status is key-derived (or dev open mode) —
    # never from the client-forgeable X-Principal-Role header. Use this for
    # authorization decisions that cross trust boundaries (tenant escapes).
    key_admin: bool = False


class AuthProvider:
    def authenticate(self, headers) -> Optional[Principal]:
        raise NotImplementedError


class BasicAuthProvider(AuthProvider):
    """Flat API-key allowlist; empty key list = open (dev mode)."""

    def __init__(self, api_keys: Optional[list[str]] = None, *, admin_keys: Optional[list[str]] = None,
                 default_tenant: str = "default",
                 key_tenants: Optional[dict[str, str]] = None):
        self.api_keys = set(api_keys or [])
        self.admin_keys = set(admin_keys or [])
        self.default_tenant = default_tenant
        # key → tenant that key is scoped to (reference ResolveTenant /
        # RequireTenantAccess, basic_auth.go:100-122): a keyholder may not
        # pick an arbitrary tenant — only its assigned one (or the default).
        self.key_tenants = dict(key_tenants or {})

    def authenticate(self, headers) -> Optional[Principal]:
        key = headers.get("X-Api-Key", "")
        auth = headers.get("Authorization", "")
        if not key and auth.startswith("Bearer "):
            key = auth[len("Bearer "):]
        # dev open mode ONLY when no keys of either kind are configured:
        # admin_keys alone must still gate (and must not make anonymous
        # requests key_admin)
        keyed = bool(self.api_keys or self.admin_keys)
        if keyed and key not in self.api_keys and key not in self.admin_keys:
            return None
        key_admin = (key in self.admin_keys) or not keyed
        role = headers.get("X-Principal-Role", "")
        if key and key in self.admin_keys:
            role = role or "admin"
        elif keyed and role == "admin":
            role = "user"  # header may not escalate a non-admin key
        allowed_tenant = self.key_tenants.get(key, self.default_tenant)
        requested = headers.get("X-Tenant-Id", "")
        if requested and requested != allowed_tenant and not key_admin:
            return None
        return Principal(
            principal_id=headers.get("X-Principal-Id", "anonymous"),
            role=role or "user",
            tenant_id=requested or allowed_tenant,
            authenticated=bool(key) or not keyed,
            key_admin=key_admin,
        )


class TokenBucket:
    """Per-key token bucket (reference gateway rate limiting,
    ``API_RATE_LIMIT_RPS/BURST``)."""

    def __init__(self, rps: float = 0.0, burst: int = 0):
        self.rps = rps
        self.burst = burst or int(rps * 2) or 1
        self._state: dict[str, tuple[float, float]] = {}

    def allow(self, key: str) -> bool:
        if self.rps <= 0:
            return True
        now = time.monotonic()
        tokens, last = self._state.get(key, (float(self.burst), now))
        tokens = min(self.burst, tokens + (now - last) * self.rps)
        if tokens < 1.0:
            self._state[key] = (tokens, now)
            return False
        self._state[key] = (tokens - 1.0, now)
        return True
