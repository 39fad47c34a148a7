"""Safety policy model + evaluator.

Recreates the reference policy semantics (``core/infra/config/safety_policy.go``):
YAML ``SafetyPolicy{rules[], tenants{}, default_tenant}``; each ``PolicyRule``
has a match block (tenants, topics as globs, capabilities, risk_tags,
requires, pack_ids, actor_ids, actor_types, labels, secrets_present, mcp),
a decision (allow / deny / require_approval / allow_with_constraints /
throttle), optional constraints and remediations.  **First match wins**,
default allow.  Legacy per-tenant allow/deny topic lists are the fallback
when no rule matches (safety_policy.go:225-257).  MCP allow/deny checked
via labels (``mcp.server`` etc., :385-416).

TPU-native extension: rule constraints may bound ``max_chips`` /
``allowed_topologies`` so policy can gate how much of a pod slice a job may
occupy (north-star: the policy gate learns TPU-slice constraints).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from ...protocol.types import (
    Constraints,
    Decision,
    PolicyCheckRequest,
    PolicyCheckResponse,
    Remediation,
)
from ...utils.globmatch import glob_match


@dataclass
class MCPPolicy:
    allow_servers: list[str] = field(default_factory=list)
    deny_servers: list[str] = field(default_factory=list)
    allow_tools: list[str] = field(default_factory=list)
    deny_tools: list[str] = field(default_factory=list)
    allow_resources: list[str] = field(default_factory=list)
    deny_resources: list[str] = field(default_factory=list)
    allow_actions: list[str] = field(default_factory=list)
    deny_actions: list[str] = field(default_factory=list)


@dataclass
class TenantPolicy:
    allow_topics: list[str] = field(default_factory=list)
    deny_topics: list[str] = field(default_factory=list)
    max_concurrent_jobs: int = 0
    mcp: MCPPolicy = field(default_factory=MCPPolicy)


@dataclass
class RuleMatch:
    tenants: list[str] = field(default_factory=list)
    topics: list[str] = field(default_factory=list)
    capabilities: list[str] = field(default_factory=list)
    risk_tags: list[str] = field(default_factory=list)
    requires: list[str] = field(default_factory=list)
    pack_ids: list[str] = field(default_factory=list)
    actor_ids: list[str] = field(default_factory=list)
    actor_types: list[str] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    secrets_present: Optional[bool] = None
    mcp: Optional[bool] = None


@dataclass
class PolicyRule:
    id: str = ""
    description: str = ""
    match: RuleMatch = field(default_factory=RuleMatch)
    decision: str = "allow"
    reason: str = ""
    constraints: Optional[Constraints] = None
    remediations: list[Remediation] = field(default_factory=list)
    throttle_delay_s: float = 0.0


@dataclass
class SafetyPolicy:
    rules: list[PolicyRule] = field(default_factory=list)
    tenants: dict[str, TenantPolicy] = field(default_factory=dict)
    default_tenant: str = "default"

    @classmethod
    def from_yaml(cls, text: str) -> "SafetyPolicy":
        return cls.from_dict(yaml.safe_load(text) or {})

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "SafetyPolicy":
        pol = cls(default_tenant=doc.get("default_tenant", "default"))
        for name, t in (doc.get("tenants") or {}).items():
            t = t or {}
            mcp = t.get("mcp") or {}
            pol.tenants[name] = TenantPolicy(
                allow_topics=list(t.get("allow_topics") or []),
                deny_topics=list(t.get("deny_topics") or []),
                max_concurrent_jobs=int(t.get("max_concurrent_jobs") or 0),
                mcp=MCPPolicy(**{k: list(v or []) for k, v in mcp.items() if k in MCPPolicy.__dataclass_fields__}),
            )
        for i, r in enumerate(doc.get("rules") or []):
            m = r.get("match") or {}
            c = r.get("constraints")
            constraints = Constraints.from_dict(c) if c else None
            rems = [Remediation.from_dict(x) for x in (r.get("remediations") or [])]
            pol.rules.append(
                PolicyRule(
                    id=str(r.get("id") or f"rule-{i}"),
                    description=str(r.get("description") or ""),
                    match=RuleMatch(
                        tenants=list(m.get("tenants") or []),
                        topics=list(m.get("topics") or []),
                        capabilities=list(m.get("capabilities") or []),
                        risk_tags=list(m.get("risk_tags") or []),
                        requires=list(m.get("requires") or []),
                        pack_ids=list(m.get("pack_ids") or []),
                        actor_ids=list(m.get("actor_ids") or []),
                        actor_types=list(m.get("actor_types") or []),
                        labels={str(k): str(v) for k, v in (m.get("labels") or {}).items()},
                        secrets_present=m.get("secrets_present"),
                        mcp=m.get("mcp"),
                    ),
                    decision=str(r.get("decision") or "allow").lower(),
                    reason=str(r.get("reason") or ""),
                    constraints=constraints,
                    remediations=rems,
                    throttle_delay_s=float(r.get("throttle_delay_s") or 0.0),
                )
            )
        return pol


_DECISION_MAP = {
    "allow": Decision.ALLOW,
    "deny": Decision.DENY,
    "require_approval": Decision.REQUIRE_APPROVAL,
    "allow_with_constraints": Decision.ALLOW_WITH_CONSTRAINTS,
    "throttle": Decision.THROTTLE,
}

MCP_LABELS = ("mcp.server", "mcp.tool", "mcp.resource", "mcp.action")


def _has_mcp_labels(labels: dict[str, str]) -> bool:
    return any(k in labels for k in MCP_LABELS)


def _any_glob(patterns: list[str], value: str) -> bool:
    return any(glob_match(p, value) for p in patterns)


def _matches(rule: RuleMatch, req: PolicyCheckRequest, tenant: str) -> bool:
    meta = req.metadata
    if rule.tenants and tenant not in rule.tenants:
        return False
    if rule.topics and not _any_glob(rule.topics, req.topic):
        return False
    if rule.capabilities:
        cap = meta.capability if meta else ""
        if cap not in rule.capabilities:
            return False
    if rule.risk_tags:
        tags = set(meta.risk_tags) if meta else set()
        if not tags & set(rule.risk_tags):
            return False
    if rule.requires:
        reqs = set(meta.requires) if meta else set()
        if not set(rule.requires) <= reqs:
            return False
    if rule.pack_ids:
        pid = meta.pack_id if meta else ""
        if pid not in rule.pack_ids:
            return False
    if rule.actor_ids and req.actor_id not in rule.actor_ids:
        return False
    if rule.actor_types and req.actor_type not in rule.actor_types:
        return False
    for k, v in rule.labels.items():
        if req.labels.get(k) != v:
            return False
    if rule.secrets_present is not None:
        present = req.labels.get("secrets_present") == "true"
        if present != rule.secrets_present:
            return False
    if rule.mcp is not None:
        if _has_mcp_labels(req.labels) != rule.mcp:
            return False
    return True


def _mcp_allowed(mcp: MCPPolicy, labels: dict[str, str]) -> tuple[bool, str]:
    checks = (
        ("mcp.server", mcp.allow_servers, mcp.deny_servers),
        ("mcp.tool", mcp.allow_tools, mcp.deny_tools),
        ("mcp.resource", mcp.allow_resources, mcp.deny_resources),
        ("mcp.action", mcp.allow_actions, mcp.deny_actions),
    )
    for label, allow, deny in checks:
        v = labels.get(label, "")
        if not v:
            continue
        if deny and _any_glob(deny, v):
            return False, f"{label}={v} denied"
        if allow and not _any_glob(allow, v):
            return False, f"{label}={v} not in allowlist"
    return True, ""


def evaluate(policy: SafetyPolicy, req: PolicyCheckRequest, snapshot: str = "") -> PolicyCheckResponse:
    """First-match rule evaluation with legacy tenant fallback."""
    tenant = req.tenant_id or policy.default_tenant

    # MCP gate runs first when MCP labels are present (reference MCPAllowed)
    tp = policy.tenants.get(tenant) or policy.tenants.get(policy.default_tenant)
    if tp and _has_mcp_labels(req.labels):
        ok, why = _mcp_allowed(tp.mcp, req.labels)
        if not ok:
            return PolicyCheckResponse(
                decision=Decision.DENY.value, reason=f"mcp: {why}", policy_snapshot=snapshot
            )

    for rule in policy.rules:
        if not _matches(rule.match, req, tenant):
            continue
        decision = _DECISION_MAP.get(rule.decision, Decision.ALLOW)
        resp = PolicyCheckResponse(
            decision=decision.value,
            reason=rule.reason or rule.description or f"rule {rule.id}",
            rule_id=rule.id,
            policy_snapshot=snapshot,
            constraints=rule.constraints,
            remediations=rule.remediations,
            throttle_delay_s=rule.throttle_delay_s,
        )
        if decision is Decision.REQUIRE_APPROVAL:
            resp.approval_required = True
        return resp

    # legacy tenant allow/deny topic lists
    if tp:
        if tp.deny_topics and _any_glob(tp.deny_topics, req.topic):
            return PolicyCheckResponse(
                decision=Decision.DENY.value,
                reason=f"topic {req.topic} denied for tenant {tenant}",
                policy_snapshot=snapshot,
            )
        if tp.allow_topics and not _any_glob(tp.allow_topics, req.topic):
            return PolicyCheckResponse(
                decision=Decision.DENY.value,
                reason=f"topic {req.topic} not in tenant {tenant} allowlist",
                policy_snapshot=snapshot,
            )
    return PolicyCheckResponse(decision=Decision.ALLOW.value, reason="default allow", policy_snapshot=snapshot)
