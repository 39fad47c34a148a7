"""Config validation: embedded JSON schemas + the typed config taxonomy.

The reference validates every YAML config file at parse time against
embedded JSON schemas (``core/infra/config/validation.go:11``,
``config/schema/*.schema.json``) and defines a typed taxonomy of effective-
config fields (``core/infra/config/categories.go:6-160``: safety / budget /
rate / retry / resources / models / context / slo / observability /
alerting).  This module is the TPU-native equivalent: a typo'd pool file or
malformed safety policy fails startup with a pointed error instead of
loading silently, and the taxonomy documents (and validates) every
effective-config field the code actually reads.

``python -m cordum_tpu_torch.infra.configschema`` prints the taxonomy as markdown
(the generated doc lives at ``docs/CONFIG.md``).
"""
from __future__ import annotations

from typing import Any

import jsonschema


class ConfigError(ValueError):
    """A config document failed schema validation."""


_STR_LIST = {"type": "array", "items": {"type": "string"}}
_STR_MAP = {"type": "object", "additionalProperties": {"type": "string"}}
_NONNEG = {"type": "number", "minimum": 0}
_NONNEG_INT = {"type": "integer", "minimum": 0}

# ---------------------------------------------------------------------------
# pools.yaml  (reference core/infra/config/pools.go + pool.schema.json)
# ---------------------------------------------------------------------------

POOLS_SCHEMA: dict[str, Any] = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "topics": {
            "type": "object",
            "additionalProperties": {
                "anyOf": [{"type": "string"}, _STR_LIST],
            },
        },
        "pools": {
            "type": "object",
            "additionalProperties": {
                "anyOf": [{"type": "null"}, {
                    "type": "object",
                    "properties": {
                        "requires": _STR_LIST,
                        "max_parallel_jobs": _NONNEG_INT,
                        # TPU slice constraints (north-star extension)
                        "min_chips": _NONNEG_INT,
                        "topology": {"type": "string", "pattern": r"^(\d+x\d+(x\d+)?)?$"},
                        "device_kind": {"type": "string"},
                        # micro-batching limits (cordum_tpu_torch/batching)
                        "max_batch_size": _NONNEG_INT,
                        "max_batch_wait_ms": _NONNEG,
                        # serving limits (cordum_tpu_torch/serving, docs/SERVING.md)
                        "serving_cache_pages": _NONNEG_INT,
                        "serving_page_size": _NONNEG_INT,
                        "serving_max_sessions": _NONNEG_INT,
                        "serving_max_new_tokens": _NONNEG_INT,
                        "serving_prefill_budget": _NONNEG_INT,
                        # prefill/decode disaggregation (docs/SERVING.md
                        # §Disaggregation): placement role + the mid-prefill
                        # hand-off token threshold (0 = on completion)
                        "serving_role": {
                            "enum": ["prefill", "decode", "mixed", ""],
                        },
                        "serving_handoff_tokens": _NONNEG_INT,
                        # prefix cache + session tiering (docs/SERVING.md
                        # §Prefix cache and tiering): CoW shared-prefix KV
                        # toggle + idle seconds before a cached prefix is
                        # hibernated to the host-RAM cold arena (0 = never)
                        "serving_prefix_cache": {"type": "boolean"},
                        "serving_speculative": {"type": "boolean"},
                        "serving_draft_k": _NONNEG_INT,
                        "serving_hibernate_after_s": _NONNEG,
                        # cold-arena backing store: "" = host RAM only,
                        # "statebus" = journaled to the statebus KV so
                        # hibernated sessions survive a worker restart
                        "serving_cold_tier": {"enum": ["statebus", ""]},
                    },
                    "additionalProperties": False,
                }],
            },
        },
        # scheduler keyspace sharding: total shard count; each
        # shard binary picks its index via --shard-index / SCHEDULER_SHARD_INDEX
        "scheduler": {
            "type": "object",
            "properties": {"shards": {"type": "integer", "minimum": 1}},
            "additionalProperties": False,
        },
        # statebus replication fleet defaults (cmd.statebus; env vars win —
        # docs/PROTOCOL.md §Replication): partition count, replicas per
        # partition, commit ack mode, and the primary-dead detection window
        "statebus": {
            "type": "object",
            "properties": {
                "partitions": {"type": "integer", "minimum": 1},
                "replicas": _NONNEG_INT,
                "sync_replication": {"type": "boolean"},
                "heartbeat_timeout_s": _NONNEG,
            },
            "additionalProperties": False,
        },
        # SLO objectives per job class (cordum_tpu_torch/obs/slo.py): the gateway's
        # SLOTracker evaluates multi-window burn rates against these from the
        # fleet-aggregated series (docs/OBSERVABILITY.md §Fleet telemetry)
        "slo": {
            "type": "object",
            "additionalProperties": {
                "type": "object",
                "properties": {
                    "job_class": {"type": "string"},
                    "latency_ms": {"type": "number", "exclusiveMinimum": 0},
                    "latency_target": {
                        "type": "number", "minimum": 0, "exclusiveMaximum": 1,
                    },
                    "availability_target": {
                        "type": "number", "minimum": 0, "exclusiveMaximum": 1,
                    },
                },
                "required": ["latency_ms"],
                "additionalProperties": False,
            },
        },
        # capacity-aware gateway admission control (docs/ADMISSION.md): the
        # AdmissionController sheds analytically against the measured fleet
        # capacity matrix, enforces per-tenant token-bucket quotas, and runs
        # the brownout ladder off the interactive SLO burn signal
        "admission": {
            "type": "object",
            "properties": {
                "enabled": {"type": "boolean"},
                # admit up to this fraction of measured steady-state capacity
                "safety_factor": {
                    "type": "number", "exclusiveMinimum": 0, "maximum": 1,
                },
                # offered-rate EWMA smoothing (0 < alpha <= 1)
                "smoothing_alpha": {
                    "type": "number", "exclusiveMinimum": 0, "maximum": 1,
                },
                # cold/stale-matrix fallback: shed batch past this fleet
                # scheduler backlog; interactive sheds at the bound below
                "queue_depth_limit": {"type": "integer", "minimum": 1},
                "interactive_queue_bound": {"type": "integer", "minimum": 1},
                "min_retry_after_s": _NONNEG,
                "max_retry_after_s": _NONNEG,
                # ops shed at brownout tier 2 (best-effort work)
                "best_effort_ops": _STR_LIST,
                # per-tenant token buckets; rate_rps 0 = unlimited.  The
                # "default" entry applies to tenants with no explicit stanza.
                "tenants": {
                    "type": "object",
                    "additionalProperties": {
                        "type": "object",
                        "properties": {
                            "rate_rps": _NONNEG,
                            "burst": _NONNEG,
                        },
                        "additionalProperties": False,
                    },
                },
            },
            "additionalProperties": False,
        },
        # scheduler-side decode rebalancer (docs/SERVING.md
        # §Disaggregation): skew detection against the capacity view's
        # decode occupancy + KV-page pressure, hysteresis-guarded and
        # rate-limited so sessions never ping-pong
        "rebalancer": {
            "type": "object",
            "properties": {
                "enabled": {"type": "boolean"},
                # evaluation cadence
                "interval_s": {"type": "number", "exclusiveMinimum": 0},
                # a worker is hot when occupancy >= skew_ratio x fleet median
                "skew_ratio": {"type": "number", "minimum": 1},
                # consecutive hot evaluations required before a move fires
                "hysteresis_ticks": {"type": "integer", "minimum": 1},
                # per-worker floor between rebalance commands
                "cooldown_s": _NONNEG,
                # sessions moved per command
                "max_moves": {"type": "integer", "minimum": 1},
            },
            "additionalProperties": False,
        },
        # gang scheduling (docs/GANG.md): scheduler-side reservation +
        # worker-side rendezvous knobs for multi-chip SPMD/MPMD gangs
        "gang": {
            "type": "object",
            "properties": {
                "enabled": {"type": "boolean"},
                # worker-side barrier timeout (the scheduler watchdog
                # backstops at 2x before declaring the rendezvous dead)
                "rendezvous_timeout_s": {
                    "type": "number", "exclusiveMinimum": 0,
                },
                # MPMD stage-traffic wait: a peer silent for this long
                # mid-step aborts the gang
                "peer_timeout_s": {"type": "number", "exclusiveMinimum": 0},
                # an unplaceable gang (no slice can EVER cover it) fails
                # to the DLQ after queueing this long
                "queued_timeout_s": {"type": "number", "exclusiveMinimum": 0},
            },
            "additionalProperties": False,
        },
        # tolerated here so one file can carry pools + reconciler (dev mode)
        "reconciler": {"type": "object"},
    },
    "additionalProperties": False,
}

# ---------------------------------------------------------------------------
# timeouts.yaml  (reference core/infra/config/timeouts.go)
# ---------------------------------------------------------------------------

TIMEOUTS_SCHEMA: dict[str, Any] = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "reconciler": {
            "type": "object",
            "properties": {
                "dispatch_timeout_seconds": _NONNEG,
                "running_timeout_seconds": _NONNEG,
                "scan_interval_seconds": _NONNEG,
                "pending_replay_seconds": _NONNEG,
                "result_replay_seconds": _NONNEG,
            },
            "additionalProperties": False,
        },
        "workflows": {"type": "object", "additionalProperties": _NONNEG},
        "topics": {"type": "object", "additionalProperties": _NONNEG},
    },
    "additionalProperties": False,
}

# ---------------------------------------------------------------------------
# safety.yaml  (reference core/infra/config/safety_policy.go:13-146 +
# safety_policy.schema.json; TPU additions: max_chips/allowed_topologies)
# ---------------------------------------------------------------------------

_MCP_SCHEMA = {
    "type": "object",
    "properties": {
        f"{d}_{kind}": _STR_LIST
        for d in ("allow", "deny")
        for kind in ("servers", "tools", "resources", "actions")
    },
    "additionalProperties": False,
}

_CONSTRAINTS_SCHEMA = {
    "type": "object",
    "properties": {
        "max_tokens": _NONNEG_INT,
        "max_cost_usd": _NONNEG,
        "sandbox": {"type": "string"},
        "toolchain": {"type": "string"},
        "diff_limit": {"type": "string"},
        "redaction_level": {"type": "string"},
        "max_chips": _NONNEG_INT,
        "allowed_topologies": _STR_LIST,
        "env": _STR_MAP,
    },
    "additionalProperties": False,
}

_RULE_SCHEMA = {
    "type": "object",
    "properties": {
        "id": {"type": "string"},
        "description": {"type": "string"},
        "match": {
            "type": "object",
            "properties": {
                "tenants": _STR_LIST,
                "topics": _STR_LIST,
                "capabilities": _STR_LIST,
                "risk_tags": _STR_LIST,
                "requires": _STR_LIST,
                "pack_ids": _STR_LIST,
                "actor_ids": _STR_LIST,
                "actor_types": _STR_LIST,
                "labels": _STR_MAP,
                "secrets_present": {"type": "boolean"},
                "mcp": {"type": "boolean"},
            },
            "additionalProperties": False,
        },
        "decision": {
            "enum": ["allow", "deny", "require_approval",
                     "allow_with_constraints", "throttle"],
        },
        "reason": {"type": "string"},
        "constraints": _CONSTRAINTS_SCHEMA,
        "remediations": {
            "type": "array",
            "items": {
                "type": "object",
                "properties": {
                    "id": {"type": "string"},
                    "description": {"type": "string"},
                    "replacement_topic": {"type": "string"},
                    "replacement_capability": {"type": "string"},
                    "add_labels": _STR_MAP,
                    "remove_labels": _STR_LIST,
                },
                "additionalProperties": False,
            },
        },
        "throttle_delay_s": _NONNEG,
    },
    "required": ["decision"],
    "additionalProperties": False,
}

SAFETY_SCHEMA: dict[str, Any] = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "default_tenant": {"type": "string"},
        "tenants": {
            "type": "object",
            "additionalProperties": {
                # null bodies tolerated (an empty `staging:` stanza is valid
                # YAML and the parser treats it as {}), matching POOLS_SCHEMA
                "anyOf": [{"type": "null"}, {
                    "type": "object",
                    "properties": {
                        "allow_topics": _STR_LIST,
                        "deny_topics": _STR_LIST,
                        "max_concurrent_jobs": _NONNEG_INT,
                        "mcp": _MCP_SCHEMA,
                    },
                    "additionalProperties": False,
                }],
            },
        },
        "rules": {"type": "array", "items": _RULE_SCHEMA},
    },
    "additionalProperties": False,
}

# ---------------------------------------------------------------------------
# Effective-config taxonomy (reference categories.go:6-160).  One entry per
# field the control plane actually reads from the merged effective config.
# Each: (category, field, type, consumer, description).
# ---------------------------------------------------------------------------

TAXONOMY: list[tuple[str, str, str, str, str]] = [
    ("safety", "safety.denied_topics", "list[str]",
     "safetykernel.kernel", "extra topic globs denied for every tenant"),
    ("safety", "safety.default_decision", "str",
     "safetykernel.kernel", "fallback decision when no rule matches (allow|deny)"),
    ("safety", "safety.require_approval_topics", "list[str]",
     "safetykernel.kernel", "topic globs that always require human approval"),
    ("budget", "budgets.max_tokens", "int",
     "scheduler.engine", "per-job token ceiling clamped into JobRequest.budget"),
    ("budget", "budgets.max_cost_usd", "float",
     "scheduler.engine", "per-job cost ceiling"),
    ("budget", "budgets.deadline_seconds", "int",
     "scheduler.engine", "default job deadline when the request carries none"),
    ("rate", "rate_limits.concurrent_jobs", "int",
     "scheduler.engine", "per-tenant concurrent-job cap (org-scoped overrides win)"),
    ("rate", "rate_limits.api_rps", "float",
     "gateway.app", "gateway token-bucket refill rate"),
    ("rate", "rate_limits.api_burst", "int",
     "gateway.app", "gateway token-bucket burst size"),
    ("retry", "retry.max_attempts", "int",
     "scheduler.engine", "dispatch attempts before DLQ"),
    ("retry", "retry.backoff_base_seconds", "float",
     "workflow.engine", "workflow step retry backoff base"),
    ("retry", "retry.backoff_multiplier", "float",
     "workflow.engine", "workflow step retry backoff multiplier"),
    ("resources", "resources.default_pool", "str",
     "scheduler.strategy", "pool used when no topic route matches"),
    ("resources", "resources.max_chips", "int",
     "scheduler.strategy", "slice-size ceiling applied to placements"),
    ("resources", "resources.allowed_topologies", "list[str]",
     "scheduler.strategy", "ICI topologies a tenant may occupy (e.g. 2x2x1)"),
    ("models", "models.default_model", "str",
     "worker.handlers", "model id used by model-exec jobs with no explicit model"),
    ("models", "models.allowed_models", "list[str]",
     "safetykernel.kernel", "allowlist for model-exec topics"),
    ("models", "models.dtype", "str",
     "worker.training", "compute dtype for TPU jobs (bfloat16|float32)"),
    ("context", "context.window_tokens", "int",
     "context.service", "BuildWindow token budget default"),
    ("context", "context.history_events", "int",
     "context.service", "CHAT/RAG mode: trailing history events attached"),
    ("context", "context.rag_top_k", "int",
     "context.service", "RAG mode: chunks retrieved per query"),
    ("context", "context.embed_batch", "int",
     "context.service", "TPU embedder batch size (pad-to-batch on MXU)"),
    ("slo", "slo.dispatch_p99_ms", "float",
     "infra.metrics", "alert threshold: dispatch latency p99"),
    ("slo", "slo.e2e_p99_ms", "float",
     "infra.metrics", "alert threshold: submit→result p99"),
    ("observability", "observability.log_format", "str",
     "infra.logging", "text|json"),
    ("observability", "observability.trace_sample_rate", "float",
     "infra.jobstore", "fraction of jobs recorded into trace sets"),
    ("alerting", "alerting.dlq_depth_warn", "int",
     "infra.dlq", "DLQ depth that trips a SystemAlert"),
    ("alerting", "alerting.worker_loss_warn", "int",
     "infra.registry", "expired-worker count that trips a SystemAlert"),
]

_TYPE_TO_SCHEMA = {
    "int": _NONNEG_INT,
    "float": _NONNEG,
    "str": {"type": "string"},
    "list[str]": _STR_LIST,
}


def effective_schema() -> dict[str, Any]:
    """JSON schema for the merged effective config, generated from TAXONOMY.

    Unknown top-level categories are allowed (packs may overlay their own
    namespaces); known categories reject unknown/mistyped fields.
    """
    cats: dict[str, dict] = {}
    for _, path, typ, _, _ in TAXONOMY:
        cat, key = path.split(".", 1)
        c = cats.setdefault(cat, {"type": "object", "properties": {},
                                  "additionalProperties": False})
        c["properties"][key] = _TYPE_TO_SCHEMA[typ]
    return {"type": "object", "properties": cats}


def validate(doc: Any, schema: dict[str, Any], source: str = "config") -> None:
    """Raise :class:`ConfigError` with a pointed path on schema violation."""
    v = jsonschema.Draft202012Validator(schema)
    errors = sorted(v.iter_errors(doc), key=lambda e: list(e.absolute_path))
    if errors:
        e = errors[0]
        where = "/".join(str(p) for p in e.absolute_path) or "<root>"
        more = f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""
        raise ConfigError(f"{source}: {where}: {e.message}{more}")


def taxonomy_markdown() -> str:
    """The taxonomy rendered as the docs/CONFIG.md table."""
    out = [
        "# Effective-config taxonomy",
        "",
        "Generated by `python -m cordum_tpu_torch.infra.configschema` from",
        "`cordum_tpu_torch/infra/configschema.py` (reference analogue:",
        "`core/infra/config/categories.go:6-160`). Fields merge shallowly",
        "system → org → team → workflow → step (`infra/configsvc.py`) and",
        "reach jobs as the `CORDUM_EFFECTIVE_CONFIG` env var.",
        "",
        "| Category | Field | Type | Consumer | Description |",
        "|---|---|---|---|---|",
    ]
    for cat, path, typ, consumer, desc in TAXONOMY:
        out.append(f"| {cat} | `{path}` | `{typ}` | `{consumer}` | {desc} |")
    out.append("")
    return "\n".join(out)


if __name__ == "__main__":
    print(taxonomy_markdown())
