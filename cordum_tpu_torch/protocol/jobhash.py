"""Deterministic job-content hashing for approval binding.

An approval must be bound to the *exact* job content it was granted for;
otherwise a mutated job could ride an old approval.  The hash covers the
canonical JSON of the JobRequest minus mutable approval bookkeeping labels
and the injected effective-config env (reference semantics:
``core/controlplane/scheduler/job_hash.go:16-47``).
"""
from __future__ import annotations

import hashlib
import json

from .types import ENV_EFFECTIVE_CONFIG, JobRequest

# cordum.partition is shard-routing metadata stamped at dispatch time; it
# must not shift the hash an approval was bound to before sharding existed
_EXCLUDED_LABEL_PREFIXES = ("approval_", "cordum.bus_msg_id", "cordum.partition")
_EXCLUDED_ENV_KEYS = (ENV_EFFECTIVE_CONFIG,)


def job_hash(req: JobRequest) -> str:
    d = req.to_dict()
    labels = {
        k: v
        for k, v in (d.get("labels") or {}).items()
        if not any(k.startswith(p) for p in _EXCLUDED_LABEL_PREFIXES)
    }
    env = {k: v for k, v in (d.get("env") or {}).items() if k not in _EXCLUDED_ENV_KEYS}
    d["labels"] = labels
    d["env"] = env
    canonical = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()
