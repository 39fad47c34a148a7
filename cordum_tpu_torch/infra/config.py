"""Static configuration: env vars (:func:`load`), the pools file
(:func:`load_pool_config`) and the timeouts file (:func:`load_timeouts`),
as the reference reads them (``cordum_tpu/infra/config.py``).

A pool stanza carries the slice constraints the scheduler's strategy
checks against worker heartbeats (``requires``, ``min_chips``,
``topology``, ``device_kind``) and the micro-batching and serving limits of
the pool's workers.  The timeouts file is validated against its JSON
schema (:mod:`.configschema`) before it is parsed, as the reference
validates it.  The pools file is parsed with the reference's keys and
casts but not validated against its schema: the worker binary reads it at
boot, where importing ``jsonschema`` costs seconds.  A value that cannot
be cast raises, and the worker binary then warns and boots on its
built-in defaults, as the reference's does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import yaml


@dataclass
class Config:
    # one endpoint, or a comma-separated list of statebus partition
    # endpoints (infra.statebus.connect_partitioned routes by keyspace)
    statebus_url: str = ""
    safety_kernel_addr: str = ""
    pool_config_path: str = ""
    timeout_config_path: str = ""
    safety_policy_path: str = ""
    context_engine_addr: str = ""
    gateway_http_addr: str = "127.0.0.1:8081"
    metrics_addr: str = ""
    api_keys: list[str] = field(default_factory=list)
    log_format: str = ""
    scheduler_shards: int = 1


def load() -> Config:
    env = os.environ
    keys = [k.strip() for k in env.get("CORDUM_API_KEYS", env.get("CORDUM_API_KEY", "")).split(",")
            if k.strip()]
    return Config(
        statebus_url=env.get("CORDUM_STATEBUS_URL", ""),
        safety_kernel_addr=env.get("SAFETY_KERNEL_ADDR", ""),
        pool_config_path=env.get("POOL_CONFIG_PATH", "config/pools.yaml"),
        timeout_config_path=env.get("TIMEOUT_CONFIG_PATH", "config/timeouts.yaml"),
        safety_policy_path=env.get("SAFETY_POLICY_PATH", "config/safety.yaml"),
        context_engine_addr=env.get("CONTEXT_ENGINE_ADDR", ""),
        gateway_http_addr=env.get("GATEWAY_HTTP_ADDR", "127.0.0.1:8081"),
        metrics_addr=env.get("METRICS_ADDR", ""),
        api_keys=keys,
        log_format=env.get("CORDUM_LOG_FORMAT", ""),
        scheduler_shards=max(1, int(env.get("CORDUM_SCHEDULER_SHARDS", "1") or 1)),
    )


@dataclass
class Pool:
    name: str
    requires: list[str] = field(default_factory=list)
    max_parallel_jobs: int = 0  # 0 = worker-reported
    min_chips: int = 0
    topology: str = ""
    device_kind: str = ""
    # micro-batching limits (0 = the worker's built-in defaults)
    max_batch_size: int = 0
    max_batch_wait_ms: float = 0.0
    # serving limits (docs/SERVING.md; 0 = the worker's built-in defaults)
    serving_cache_pages: int = 0
    serving_page_size: int = 0
    serving_max_sessions: int = 0
    serving_max_new_tokens: int = 0
    serving_prefill_budget: int = 0
    serving_role: str = ""  # prefill | decode | mixed ("" = mixed)
    serving_handoff_tokens: int = 0
    serving_prefix_cache: bool = True
    serving_hibernate_after_s: float = 0.0
    serving_speculative: bool = True
    serving_draft_k: int = 0
    # "" (host RAM only) or "statebus" (journaled through the statebus KV)
    serving_cold_tier: str = ""


@dataclass
class PoolConfig:
    topics: dict[str, list[str]] = field(default_factory=dict)  # topic -> pool names
    pools: dict[str, Pool] = field(default_factory=dict)
    scheduler_shards: int = 1
    statebus: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)
    admission: dict = field(default_factory=dict)
    rebalancer: dict = field(default_factory=dict)
    gang: dict = field(default_factory=dict)

    def pools_for_topic(self, topic: str) -> list[Pool]:
        names = self.topics.get(topic)
        if names is None:
            # wildcard topic keys (e.g. "job.gpu.>") match like bus subjects
            from ..utils.globmatch import subject_match

            names = []
            for pattern, pool_names in self.topics.items():
                if subject_match(pattern, topic):
                    names.extend(pool_names)
        return [self.pools[n] for n in names if n in self.pools]


def parse_pool_config(doc: dict) -> PoolConfig:
    """A pools document (``yaml.safe_load`` of the file) as a
    :class:`PoolConfig`; raises on a value that cannot be cast."""
    cfg = PoolConfig()
    for name, p in (doc.get("pools") or {}).items():
        p = p or {}
        cfg.pools[name] = Pool(
            name=name,
            requires=list(p.get("requires") or []),
            max_parallel_jobs=int(p.get("max_parallel_jobs") or 0),
            min_chips=int(p.get("min_chips") or 0),
            topology=str(p.get("topology") or ""),
            device_kind=str(p.get("device_kind") or ""),
            max_batch_size=int(p.get("max_batch_size") or 0),
            max_batch_wait_ms=float(p.get("max_batch_wait_ms") or 0.0),
            serving_cache_pages=int(p.get("serving_cache_pages") or 0),
            serving_page_size=int(p.get("serving_page_size") or 0),
            serving_max_sessions=int(p.get("serving_max_sessions") or 0),
            serving_max_new_tokens=int(p.get("serving_max_new_tokens") or 0),
            serving_prefill_budget=int(p.get("serving_prefill_budget") or 0),
            serving_role=str(p.get("serving_role") or ""),
            serving_handoff_tokens=int(p.get("serving_handoff_tokens") or 0),
            serving_prefix_cache=bool(p.get("serving_prefix_cache", True)),
            serving_speculative=bool(p.get("serving_speculative", True)),
            serving_draft_k=int(p.get("serving_draft_k") or 0),
            serving_cold_tier=str(p.get("serving_cold_tier") or ""),
            serving_hibernate_after_s=float(p.get("serving_hibernate_after_s") or 0.0),
        )
    for topic, pools in (doc.get("topics") or {}).items():
        if isinstance(pools, str):
            pools = [pools]
        cfg.topics[topic] = list(pools or [])
    cfg.scheduler_shards = max(1, int((doc.get("scheduler") or {}).get("shards") or 1))
    cfg.statebus = dict(doc.get("statebus") or {})
    cfg.slo = dict(doc.get("slo") or {})
    cfg.admission = dict(doc.get("admission") or {})
    cfg.rebalancer = dict(doc.get("rebalancer") or {})
    cfg.gang = dict(doc.get("gang") or {})
    return cfg


def load_pool_config(path: str) -> PoolConfig:
    """The pools file at ``path``; a missing file is one default pool with
    the default topic routed to it."""
    if not os.path.exists(path):
        return parse_pool_config({"topics": {"job.default": "default"}, "pools": {"default": {}}})
    with open(path) as f:
        return parse_pool_config(yaml.safe_load(f) or {})


@dataclass
class Timeouts:
    dispatch_timeout_s: float = 300.0
    running_timeout_s: float = 9000.0
    scan_interval_s: float = 30.0
    # how long a job may sit PENDING before the replayer re-drives it.
    # Deliberately much shorter than dispatch_timeout_s: a PENDING job whose
    # submit exhausted its bus redeliveries (tenant-concurrency backpressure
    # on a burst, or its owner shard being down) is safe to replay early —
    # the job lock + in-flight short-circuit make replays idempotent.
    pending_replay_s: float = 15.0
    # how long a job may sit DISPATCHED/RUNNING before the replayer
    # re-delivers it to its dispatch subject.  The worker side is
    # idempotent (in-flight redeliveries dropped, completed jobs republish
    # the cached result), so this is a result-replay request: it recovers
    # dispatches and terminal results lost to a statebus failover window
    # without re-running work.
    result_replay_s: float = 20.0
    per_workflow: dict[str, float] = field(default_factory=dict)
    per_topic: dict[str, float] = field(default_factory=dict)


def parse_timeouts(doc: dict, *, source: str = "timeouts") -> Timeouts:
    from .configschema import TIMEOUTS_SCHEMA, validate

    validate(doc, TIMEOUTS_SCHEMA, source)
    t = Timeouts()
    rec = doc.get("reconciler") or {}
    t.dispatch_timeout_s = float(rec.get("dispatch_timeout_seconds", t.dispatch_timeout_s))
    t.running_timeout_s = float(rec.get("running_timeout_seconds", t.running_timeout_s))
    t.scan_interval_s = float(rec.get("scan_interval_seconds", t.scan_interval_s))
    t.pending_replay_s = float(rec.get("pending_replay_seconds", t.pending_replay_s))
    t.result_replay_s = float(rec.get("result_replay_seconds", t.result_replay_s))
    t.per_workflow = {k: float(v) for k, v in (doc.get("workflows") or {}).items()}
    t.per_topic = {k: float(v) for k, v in (doc.get("topics") or {}).items()}
    return t


def load_timeouts(path: str) -> Timeouts:
    if not os.path.exists(path):
        return Timeouts()
    with open(path) as f:
        return parse_timeouts(yaml.safe_load(f) or {}, source=path)
