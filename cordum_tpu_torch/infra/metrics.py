"""Prometheus-style metrics: counters, gauges, histograms with text
exposition (reference ``core/infra/metrics/metrics.go``).  Dependency-free;
the gateway/scheduler serve ``render()`` at ``/metrics``.

Thread-safety: ``observe()``/``inc()`` run on worker threads (executor
handlers) while ``render()``/``quantile()`` run on the event loop, so every
read takes the same lock the writers take and works on a snapshot — an
unlocked read can see a histogram's bucket list mid-update and report
totals that never existed.

Two additions:

* **Exemplars** — ``Histogram.observe(v, exemplar=trace_id)`` remembers the
  last trace id that landed in each bucket (OpenMetrics-style), rendered as
  ``name_bucket{le="..."} N # {trace_id="..."} value ts`` so a p99 spike in
  ``cordum_job_e2e_seconds`` links straight to an offending trace.  When no
  explicit exemplar is passed, the registered provider (the tracer's active
  span context, wired by ``cordum_tpu_torch.obs``) is consulted.
* **Label-cardinality guard** — a family that sees more than
  ``max_label_sets`` distinct label sets (default 1000, env
  ``CORDUM_METRICS_MAX_LABEL_SETS``) logs once and folds further new sets
  into one ``{overflow="true"}`` series instead of growing unbounded
  (bucket keys derived from job ids would otherwise explode the telemetry
  snapshots).
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Mapping, Optional

from ..utils.ids import now_us

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

DEFAULT_MAX_LABEL_SETS = int(os.environ.get("CORDUM_METRICS_MAX_LABEL_SETS", "1000"))
_OVERFLOW_KEY: tuple[tuple[str, str], ...] = (("overflow", "true"),)

# ambient exemplar source: (trace_id, span_id) of the active span; set by
# cordum_tpu_torch.obs at import so metrics stays importable without the tracer
_exemplar_provider: Optional[Callable[[], tuple[str, str]]] = None
_exemplars_enabled = True


def set_exemplar_provider(fn: Optional[Callable[[], tuple[str, str]]]) -> None:
    global _exemplar_provider
    _exemplar_provider = fn


def set_exemplars_enabled(on: bool) -> None:
    """Global exemplar kill-switch (bench overhead pairs toggle it)."""
    global _exemplars_enabled
    _exemplars_enabled = on


def _log_overflow(name: str, limit: int) -> None:
    from . import logging as logx  # lazy: keep the module import-light

    logx.warn(
        "metric family exceeded its label-set budget; folding new series "
        "into {overflow=\"true\"}",
        metric=name, max_label_sets=limit,
    )


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash first, then
    double-quote and newline (exposition format spec)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def format_exemplar(ex: Optional[tuple[str, float, int]]) -> str:
    """OpenMetrics-style exemplar suffix for one bucket line (`` # {trace_id=
    "..."} value ts``); empty string when the bucket has none."""
    if not ex:
        return ""
    tid, value, ts_us = ex
    return (f' # {{trace_id="{_escape_label_value(tid)}"}} '
            f"{value} {ts_us / 1e6:.3f}")


def _fmt_le(bound: float) -> str:
    """Histogram ``le`` bound as a plain float literal (``repr()`` of an
    int-typed bucket rendered ``1`` vs ``1.0`` and float noise rendered as
    full 17-digit repr; conformance parsers want canonical float text)."""
    f = float(bound)
    if f == int(f):
        return f"{f:.1f}"  # 1.0, 2.0 — the canonical Prometheus spelling
    return f"{f:g}"


class Counter:
    def __init__(self, name: str, help_: str = "",
                 max_label_sets: int = 0) -> None:
        self.name = name
        self.help = help_
        self.max_label_sets = max_label_sets or DEFAULT_MAX_LABEL_SETS
        self._overflowed = False
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _guard_key(
        self, key: tuple[tuple[str, str], ...],
        existing: Mapping[tuple[tuple[str, str], ...], object],
    ) -> tuple[tuple[str, str], ...]:
        """Cardinality guard (call under ``_lock``): a NEW label set beyond
        the family budget folds into the ``{overflow="true"}`` series."""
        if key in existing or len(existing) < self.max_label_sets:
            return key
        if not self._overflowed:
            self._overflowed = True
            _log_overflow(self.name, self.max_label_sets)
        return _OVERFLOW_KEY

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            key = self._guard_key(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination (bench: round-trips per job)."""
        with self._lock:
            return sum(self._values.values())

    def _snapshot(self) -> list[tuple[tuple[tuple[str, str], ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        items = self._snapshot()
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        if not items:
            out.append(f"{self.name} 0")
        return out


class Gauge(Counter):
    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            key = self._guard_key(key, self._values)
            self._values[key] = value

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, v in self._snapshot():
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS,
                 max_label_sets: int = 0) -> None:
        self.name = name
        self.help = help_
        self.buckets = buckets
        self.max_label_sets = max_label_sets or DEFAULT_MAX_LABEL_SETS
        self._overflowed = False
        self._counts: dict[tuple[tuple[str, str], ...], list[int]] = {}
        self._sums: dict[tuple[tuple[str, str], ...], float] = {}
        self._totals: dict[tuple[tuple[str, str], ...], int] = {}
        # per-series exemplars: bucket index (len(buckets) = +Inf) → the last
        # (trace_id, value, ts_us) observation that landed in that bucket
        self._exemplars: dict[
            tuple[tuple[str, str], ...], dict[int, tuple[str, float, int]]
        ] = {}
        self._lock = threading.Lock()

    def _guard_key(
        self, key: tuple[tuple[str, str], ...]
    ) -> tuple[tuple[str, str], ...]:
        if key in self._totals or len(self._totals) < self.max_label_sets:
            return key
        if not self._overflowed:
            self._overflowed = True
            _log_overflow(self.name, self.max_label_sets)
        return _OVERFLOW_KEY

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        if exemplar is None and _exemplars_enabled and _exemplar_provider is not None:
            try:
                exemplar = _exemplar_provider()[0]
            except Exception:  # noqa: BLE001 - exemplars must never fail the observe
                exemplar = ""
        with self._lock:
            key = self._guard_key(key)
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = len(self.buckets)  # +Inf
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    if i < idx:
                        idx = i
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar and _exemplars_enabled:
                self._exemplars.setdefault(key, {})[idx] = (
                    str(exemplar), value, now_us()
                )

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Approximate quantile from bucket boundaries (observability only)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            total = self._totals.get(key, 0)
            if not total:
                return None
            counts = list(self._counts[key])
        target = q * total
        for i, c in enumerate(counts):
            if c >= target:
                return self.buckets[i]
        return self.buckets[-1]

    def _snapshot(self) -> list[tuple[tuple[tuple[str, str], ...], list[int], float, int]]:
        with self._lock:
            return [
                (key, list(self._counts[key]), self._sums[key], self._totals[key])
                for key in sorted(self._totals)
            ]

    def exemplar_snapshot(
        self,
    ) -> dict[tuple[tuple[str, str], ...], dict[int, tuple[str, float, int]]]:
        """Per-series exemplar map snapshot (bucket index → (trace_id,
        value, ts_us)) — the telemetry exporter ships it fleet-ward."""
        with self._lock:
            return {k: dict(v) for k, v in self._exemplars.items()}

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        snap = self._snapshot()
        exs = self.exemplar_snapshot()
        for key, counts, sum_, total in snap:
            labels = dict(key)
            series_ex = exs.get(key) or {}
            for i, b in enumerate(self.buckets):
                bl = dict(labels)
                bl["le"] = _fmt_le(b)
                out.append(
                    f"{self.name}_bucket{_fmt_labels(bl)} {counts[i]}"
                    + format_exemplar(series_ex.get(i))
                )
            bl = dict(labels)
            bl["le"] = "+Inf"
            out.append(
                f"{self.name}_bucket{_fmt_labels(bl)} {total}"
                + format_exemplar(series_ex.get(len(self.buckets)))
            )
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {sum_}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {total}")
        return out


class Metrics:
    """Shared metric families for the whole control plane."""

    def __init__(self) -> None:
        self.jobs_received = Counter("cordum_jobs_received_total", "Jobs received by scheduler")
        self.jobs_dispatched = Counter("cordum_jobs_dispatched_total", "Jobs dispatched")
        self.jobs_completed = Counter("cordum_jobs_completed_total", "Jobs reaching terminal state")
        self.jobs_denied = Counter("cordum_jobs_safety_denied_total", "Jobs denied by safety kernel")
        self.jobs_dlq = Counter("cordum_jobs_dlq_total", "Jobs dead-lettered")
        self.http_requests = Counter("cordum_http_requests_total", "Gateway HTTP requests")
        self.http_latency = Histogram("cordum_http_request_seconds", "Gateway HTTP latency")
        self.dispatch_latency = Histogram(
            "cordum_dispatch_seconds", "submit->dispatch latency"
        )
        self.e2e_latency = Histogram("cordum_job_e2e_seconds", "submit->result latency")
        self.stage_seconds = Histogram(
            "cordum_stage_seconds",
            "Per-stage pipeline latency from flight-recorder spans",
        )
        self.spans_collected = Counter(
            "cordum_spans_collected_total", "Spans persisted by the collector"
        )
        self.policy_evals = Counter("cordum_policy_evals_total", "Safety kernel evaluations")
        self.workflow_steps = Counter("cordum_workflow_steps_total", "Workflow steps dispatched")
        # agentic workflow plane (docs/WORKFLOWS.md): run starts/terminals
        # (status=STARTED|SUCCEEDED|FAILED|CANCELLED), per-step wall-clock
        # latency (dispatch → terminal result, run trace as exemplar), live
        # non-terminal runs (set by the reconciler's status-index sweep),
        # and the reconciler pass cost itself
        self.workflow_runs = Counter(
            "cordum_workflow_runs_total", "Workflow runs started / finished by status"
        )
        self.workflow_step_seconds = Histogram(
            "cordum_workflow_step_seconds",
            "Workflow step latency: dispatch to terminal result",
            buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
        )
        self.workflow_active_runs = Gauge(
            "cordum_workflow_active_runs", "Runs in a non-terminal status"
        )
        self.workflow_reconcile_seconds = Histogram(
            "cordum_workflow_reconcile_seconds",
            "Workflow reconciler pass duration",
        )
        self.workers_live = Gauge("cordum_workers_live", "Live workers in registry")
        self.tpu_duty_cycle = Gauge("cordum_tpu_duty_cycle", "Reported TPU duty cycle per worker")
        # micro-batching (cordum_tpu_torch/batching): rows-per-flush distribution,
        # live queued rows per (op, bucket), flush count
        self.batch_size = Histogram(
            "cordum_batch_size",
            "Rows per flushed micro-batch",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
        )
        self.batch_queue_depth = Gauge(
            "cordum_batch_queue_depth", "Rows waiting in micro-batch queues"
        )
        self.batch_flushes = Counter(
            "cordum_batch_flushes_total", "Micro-batch flushes executed"
        )
        # KV pipelining (infra/kv.py): every public KV op is one round trip
        # (one TCP request under StateBusKV, one lock acquisition under
        # MemoryKV); pipelined commits batch N mutations into one `pipe` op
        self.kv_roundtrips = Counter(
            "cordum_kv_roundtrips_total",
            "KV operations issued (each is one round-trip under StateBusKV)",
        )
        self.kv_pipeline_size = Histogram(
            "cordum_kv_pipeline_size",
            "Ops folded into each pipelined KV commit",
            buckets=(1.0, 2.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0),
        )
        self.statebus_op_seconds = Histogram(
            "cordum_statebus_op_seconds",
            "Server-side statebus per-op execution latency",
        )
        # control-plane sharding: per-shard ownership throughput,
        # cross-shard forwarding, submit backlog, and the per-connection
        # write-coalescing batch sizes on the statebus wire
        self.shard_scheduled = Counter(
            "cordum_shard_scheduled_total",
            "Jobs scheduled, labeled by owning scheduler shard",
        )
        self.shard_forwarded = Counter(
            "cordum_shard_forwarded_total",
            "Unstamped messages forwarded to the owning shard's partition subject",
        )
        self.shard_queue_depth = Gauge(
            "cordum_shard_partition_queue_depth",
            "Submits in flight (queued + processing) on this shard",
        )
        self.statebus_coalesced_batch = Histogram(
            "cordum_statebus_coalesced_batch",
            "Wire frames folded into one coalesced statebus socket write",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
        )
        # statebus replication + failover (infra/replication.py):
        # primary-side lag per replica, stream volume, attach modes, sync-ack
        # degradations, promotions; client-side reconnect/failover causes
        self.statebus_repl_lag_ops = Gauge(
            "cordum_statebus_replication_lag_ops",
            "Committed records the labeled replica has not acked yet",
        )
        self.statebus_repl_lag_bytes = Gauge(
            "cordum_statebus_replication_lag_bytes",
            "Replication stream bytes the labeled replica has not acked yet",
        )
        self.statebus_repl_records = Counter(
            "cordum_statebus_repl_records_total",
            "Record frames shipped to replicas",
        )
        self.statebus_repl_syncs = Counter(
            "cordum_statebus_repl_syncs_total",
            "Replica attach handshakes, by catch-up mode "
            "(incremental backlog replay vs full snapshot re-seed)",
        )
        self.statebus_sync_ack_timeouts = Counter(
            "cordum_statebus_sync_ack_timeouts_total",
            "Sync-mode commits that degraded to async because no replica "
            "acked within the sync timeout",
        )
        self.statebus_promotions = Counter(
            "cordum_statebus_promotions_total",
            "Replica promotions to primary, by trigger "
            "(admin | primary-dead | primary-goaway)",
        )
        self.statebus_reconnects = Counter(
            "cordum_statebus_reconnects_total",
            "Client reconnect/failover completions, by loss reason "
            "(connection_lost | goaway | ping_timeout)",
        )
        self.inflight_nudges = Counter(
            "cordum_sched_inflight_nudges_total",
            "DISPATCHED/RUNNING jobs re-delivered to their worker to "
            "recover dispatches/results lost to a statebus failover window",
        )
        # scheduler tick batching: submits drained per scheduler
        # loop tick into one selection pass + grouped pipelined commits
        self.sched_tick_batch = Histogram(
            "cordum_sched_tick_batch_size",
            "Submits coalesced into one scheduler tick batch",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
        )
        self.sched_tick_fallbacks = Counter(
            "cordum_sched_tick_fallback_total",
            "Batched submits diverted to the per-job slow path (conflict, "
            "duplicate-in-tick, or non-ALLOW decision)",
        )
        # serving subsystem (cordum_tpu_torch/serving): continuous-batching decode
        self.serving_batch_occupancy = Histogram(
            "cordum_serving_batch_occupancy",
            "Sessions riding one continuous-batching decode step",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
        )
        self.serving_inter_token = Histogram(
            "cordum_serving_inter_token_seconds",
            "Wall time per decode step (inter-token latency)",
        )
        self.serving_admitted = Counter(
            "cordum_serving_sessions_admitted_total",
            "Sessions admitted into the decode loop",
        )
        self.serving_retired = Counter(
            "cordum_serving_sessions_retired_total",
            "Sessions retired from the decode loop, by reason",
        )
        self.serving_sessions = Gauge(
            "cordum_serving_active_sessions",
            "Sessions currently in the decode set",
        )
        self.serving_kv_pages_in_use = Gauge(
            "cordum_serving_kv_pages_in_use",
            "KV cache pages currently allocated to sessions",
        )
        self.serving_compiles = Counter(
            "cordum_serving_compile_total",
            "XLA programs compiled by the serving backend, by entry point "
            "(the ragged mixed prefill+decode entry compiles exactly once "
            "per process — a higher count is the bucket-recompile cliff "
            "coming back)",
        )
        self.session_affinity = Counter(
            "cordum_session_affinity_total",
            "Session-keyed routing outcomes (hit = routed to the worker "
            "holding the session's KV pages; evicted = the entry was "
            "invalidated because its worker deregistered, drained, or "
            "missed heartbeats)",
        )
        # serving session failover (docs/SERVING.md §Migration, drain, and
        # failover): live KV-page migration between workers + scheduler-side
        # session re-dispatch after worker death or a requeue request
        self.serving_migrations = Counter(
            "cordum_serving_migrations_total",
            "Live KV-page session migrations, by role (out = this worker "
            "shipped the session; in = adopted it) and outcome",
        )
        self.serving_migration_pause = Histogram(
            "cordum_serving_migration_pause_seconds",
            "Decode pause per migration (freeze -> target commit): only the "
            "final freeze-and-delta chunk stops the session's tokens",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5),
        )
        # prefill/decode disaggregation (docs/SERVING.md §Disaggregation):
        # why migrations fail, post-prefill hand-off outcomes, and the
        # decode rebalancer's command/move accounting
        self.serving_migration_failures = Counter(
            "cordum_serving_migration_failures_total",
            "Failed session migrations by reason (refused | timeout | io | "
            "session_gone | no_session | unknown)",
        )
        self.serving_handoffs = Counter(
            "cordum_serving_handoffs_total",
            "Post-prefill session hand-offs to a decode worker, by outcome "
            "(ok = moved on the first target; retried_ok = the jittered "
            "next-best retry landed it; no_peer = decode continued locally; "
            "failed = every target refused, decode continued locally)",
        )
        self.serving_rebalances = Counter(
            "cordum_serving_rebalance_total",
            "Decode-rebalancer activity by stage (commanded = the governor "
            "asked a hot worker to shed; moved = a session migrated toward "
            "headroom; failed = the move failed and decode continued on the "
            "hot worker; no_sessions = nothing movable, e.g. every "
            "candidate was cooldown-immune)",
        )
        # prefix cache + session tiering (docs/SERVING.md §Prefix cache and
        # tiering): shared-prefix admission outcomes, pages the
        # radix cache retains, CoW activity, and the hibernate/restore flow
        # that tiers idle resident sessions to the host-RAM cold arena
        self.serving_prefix = Counter(
            "cordum_serving_prefix_total",
            "Prefix-cache admission outcomes (hit = the session's prompt "
            "matched cached full pages and skipped their prefill; miss = "
            "admitted cold)",
        )
        self.serving_prefix_tokens = Counter(
            "cordum_serving_prefix_tokens_total",
            "Prompt tokens whose prefill was skipped via shared-prefix "
            "KV pages",
        )
        self.serving_prefix_pages = Gauge(
            "cordum_serving_prefix_cached_pages",
            "Physical arena pages currently retained (warm) by the prefix "
            "cache",
        )
        self.serving_prefix_evictions = Counter(
            "cordum_serving_prefix_evictions_total",
            "Cached-prefix pages dropped, by reason (capacity = LRU-evicted "
            "under admission exhaustion; stale = replaced by a fresher "
            "registration)",
        )
        self.serving_cow_copies = Counter(
            "cordum_serving_cow_copies_total",
            "Copy-on-write page duplications (a session wrote into a page "
            "another table still maps)",
        )
        self.serving_hibernate = Counter(
            "cordum_serving_hibernate_total",
            "Session-tiering transitions, by event (hibernated = pages "
            "exported to the cold arena and released; restored = pages "
            "re-imported on the next turn; dropped = cold state discarded)",
        )
        self.serving_hibernate_pause = Histogram(
            "cordum_serving_hibernate_pause_seconds",
            "Wall time a turn waits on a cold-arena restore (page alloc + "
            "scatter) before its prefill can start",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5),
        )
        self.serving_resident_sessions = Gauge(
            "cordum_serving_resident_sessions",
            "Conversations with restorable KV state on this worker, by tier "
            "(warm = pages resident in the device arena; cold = records in "
            "the host-RAM cold arena)",
        )
        # speculative decoding (docs/SERVING.md §Speculative decoding):
        # the self-drafted verify loop inside the ragged step —
        # tokens proposed, tokens the model verified, and rejected drafts
        # whose write positions were rolled back
        self.serving_spec_drafted = Counter(
            "cordum_serving_spec_drafted_total",
            "Speculative tokens proposed into draft verification rows",
        )
        self.serving_spec_accepted = Counter(
            "cordum_serving_spec_accepted_total",
            "Drafted tokens the ragged step verified and kept (the bonus "
            "token each verified row also samples is not counted here)",
        )
        self.serving_spec_rolled_back = Counter(
            "cordum_serving_spec_rolled_back_total",
            "Drafted tokens rejected by verification — their page write "
            "positions rolled back so the KV arena never serves them",
        )
        self.session_failovers = Counter(
            "cordum_sched_session_failovers_total",
            "In-flight jobs re-dispatched to a new worker, by reason "
            "(worker_dead | requeue_requested)",
        )
        # fleet telemetry plane (cordum_tpu_torch/obs): retention-cap
        # drops made observable, per-class SLO measurement, exporter flow,
        # and the runtime profiler's loop/GC health
        self.spans_dropped = Counter(
            "cordum_spans_dropped_total",
            "Spans dropped by the collector's retention caps, by reason "
            "(per_trace_cap | trace_evicted | trace_purged)",
        )
        self.telemetry_snapshots = Counter(
            "cordum_telemetry_snapshots_total",
            "Telemetry snapshots published by this process's exporter",
        )
        self.telemetry_dropped = Counter(
            "cordum_telemetry_snapshots_dropped_total",
            "Telemetry snapshots lost, by reason (publish_error | "
            "decode_error | instance_evicted)",
        )
        self.jobs_by_class = Counter(
            "cordum_jobs_completed_by_class_total",
            "Terminal jobs by SLO job class (JobRequest.priority) and status",
        )
        # overload resilience (docs/ADMISSION.md): gateway load shedding,
        # per-(op, class) admission headroom, the brownout ladder tier, and
        # scheduler-side batch preemption under interactive SLO pressure
        self.gateway_shed = Counter(
            "cordum_gateway_shed_total",
            "Submissions rejected 429 by the gateway, by reason "
            "(rate_limit | tenant_quota | capacity | capacity_interactive | "
            "queue_depth | brownout_*) and job class",
        )
        self.admission_headroom = Gauge(
            "cordum_admission_headroom",
            "Measured capacity minus EWMA offered rate per (op, job_class) "
            "— negative means the class is being shed analytically",
        )
        self.admission_tier = Gauge(
            "cordum_admission_brownout_tier",
            "Admission brownout ladder tier (0 = normal, 1 = shed batch, "
            "2 = also shed best-effort ops, 3 = bounded-queue interactive)",
        )
        self.preemptions = Counter(
            "cordum_preemptions_total",
            "Batch-job preemptions under interactive SLO pressure, by stage "
            "(requested = governor asked a worker; requeued = the worker "
            "handed the job back; redispatched = the job was re-dispatched "
            "attempts-exempt after the hold-off)",
        )
        # gang scheduling (docs/GANG.md): mesh-aware all-or-nothing
        # placement of multi-chip SPMD/MPMD jobs
        self.gang_admissions = Counter(
            "cordum_gang_admissions_total",
            "Gang admission outcomes (reserved = all members reserved "
            "at once; queued = parked in the exhaustion FIFO)",
        )
        self.gang_completed = Counter(
            "cordum_gang_completed_total",
            "Gangs that finished, by status (succeeded | failed)",
        )
        self.gang_aborts = Counter(
            "cordum_gang_aborts_total",
            "Whole-gang aborts, by reason (member_failed | worker_dead | "
            "rendezvous_timeout | preempted | cancelled | ...)",
        )
        self.gang_partial_reservations = Counter(
            "cordum_gang_partial_reservations_total",
            "Ledger invariant violations: a gang observed holding fewer "
            "devices than its full reservation (MUST stay 0 — all-or-"
            "nothing admission is the design contract)",
        )
        self.gang_queue_depth = Gauge(
            "cordum_gang_queue_depth",
            "Gangs waiting in the exhaustion FIFO for devices to free",
        )
        self.gang_reserved_workers = Gauge(
            "cordum_gang_reserved_workers",
            "Workers currently reserved by running gangs",
        )
        self.gang_size = Histogram(
            "cordum_gang_size",
            "Members per dispatched gang",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
        )
        self.gang_rendezvous_seconds = Histogram(
            "cordum_gang_rendezvous_seconds",
            "Worker-side wait from member dispatch to barrier passage",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
        # sharded serving gangs (docs/SERVING.md §Sharded serving): one
        # session set running tensor-parallel over a gang of workers
        self.serving_gang_steps = Counter(
            "cordum_serving_gang_steps_total",
            "Ragged steps on serving-gang members, by role (lead = rank "
            "0's sampled step + broadcast; replay = a follower replaying "
            "the broadcast batch against its head shard)",
        )
        self.serving_gang_members = Gauge(
            "cordum_serving_gang_members",
            "Members of the serving gang this worker currently belongs "
            "to (0 = not serving in a gang), labeled by gang id",
        )
        self.serving_gang_stream_tokens = Counter(
            "cordum_serving_gang_stream_tokens_total",
            "Tokens streamed to clients by serving-gang rank 0 — the ONLY "
            "rank that may publish stream packets (rank-0 ownership rule)",
        )
        self.slo_burn_rate = Gauge(
            "cordum_slo_burn_rate",
            "SLO error-budget burn rate per objective and window "
            "(1.0 = burning exactly the budget)",
        )
        self.eventloop_lag = Histogram(
            "cordum_eventloop_lag_seconds",
            "Event-loop scheduling lag sampled by the runtime profiler",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
        )
        self.slow_ticks = Counter(
            "cordum_slow_ticks_total",
            "Profiler ticks whose event-loop lag exceeded the slow-tick "
            "threshold (each dumps the running task stacks to the log)",
        )
        self.gc_pauses = Counter(
            "cordum_gc_pauses_total", "GC collections observed, by generation"
        )
        self.gc_pause_seconds = Histogram(
            "cordum_gc_pause_seconds",
            "Stop-the-world GC pause durations",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25),
        )
        self._families = [
            self.jobs_received,
            self.jobs_dispatched,
            self.jobs_completed,
            self.jobs_denied,
            self.jobs_dlq,
            self.http_requests,
            self.http_latency,
            self.dispatch_latency,
            self.e2e_latency,
            self.stage_seconds,
            self.spans_collected,
            self.policy_evals,
            self.workflow_steps,
            self.workflow_runs,
            self.workflow_step_seconds,
            self.workflow_active_runs,
            self.workflow_reconcile_seconds,
            self.workers_live,
            self.tpu_duty_cycle,
            self.batch_size,
            self.batch_queue_depth,
            self.batch_flushes,
            self.kv_roundtrips,
            self.kv_pipeline_size,
            self.statebus_op_seconds,
            self.shard_scheduled,
            self.shard_forwarded,
            self.shard_queue_depth,
            self.statebus_coalesced_batch,
            self.statebus_repl_lag_ops,
            self.statebus_repl_lag_bytes,
            self.statebus_repl_records,
            self.statebus_repl_syncs,
            self.statebus_sync_ack_timeouts,
            self.statebus_promotions,
            self.statebus_reconnects,
            self.inflight_nudges,
            self.sched_tick_batch,
            self.sched_tick_fallbacks,
            self.serving_batch_occupancy,
            self.serving_inter_token,
            self.serving_admitted,
            self.serving_retired,
            self.serving_sessions,
            self.serving_kv_pages_in_use,
            self.serving_compiles,
            self.session_affinity,
            self.serving_migrations,
            self.serving_migration_pause,
            self.serving_prefix,
            self.serving_prefix_tokens,
            self.serving_prefix_pages,
            self.serving_prefix_evictions,
            self.serving_cow_copies,
            self.serving_hibernate,
            self.serving_hibernate_pause,
            self.serving_resident_sessions,
            self.serving_spec_drafted,
            self.serving_spec_accepted,
            self.serving_spec_rolled_back,
            self.session_failovers,
            self.spans_dropped,
            self.telemetry_snapshots,
            self.telemetry_dropped,
            self.jobs_by_class,
            self.gateway_shed,
            self.admission_headroom,
            self.admission_tier,
            self.preemptions,
            self.gang_admissions,
            self.gang_completed,
            self.gang_aborts,
            self.gang_partial_reservations,
            self.gang_queue_depth,
            self.gang_reserved_workers,
            self.gang_size,
            self.gang_rendezvous_seconds,
            self.slo_burn_rate,
            self.eventloop_lag,
            self.slow_ticks,
            self.gc_pauses,
            self.gc_pause_seconds,
        ]

    def render(self) -> str:
        lines: list[str] = []
        for fam in self._families:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """The whole registry in the compact fleet-telemetry snapshot format
        (msgpack-friendly plain lists/dicts; docs/OBSERVABILITY.md §Fleet
        telemetry)::

            {"counters":   {name: [[{label: value}, value], ...]},
             "gauges":     {name: [[{label: value}, value], ...]},
             "histograms": {name: {"buckets": [...],
                                   "series": [[{..}, [counts], sum, total]]}}}

        Gauges are separated from counters because they merge differently
        across the fleet (counters sum; gauges keep their instance).
        """
        counters: dict[str, list] = {}
        gauges: dict[str, list] = {}
        hists: dict[str, dict] = {}
        for fam in self._families:
            if isinstance(fam, Histogram):
                hists[fam.name] = {
                    "buckets": list(fam.buckets),
                    "series": [
                        [dict(key), counts, sum_, total]
                        for key, counts, sum_, total in fam._snapshot()
                    ],
                }
                exs = fam.exemplar_snapshot()
                if exs:
                    # str bucket indices: msgpack/JSON-safe either way
                    hists[fam.name]["exemplars"] = [
                        [dict(key), {str(i): list(ex) for i, ex in m.items()}]
                        for key, m in exs.items()
                    ]
            elif isinstance(fam, Gauge):
                gauges[fam.name] = [[dict(k), v] for k, v in fam._snapshot()]
            else:
                counters[fam.name] = [[dict(k), v] for k, v in fam._snapshot()]
        return {"counters": counters, "gauges": gauges, "histograms": hists}
