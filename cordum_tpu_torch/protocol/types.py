"""Wire contract for the TPU control plane (CAP-v2-equivalent).

The reference control plane speaks protobuf ``BusPacket`` envelopes from the
external CAP module (see reference ``core/protocol/pb/v1/pb.go:1-78`` and
``docs/AGENT_PROTOCOL.md`` "Wire Contracts").  We re-design the same contract
as msgpack-serialized dataclasses: a ``BusPacket`` envelope with a tagged
payload union of ``JobRequest / JobResult / Heartbeat / JobProgress /
JobCancel / SystemAlert``, plus the safety-kernel ``PolicyCheck*`` pair.

TPU-first deltas from the reference contract:
  * ``Heartbeat`` reports TPU slice telemetry (``device_kind``, ``chip_count``,
    ``slice_topology``, ``tpu_duty_cycle``, ``hbm_used_gb/hbm_total_gb``)
    instead of ``gpu_utilization`` (reference Heartbeat fields documented in
    ``docs/AGENT_PROTOCOL.md``).
  * ``JobMetadata.requires`` can carry TPU constraints (``tpu``, ``chips:8``,
    ``topology:2x2x2``) consumed by the slice-aware scheduler strategy.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional, TypeVar

_W = TypeVar("_W", bound="WireModel")

from ..infra import codec
from ..utils.ids import new_id, now_us

PROTOCOL_VERSION = 1


class JobState(str, enum.Enum):
    """Job lifecycle states (reference ``core/controlplane/scheduler`` states,
    transition table at ``core/infra/memory/job_store.go:71-92``)."""

    PENDING = "PENDING"
    APPROVAL_REQUIRED = "APPROVAL_REQUIRED"
    SCHEDULED = "SCHEDULED"
    DISPATCHED = "DISPATCHED"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    TIMEOUT = "TIMEOUT"
    DENIED = "DENIED"


TERMINAL_STATES = frozenset(
    {
        JobState.SUCCEEDED,
        JobState.FAILED,
        JobState.CANCELLED,
        JobState.TIMEOUT,
        JobState.DENIED,
    }
)

# Legal state transitions; "" is the no-state-yet origin.
# Mirrors reference job_store.go:71-92 semantics (not code).
ALLOWED_TRANSITIONS: dict[str, frozenset[JobState]] = {
    "": frozenset(
        {
            JobState.PENDING,
            JobState.APPROVAL_REQUIRED,
            JobState.SCHEDULED,
            JobState.DISPATCHED,
            JobState.RUNNING,
            JobState.FAILED,
        }
    ),
    JobState.PENDING: frozenset(
        {
            JobState.APPROVAL_REQUIRED,
            JobState.SCHEDULED,
            JobState.DISPATCHED,
            JobState.RUNNING,
            JobState.DENIED,
            JobState.FAILED,
            JobState.TIMEOUT,
            JobState.CANCELLED,
        }
    ),
    JobState.APPROVAL_REQUIRED: frozenset(
        {
            JobState.PENDING,
            JobState.SCHEDULED,
            JobState.DISPATCHED,
            JobState.RUNNING,
            JobState.DENIED,
            JobState.FAILED,
            JobState.TIMEOUT,
            JobState.CANCELLED,
        }
    ),
    JobState.SCHEDULED: frozenset(
        {
            JobState.DISPATCHED,
            JobState.RUNNING,
            JobState.DENIED,
            JobState.FAILED,
            JobState.TIMEOUT,
            JobState.SUCCEEDED,
            JobState.CANCELLED,
        }
    ),
    JobState.DISPATCHED: frozenset(
        {
            JobState.RUNNING,
            JobState.SUCCEEDED,
            JobState.FAILED,
            JobState.CANCELLED,
            JobState.TIMEOUT,
        }
    ),
    JobState.RUNNING: frozenset(
        {
            JobState.SUCCEEDED,
            JobState.FAILED,
            JobState.CANCELLED,
            JobState.TIMEOUT,
        }
    ),
    JobState.SUCCEEDED: frozenset(),
    JobState.FAILED: frozenset(),
    JobState.CANCELLED: frozenset(),
    JobState.TIMEOUT: frozenset(),
    JobState.DENIED: frozenset(),
}


def is_allowed_transition(prev: str | JobState, nxt: JobState) -> bool:
    key = prev if prev in ALLOWED_TRANSITIONS else ""
    if prev and prev not in ALLOWED_TRANSITIONS:
        return False
    return nxt in ALLOWED_TRANSITIONS[key]


class Priority(str, enum.Enum):
    INTERACTIVE = "INTERACTIVE"
    BATCH = "BATCH"
    CRITICAL = "CRITICAL"


class Decision(str, enum.Enum):
    """Safety-kernel decisions (reference safety_policy.go decision kinds)."""

    ALLOW = "ALLOW"
    DENY = "DENY"
    REQUIRE_APPROVAL = "REQUIRE_APPROVAL"
    ALLOW_WITH_CONSTRAINTS = "ALLOW_WITH_CONSTRAINTS"
    THROTTLE = "THROTTLE"


# ---------------------------------------------------------------------------
# serde helpers
# ---------------------------------------------------------------------------


_FIELD_CACHE: dict[type, tuple[str, ...]] = {}


def _field_names(cls: type) -> tuple[str, ...]:
    names = _FIELD_CACHE.get(cls)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(cls))
        _FIELD_CACHE[cls] = names
    return names


def _to_plain(v: Any) -> Any:
    # fast paths first: the wire hot loop is dominated by str/int/dict
    t = type(v)
    if t is str or t is int or t is float or t is bool or t is bytes or v is None:
        return v
    if t is dict:
        return {k: _to_plain(x) for k, x in v.items()}
    if t is list or t is tuple:
        return [_to_plain(x) for x in v]
    if dataclasses.is_dataclass(v):
        out = {}
        for name in _field_names(t):
            val = getattr(v, name)
            if val is not None:
                out[name] = _to_plain(val)
        return out
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, dict):
        return {k: _to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_plain(x) for x in v]
    return v


class WireModel:
    """Mixin: dict/msgpack serialization with unknown-field tolerance."""

    def to_dict(self) -> dict[str, Any]:
        return _to_plain(self)

    @classmethod
    def from_dict(cls: type[_W], d: dict[str, Any] | None) -> Optional[_W]:
        if d is None:
            return None
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):  # type: ignore[arg-type]
            if f.name not in d or d[f.name] is None:
                continue
            v = d[f.name]
            conv = _NESTED.get((cls, f.name))
            if conv is not None:
                v = conv(v)
            kwargs[f.name] = v
        return cls(**kwargs)  # type: ignore[call-arg]

    def to_wire(self) -> bytes:
        return codec.packb(self.to_dict())

    @classmethod
    def from_wire(cls: type[_W], b: bytes) -> Optional[_W]:
        return cls.from_dict(codec.unpackb(b))


# ---------------------------------------------------------------------------
# payload types
# ---------------------------------------------------------------------------


@dataclass
class ContextHints(WireModel):
    # max_output_tokens was pruned (CL010): encoded on every packet, never
    # read anywhere — ``from_dict`` ignores unknown keys so old peers that
    # still send it decode fine
    max_input_tokens: int = 0
    mode: str = ""  # RAW | CHAT | RAG


@dataclass
class Budget(WireModel):
    max_tokens: int = 0
    max_cost_usd: float = 0.0
    # set by external submitters (gateway JSON → from_dict); nothing
    # in-tree constructs it, but the deadline sweeper reads it
    deadline_unix_ms: int = 0  # cordum: wire-compat -- populated by submitter SDKs


@dataclass
class JobMetadata(WireModel):
    """Policy/routing metadata (reference JobMetadata: capability, risk_tags,
    requires, pack_id — docs/AGENT_PROTOCOL.md "Safety & Tenancy")."""

    capability: str = ""
    risk_tags: list[str] = field(default_factory=list)
    requires: list[str] = field(default_factory=list)
    pack_id: str = ""


@dataclass
class JobRequest(WireModel):
    job_id: str = ""
    topic: str = ""
    priority: str = Priority.BATCH.value
    context_ptr: str = ""
    memory_id: str = ""
    tenant_id: str = ""
    principal_id: str = ""
    adapter_id: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    env: dict[str, str] = field(default_factory=dict)
    # parent_job_id was pruned (CL010): workflow lineage rides
    # workflow_id/run_id; nothing ever read the field.  Old peers that
    # still send it decode fine (from_dict ignores unknown keys).
    workflow_id: str = ""
    run_id: str = ""
    metadata: Optional[JobMetadata] = None
    context_hints: Optional[ContextHints] = None
    budget: Optional[Budget] = None


@dataclass
class JobResult(WireModel):
    job_id: str = ""
    status: str = JobState.SUCCEEDED.value
    result_ptr: str = ""
    worker_id: str = ""
    execution_ms: int = 0
    error_code: str = ""
    error_message: str = ""
    labels: dict[str, str] = field(default_factory=dict)


@dataclass
class Heartbeat(WireModel):
    """Worker heartbeat with TPU slice telemetry.

    Reference Heartbeat carries worker_id/region/type/cpu_load/gpu_utilization/
    active_jobs/capabilities/pool/max_parallel_jobs; the TPU-native shape keeps
    the scheduler-visible fields and replaces GPU telemetry with TPU slice
    health (SURVEY.md §5 "failure detection": add TPU-slice health).
    """

    worker_id: str = ""
    region: str = ""
    type: str = "tpu"
    cpu_load: float = 0.0
    tpu_duty_cycle: float = 0.0  # 0-100, MXU busy fraction
    hbm_used_gb: float = 0.0
    hbm_total_gb: float = 0.0
    active_jobs: int = 0
    max_parallel_jobs: int = 1
    capabilities: list[str] = field(default_factory=list)
    pool: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    device_kind: str = ""  # e.g. "TPU v5p"
    chip_count: int = 0
    slice_topology: str = ""  # e.g. "2x2x1"
    devices_healthy: bool = True
    # graceful drain (docs/SERVING.md): a draining worker is finishing or
    # migrating its work and must receive NO new placements — the scheduler
    # deregisters it and evicts its session/batch affinity entries on sight
    draining: bool = False


@dataclass
class JobProgress(WireModel):
    job_id: str = ""
    percent: float = 0.0
    message: str = ""
    result_ptr: str = ""
    # artifact_ptrs was pruned (CL010): artifacts ride JobResult, the
    # progress-side list was encoded but never read
    status_hint: str = ""
    worker_id: str = ""
    # llm.generate token stream: the tokens emitted since the last progress
    # packet, with status_hint=STATUS_HINT_STREAM (docs/SERVING.md).  Stream
    # packets are transport, not state: the scheduler does not persist them
    # (the terminal JobResult carries the full list).
    tokens: list[int] = field(default_factory=list)
    # token offset of ``tokens[0]`` within the session's full generation
    # (-1 = unknown, legacy packets).  A failed-over session replays its
    # already-streamed prefix, so stream consumers MUST dedupe by offset to
    # assemble an exactly-once token sequence (docs/PROTOCOL.md).
    offset: int = -1


@dataclass
class JobCancel(WireModel):
    job_id: str = ""
    reason: str = ""
    requested_by: str = ""


@dataclass
class WorkerDrain(WireModel):
    """Graceful-drain request for one worker (``sys.worker.drain`` fan-out;
    docs/SERVING.md §Migration, drain, and failover).  The addressed worker
    stops admitting, live-migrates its serving sessions to peers, finishes
    its per-job work, publishes a final ``draining`` heartbeat (which evicts
    its scheduler affinity), then exits — zero CANCELLED sessions."""

    worker_id: str = ""
    reason: str = ""
    requested_by: str = ""


@dataclass
class JobPreempt(WireModel):
    """Preemption request for one in-flight BATCH job (``sys.job.preempt``
    fan-out; docs/ADMISSION.md §Preemption).  The worker holding the job
    hands it back where that is cheap and safe — a serving session requeues
    mid-decode (its streamed tokens ride the failover resume prefix), a job
    still waiting for an intake slot gives the slot up — and ignores the
    request where it is not (a handler already executing on the device).
    The scheduler re-dispatches preempted jobs attempts-exempt after a
    short jittered hold-off, so preemption can never FAIL or CANCEL work."""

    job_id: str = ""
    reason: str = ""
    requested_by: str = ""


@dataclass
class SessionMoved(WireModel):
    """Ownership announcement after a serving-session migration commits
    (``sys.serving.moved`` fan-out; docs/SERVING.md §Disaggregation).
    Published by the ADOPTING worker — the only process that knows the
    commit landed — so scheduler shards retarget the session's affinity
    entry to the new owner and follow-up turns/cancels route correctly.
    Not durable: a lost announcement degrades to the pre-disaggregation
    behavior (the stale entry is lazily evicted and the next turn
    re-elects a worker)."""

    job_id: str = ""
    session_key: str = ""
    from_worker: str = ""
    to_worker: str = ""
    reason: str = ""  # handoff | rebalance | drain | hibernated | restored


@dataclass
class SessionRebalance(WireModel):
    """Decode-rebalance request for one worker (``sys.serving.rebalance``
    fan-out; docs/SERVING.md §Disaggregation).  The scheduler's governor
    detects decode-occupancy/page-pressure skew in the capacity view and
    asks the hot worker to live-migrate up to ``max_sessions`` of its
    cheapest sessions (fewest live pages, oldest decode position) to the
    named headroom target.  Rate-limited and hysteresis-guarded on the
    governor side; migrated-in sessions are cooldown-immune on the worker
    side, so sessions never ping-pong."""

    worker_id: str = ""  # the overloaded worker being asked to shed
    target_worker: str = ""
    target_addr: str = ""  # the target's migration listener host:port
    max_sessions: int = 1
    reason: str = ""
    requested_by: str = ""


@dataclass
class AdmissionPressure(WireModel):
    """Overload-pressure beacon from the gateway admission controller
    (``sys.admission.pressure`` fan-out; docs/ADMISSION.md).  Published when
    the brownout tier changes and periodically while shedding is active;
    the scheduler's preemption governor acts on ``preempt_batch`` and the
    serving engines read it as the batch-deprioritization hint.  Not
    durable: pressure is a live signal, stale the moment the next
    evaluation lands."""

    tier: int = 0  # brownout tier (0 = normal .. 3 = bounded interactive)
    interactive_burn_5m: float = 0.0  # worst interactive 5m burn rate
    preempt_batch: bool = False  # interactive burn >= warn: requeue batch
    reason: str = ""
    # sender was pruned (CL010): receivers key on the BusPacket envelope's
    # sender_id; the duplicate payload field was never read


@dataclass
class GangMsg(WireModel):
    """One gang-coordination message on ``sys.job.gang.<gang_id>``
    (docs/GANG.md).  A single wire shape serves the whole gang protocol:

    * ``kind="ready"`` — a member's rendezvous beacon, re-published every
      few hundred ms until the barrier passes (fan-out subjects are not
      durable, so a beacon that raced a peer's subscribe is simply
      repeated).
    * ``kind="abort"`` — any member (or the scheduler watchdog) aborting
      the WHOLE gang: peers stop between steps, the scheduler releases
      every reserved device and requeues the job attempts-bounded.
    * ``kind="done"`` — a member's completion report; ``stats`` carries its
      result doc (loss, steps, mesh).  The owning scheduler shard
      aggregates all ranks into the job's single terminal result.
    * ``kind="stage"`` — MPMD pipeline traffic: the activation (forward)
      or cotangent (backward) tensor for ``to_rank``, addressed by the
      unique ``tag`` (``fwd:<step>:<microbatch>`` / ``bwd:...``); ``data``
      is the raw float32 buffer, ``shape`` its dims.
    * ``kind="step"`` — serving-gang replay traffic (docs/SERVING.md
      §Sharded serving): rank 0 broadcasts the ragged-step entry batch it
      just ran so every follower replays the identical program against its
      head shard; ``stats`` carries the serialized ``StepEntry`` rows and a
      monotonic ``seq`` (followers replay in order), plus ``final=True`` on
      the shutdown marker.
    """

    gang_id: str = ""
    job_id: str = ""
    kind: str = ""  # ready | abort | done | stage | step
    rank: int = -1
    to_rank: int = -1  # stage messages: the addressed member
    worker_id: str = ""
    reason: str = ""  # abort cause
    tag: str = ""  # stage routing key (unique per step/microbatch/direction)
    data: bytes = b""  # stage tensor payload (raw little-endian float32)
    shape: list[int] = field(default_factory=list)
    stats: dict[str, Any] = field(default_factory=dict)  # done: member result


@dataclass
class SystemAlert(WireModel):
    # set from workflow notify steps; gateway event taps forward alerts
    # verbatim to external sinks, which key on it — no in-tree reader
    severity: str = "info"  # cordum: wire-compat -- consumed by alert sinks behind the gateway tap
    source: str = ""
    message: str = ""
    labels: dict[str, str] = field(default_factory=dict)


@dataclass
class TelemetrySnapshot(WireModel):
    """Periodic per-process metric snapshot + health beacon (the fleet
    telemetry plane's wire unit, docs/OBSERVABILITY.md §Fleet telemetry).

    Published on ``sys.telemetry.<service>`` every ``interval_s`` seconds by
    the :class:`~cordum_tpu.obs.telemetry.TelemetryExporter` embedded in each
    process.  ``metrics`` carries the process's ``Metrics`` registry in the
    compact snapshot format (``Metrics.snapshot()``), delta-encoded: only
    series whose value changed since the previous publish ride the wire,
    with a periodic ``full=True`` snapshot so a late-joining aggregator
    converges on gauges and quiet series.  ``started_at_us`` is the process
    epoch — a change at constant (service, instance) is a restart, which is
    how the aggregator detects counter resets."""

    service: str = ""  # gateway / scheduler / statebus / worker / ...
    instance: str = ""  # unique per process (instance_id, endpoint, ...)
    seq: int = 0  # snapshot sequence within this process epoch
    started_at_us: int = 0  # process start (restart/reset detection)
    uptime_s: float = 0.0
    interval_s: float = 0.0  # configured publish cadence (staleness bound)
    full: bool = False  # full registry snapshot vs changed-series delta
    health: dict[str, Any] = field(default_factory=dict)  # role beacon
    metrics: dict[str, Any] = field(default_factory=dict)  # Metrics.snapshot()


SPAN_OK = "OK"
SPAN_ERROR = "ERROR"


@dataclass
class Span(WireModel):
    """One timed segment of a trace (the flight-recorder unit).

    Spans form a tree per ``trace_id`` via ``parent_span_id``; services
    publish finished spans on the durable ``sys.trace.span`` subject and the
    collector (``cordum_tpu/obs/collector.py``) persists them per trace.
    Timestamps are wall-clock microseconds (``utils.ids.now_us`` — the job
    store's clock) so spans from different processes line up."""

    span_id: str = ""
    parent_span_id: str = ""
    trace_id: str = ""
    name: str = ""  # stage name: submit/policy-check/schedule/dispatch/...
    service: str = ""  # gateway/scheduler/safety-kernel/workflow-engine/worker
    start_us: int = 0
    end_us: int = 0
    status: str = SPAN_OK
    attrs: dict[str, str] = field(default_factory=dict)

    @property
    def duration_us(self) -> int:
        return max(0, self.end_us - self.start_us)


# ---------------------------------------------------------------------------
# safety kernel contract
# ---------------------------------------------------------------------------


@dataclass
class Constraints(WireModel):
    """Execution constraints attached to ALLOW_WITH_CONSTRAINTS decisions.

    TPU-native additions: max_chips / allowed_topologies bound what slice a
    job may be placed on (reference constraints are budgets/sandbox/toolchain/
    diff/redaction_level — config/safety_policy.go:13-146)."""

    max_tokens: int = 0
    max_cost_usd: float = 0.0
    # the scheduler forwards the whole Constraints dict verbatim to workers
    # via env[ENV_POLICY_CONSTRAINTS] (engine._apply_constraints); the
    # sandbox/toolchain/diff/redaction knobs are enforced by the worker-side
    # executor, not by any in-tree reader
    sandbox: str = ""  # cordum: wire-compat -- enforced worker-side via ENV_POLICY_CONSTRAINTS
    toolchain: str = ""  # cordum: wire-compat -- enforced worker-side via ENV_POLICY_CONSTRAINTS
    diff_limit: str = ""  # cordum: wire-compat -- enforced worker-side via ENV_POLICY_CONSTRAINTS
    redaction_level: str = ""  # cordum: wire-compat -- enforced worker-side via ENV_POLICY_CONSTRAINTS
    max_chips: int = 0
    allowed_topologies: list[str] = field(default_factory=list)  # cordum: wire-compat -- enforced worker-side via ENV_POLICY_CONSTRAINTS
    env: dict[str, str] = field(default_factory=dict)


@dataclass
class Remediation(WireModel):
    id: str = ""
    description: str = ""
    replacement_topic: str = ""
    replacement_capability: str = ""
    add_labels: dict[str, str] = field(default_factory=dict)
    remove_labels: list[str] = field(default_factory=list)


@dataclass
class PolicyCheckRequest(WireModel):
    job_id: str = ""
    tenant_id: str = ""
    principal_id: str = ""
    topic: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    metadata: Optional[JobMetadata] = None
    actor_id: str = ""
    actor_type: str = ""
    effective_config: dict[str, Any] = field(default_factory=dict)


@dataclass
class PolicyCheckResponse(WireModel):
    decision: str = Decision.ALLOW.value
    reason: str = ""
    rule_id: str = ""
    policy_snapshot: str = ""
    # mirrors decision==REQUIRE_APPROVAL as a plain bool so non-Python
    # admin tooling doesn't need the Decision enum; approval_ref was
    # pruned (CL010) — never set, never read
    approval_required: bool = False  # cordum: wire-compat -- read by external admin tooling
    throttle_delay_s: float = 0.0
    constraints: Optional[Constraints] = None
    remediations: list[Remediation] = field(default_factory=list)


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------

_PAYLOAD_TYPES: dict[str, type] = {
    "job_request": JobRequest,
    "job_result": JobResult,
    "heartbeat": Heartbeat,
    "job_progress": JobProgress,
    "job_cancel": JobCancel,
    "job_preempt": JobPreempt,
    "worker_drain": WorkerDrain,
    "admission_pressure": AdmissionPressure,
    "session_moved": SessionMoved,
    "session_rebalance": SessionRebalance,
    "gang_msg": GangMsg,
    "system_alert": SystemAlert,
    "span": Span,
    "telemetry": TelemetrySnapshot,
}
# O(1) reverse lookup for wrap() (exact types only; payloads are always the
# concrete dataclasses, and wrap() keeps an isinstance fallback for subclasses)
_KIND_BY_TYPE: dict[type, str] = {t: k for k, t in _PAYLOAD_TYPES.items()}


class BusPacket(WireModel):
    """Envelope for every bus message (reference BusPacket oneof payload).

    ``span_id``/``parent_span_id`` carry flight-recorder span context across
    process boundaries: a receiver that starts a span for the work this
    packet triggers uses ``span_id`` as its parent (see docs/PROTOCOL.md
    "Span context").

    Codec fast paths (docs/PROTOCOL.md "Fast-path specialization"):

    * **lazy decode** — ``from_wire``/``from_dict`` materialize only the
      envelope; the typed payload dataclass is built on first access, so
      routing-only consumers (dedupe, forward-to-owner, the statebus
      server's subject router) never pay the dataclass conversion.
    * **encode cache** — a packet decoded from the wire remembers its exact
      bytes; re-publishing it (shard forwarding, redelivery) reuses them
      instead of re-running ``to_dict``/``packb``.  Mutating ``payload``
      drops the cache; mutating the payload object *in place* after the
      first encode is a contract violation (stamp labels before wrapping).
    """

    __slots__ = (
        "trace_id", "sender_id", "created_at_us", "protocol_version",
        "kind", "span_id", "parent_span_id", "_payload", "_raw_payload",
        "_wire", "redelivery_count",
    )

    def __init__(
        self,
        *,
        trace_id: str = "",
        sender_id: str = "",
        created_at_us: int = 0,
        protocol_version: int = PROTOCOL_VERSION,
        kind: str = "",
        payload: Any = None,
        span_id: str = "",
        parent_span_id: str = "",
    ) -> None:
        self.trace_id = trace_id
        self.sender_id = sender_id
        self.created_at_us = created_at_us
        self.protocol_version = protocol_version
        self.kind = kind
        self.span_id = span_id  # span under which this packet was published
        self.parent_span_id = parent_span_id  # that span's parent
        self._payload = payload
        self._raw_payload: Any = None
        self._wire: Optional[bytes] = None
        # delivery-local, never serialized: how many times the bus has
        # redelivered THIS delivery after RetryAfter NAKs (0 on the first
        # attempt).  Handlers use it to back off exponentially instead of
        # NAKing at a fixed cadence (a tenant burst would otherwise
        # resonate as a synchronized retry storm).
        self.redelivery_count = 0

    def __repr__(self) -> str:  # debugging/log parity with the old dataclass
        return (
            f"BusPacket(kind={self.kind!r}, trace_id={self.trace_id!r}, "
            f"sender_id={self.sender_id!r}, payload={self._payload!r})"
        )

    @property
    def payload(self) -> Any:
        p = self._payload
        if p is None and self._raw_payload is not None:
            t = _PAYLOAD_TYPES.get(self.kind)
            raw = self._raw_payload
            p = t.from_dict(raw) if (t is not None and isinstance(raw, dict)) else raw
            self._payload = p
        return p

    @payload.setter
    def payload(self, value: Any) -> None:
        self._payload = value
        self._raw_payload = None
        self._wire = None

    @property
    def raw_payload(self) -> Any:
        """The payload as a plain wire dict when decoded lazily (None for
        locally constructed packets) — lets routing code peek at envelope-
        adjacent fields without forcing the dataclass conversion."""
        return self._raw_payload

    @classmethod
    def wrap(
        cls,
        payload: Any,
        *,
        trace_id: str = "",
        sender_id: str = "",
        span_id: str = "",
        parent_span_id: str = "",
    ) -> "BusPacket":
        kind = _KIND_BY_TYPE.get(type(payload), "")
        if not kind:
            for k, t in _PAYLOAD_TYPES.items():
                if isinstance(payload, t):
                    kind = k
                    break
        if not kind:
            raise TypeError(f"unsupported payload type {type(payload)!r}")
        return cls(
            trace_id=trace_id or new_id(),
            sender_id=sender_id,
            created_at_us=now_us(),
            kind=kind,
            payload=payload,
            span_id=span_id,
            parent_span_id=parent_span_id,
        )

    def to_dict(self) -> dict[str, Any]:
        d = {
            "trace_id": self.trace_id,
            "sender_id": self.sender_id,
            "created_at_us": self.created_at_us,
            "protocol_version": self.protocol_version,
            "kind": self.kind,
        }
        # span context rides only when set (wire stays lean for untraced
        # packets; old peers tolerate the extra keys either way)
        if self.span_id:
            d["span_id"] = self.span_id
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self._payload is not None:
            d["payload"] = _to_plain(self._payload)
        elif self._raw_payload is not None:
            d["payload"] = self._raw_payload
        return d

    def to_wire(self) -> bytes:
        w = self._wire
        if w is None:
            w = codec.packb(self.to_dict())
            self._wire = w
        return w

    @classmethod
    def from_wire(cls, b: bytes) -> Optional["BusPacket"]:
        pkt = cls.from_dict(codec.unpackb(b))
        if pkt is not None:
            pkt._wire = bytes(b)
        return pkt

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> Optional["BusPacket"]:
        if d is None:
            return None
        pkt = cls(
            trace_id=d.get("trace_id", ""),
            sender_id=d.get("sender_id", ""),
            created_at_us=d.get("created_at_us", 0),
            protocol_version=d.get("protocol_version", PROTOCOL_VERSION),
            kind=d.get("kind", ""),
            span_id=d.get("span_id", ""),
            parent_span_id=d.get("parent_span_id", ""),
        )
        pkt._raw_payload = d.get("payload")
        return pkt

    # typed accessors ------------------------------------------------------
    @property
    def job_request(self) -> Optional[JobRequest]:
        return self.payload if self.kind == "job_request" else None

    @property
    def job_result(self) -> Optional[JobResult]:
        return self.payload if self.kind == "job_result" else None

    @property
    def heartbeat(self) -> Optional[Heartbeat]:
        return self.payload if self.kind == "heartbeat" else None

    @property
    def job_progress(self) -> Optional[JobProgress]:
        return self.payload if self.kind == "job_progress" else None

    @property
    def job_cancel(self) -> Optional[JobCancel]:
        return self.payload if self.kind == "job_cancel" else None

    @property
    def job_preempt(self) -> Optional[JobPreempt]:
        return self.payload if self.kind == "job_preempt" else None

    @property
    def worker_drain(self) -> Optional[WorkerDrain]:
        return self.payload if self.kind == "worker_drain" else None

    @property
    def admission_pressure(self) -> Optional[AdmissionPressure]:
        return self.payload if self.kind == "admission_pressure" else None

    @property
    def session_moved(self) -> Optional[SessionMoved]:
        return self.payload if self.kind == "session_moved" else None

    @property
    def session_rebalance(self) -> Optional[SessionRebalance]:
        return self.payload if self.kind == "session_rebalance" else None

    @property
    def gang_msg(self) -> Optional[GangMsg]:
        return self.payload if self.kind == "gang_msg" else None

    @property
    def system_alert(self) -> Optional[SystemAlert]:
        return self.payload if self.kind == "system_alert" else None

    @property
    def span(self) -> Optional[Span]:
        return self.payload if self.kind == "span" else None

    @property
    def telemetry(self) -> Optional[TelemetrySnapshot]:
        return self.payload if self.kind == "telemetry" else None


# nested-field converters for WireModel.from_dict
_NESTED: dict[tuple[type, str], Any] = {
    (JobRequest, "metadata"): JobMetadata.from_dict,
    (JobRequest, "context_hints"): ContextHints.from_dict,
    (JobRequest, "budget"): Budget.from_dict,
    (PolicyCheckRequest, "metadata"): JobMetadata.from_dict,
    (PolicyCheckResponse, "constraints"): Constraints.from_dict,
    (PolicyCheckResponse, "remediations"): lambda v: [
        Remediation.from_dict(x) for x in v
    ],
}

# Label key used by approvals / bus msg-id override
LABEL_APPROVAL_GRANTED = "approval_granted"
LABEL_APPROVAL_REF = "approval_ref"
LABEL_BUS_MSG_ID = "cordum.bus_msg_id"
LABEL_DRY_RUN = "cordum.dry_run"
LABEL_SECRETS_PRESENT = "secrets_present"
# Workflow SLO class (docs/WORKFLOWS.md): stamped on the run at start (from
# Workflow.slo_class or a per-run label override) and propagated by the
# engine into every dispatched JobRequest.priority, so agent-loop steps ride
# the admission ladder and the class-split e2e histogram like API submits.
LABEL_SLO_CLASS = "cordum.slo_class"
ENV_EFFECTIVE_CONFIG = "CORDUM_EFFECTIVE_CONFIG"

# ---------------------------------------------------------------------------
# micro-batching declaration (cordum_tpu/batching)
# ---------------------------------------------------------------------------

# Ops whose jobs the worker-side micro-batcher may coalesce into one padded
# XLA call.  Batchable = the op is a pure per-row computation (row i of the
# batched program equals the row run alone), so results scatter back as
# ordinary per-job JobResults.
BATCHABLE_OPS = frozenset({"embed", "infer"})

# Batch-routing label: the gateway stamps it at submit so the scheduler can
# route same-key jobs to the same worker (batch affinity) without reading
# the payload behind the context pointer.
LABEL_BATCH_KEY = "cordum.batch_key"

# Op-routing label: the gateway stamps the payload's ``op`` at submit so
# capacity-aware consumers (the ThroughputAwareStrategy's matrix lookup,
# the admission controller's per-op headroom) can key into the fleet
# throughput matrix without reading the payload behind the context pointer.
LABEL_OP = "cordum.op"

# Shard-routing label: the scheduler shard stamps its partition index on the
# dispatched request so the worker can publish the result straight to the
# owning shard's ``sys.job.result.<p>`` subject (no forwarding hop).  Pure
# routing metadata — excluded from the approval job hash (protocol/jobhash).
LABEL_PARTITION = "cordum.partition"


def payload_batch_key(payload: Any) -> str:
    """The batch key for a job payload: the batchable op name, or ``""``
    when the payload is not a batchable shape.  Key equality is the
    contract: two jobs with the same key may share one XLA program."""
    if isinstance(payload, dict):
        op = payload.get("op")
        if isinstance(op, str) and op in BATCHABLE_OPS:
            return op
    return ""


# ---------------------------------------------------------------------------
# serving declaration (cordum_tpu/serving)
# ---------------------------------------------------------------------------

# Ops the worker's serving engine handles: stateful autoregressive decode
# with a per-session paged KV cache (docs/SERVING.md).  Serving ops are NOT
# batchable ops — they join the continuous-batching decode loop instead of
# the stateless micro-batch queues.
SERVING_OPS = frozenset({"llm.generate"})

# Session-routing label: the gateway stamps it from the payload's
# ``session_id`` at submit, so the scheduler can route every turn of a
# conversation to the worker holding its KV pages (session affinity,
# generalizing LABEL_BATCH_KEY) without reading the payload behind the
# context pointer.
LABEL_SESSION_KEY = "cordum.session_key"

# JobProgress.status_hint marking a token-stream packet: relayed to WS
# stream consumers but never persisted as a job event (per-token events
# would swamp the job store's event log).
STATUS_HINT_STREAM = "stream"

# Forced-decode resume prefix (docs/SERVING.md §Migration, drain, and
# failover): when the scheduler fails a serving session over to a new
# worker it stamps the tokens the dead worker already streamed as a
# comma-joined label; the new worker prefills prompt + prefix (forced
# decode), re-emits the prefix at offset 0 (consumers dedupe by offset),
# and continues generating from there — no duplicated or missing tokens.
LABEL_RESUME_TOKENS = "cordum.resume_tokens"

# JobResult.error_code of a NON-terminal (status=RUNNING) result a worker
# publishes to hand a job back to the scheduler for failover instead of
# failing it: a draining worker with no migration target, or a crashed
# decode loop's live sessions.  The scheduler re-dispatches (bounded by the
# attempts counter) rather than recording a terminal state.
ERROR_SESSION_REQUEUE = "SESSION_REQUEUE"

# Heartbeat labels a serving worker advertises so peers can live-migrate KV
# pages to it: the migration listener's host:port, and its free-page count
# (the capacity-matrix KV headroom signal drain uses to pick a target).
LABEL_MIGRATE_ADDR = "cordum.migrate_addr"
LABEL_KV_PAGES_FREE = "cordum.kv_pages_free"

# Prefill/decode disaggregation (docs/SERVING.md §Disaggregation): the
# worker's serving role — ``prefill`` workers ingest prompts fast and hand
# sessions off post-prefill, ``decode`` workers adopt them for steady
# token generation, ``mixed`` (the default) does both and never hands off.
# Rides heartbeats (peer hand-off ranking) AND the beacon capacity block
# (scheduler-side placement + the capacity doc).
SERVING_ROLE_PREFILL = "prefill"
SERVING_ROLE_DECODE = "decode"
SERVING_ROLE_MIXED = "mixed"
SERVING_ROLES = frozenset(
    {SERVING_ROLE_PREFILL, SERVING_ROLE_DECODE, SERVING_ROLE_MIXED}
)
LABEL_SERVING_ROLE = "cordum.serving_role"
# Submitter hint that this session's prompts are templated/repetitive and
# will benefit from the serving engine's self-speculative decoder.  The
# ServingPlacer PREFERS draft-enabled workers (those exporting
# ``spec_accept_rate`` in their occupancy block) when this label is set,
# but never hard-filters on it — a fleet with speculation disabled
# everywhere still places normally.
LABEL_SPECULABLE = "cordum.speculable"
# Steady-state decode tokens/s this worker measured for itself (the
# capacity profiler's llm.generate row) — peers rank hand-off targets by
# KV-page headroom × this rate without a capacity-matrix RPC.
LABEL_DECODE_TOKENS_PER_S = "cordum.decode_tokens_per_s"

# The synthetic capacity-matrix op name for the prefill side of a mixed
# ragged step: the serving engine apportions each step's device time
# between prompt ingestion (this row) and token generation (the
# ``llm.generate`` row) by delivered tokens, so prefill tokens/s and
# decode tokens/s are separately measurable — the ServingPlacer routes new
# sessions on the prefill rate, the rebalancer and hand-off rank targets
# on the decode rate.
OP_SERVING_PREFILL = "llm.prefill"


def payload_session_key(payload: Any) -> str:
    """The session key for a serving payload (its ``session_id``), or ``""``
    for non-serving payloads and sessionless one-shot generations."""
    if isinstance(payload, dict) and payload.get("op") in SERVING_OPS:
        sid = payload.get("session_id")
        if isinstance(sid, str):
            return sid
    return ""


# ---------------------------------------------------------------------------
# gang scheduling declaration (docs/GANG.md)
# ---------------------------------------------------------------------------

# A gang job's payload carries a ``gang`` stanza next to its ``mesh``:
#
#   {"op": "train", "model": "llama-tiny", "steps": 2,
#    "mesh": {"dp": -1, "tp": 2, "sp": 2},
#    "gang": {"workers": 2, "chips_per_worker": 8}}
#
# The gateway stamps the stanza as routing labels at submit (mirroring
# LABEL_OP/LABEL_SESSION_KEY) so the scheduler's gang path never reads the
# payload behind the context pointer.  The scheduler-stamped dispatch
# labels (gang id / rank / size / members) tell each worker its place in
# the gang; they are routing metadata, excluded from the approval job hash.

# submit-time labels (gateway ← payload["gang"])
LABEL_GANG_WORKERS = "cordum.gang_workers"  # members requested (all-or-nothing)
LABEL_GANG_CHIPS = "cordum.gang_chips"  # min chips each member must own
LABEL_GANG_KIND = "cordum.gang_kind"  # "" (train) | "serving" (TP serving gang)

# dispatch-time labels (gang scheduler → members)
LABEL_GANG_ID = "cordum.gang_id"
LABEL_GANG_RANK = "cordum.gang_rank"
LABEL_GANG_SIZE = "cordum.gang_size"
LABEL_GANG_MEMBERS = "cordum.gang_members"  # comma-joined worker ids, rank order


def payload_gang(payload: Any) -> Optional[dict]:
    """The payload's ``gang`` stanza when it requests gang placement
    (``workers >= 1``), else None."""
    if not isinstance(payload, dict):
        return None
    g = payload.get("gang")
    if not isinstance(g, dict):
        return None
    try:
        if int(g.get("workers", 0)) < 1:
            return None
    except (TypeError, ValueError):
        return None
    return g


def gang_workers(labels: Optional[dict]) -> int:
    """Members a gang-labeled request asks for (0 = not a gang job)."""
    try:
        return max(0, int((labels or {}).get(LABEL_GANG_WORKERS, "0") or 0))
    except (TypeError, ValueError):
        return 0


def gang_chips(labels: Optional[dict]) -> int:
    try:
        return max(0, int((labels or {}).get(LABEL_GANG_CHIPS, "0") or 0))
    except (TypeError, ValueError):
        return 0


def gang_kind(labels: Optional[dict]) -> str:
    """The gang's workload kind ("" = training/generic, "serving" = a
    tensor-parallel serving gang; docs/SERVING.md §Sharded serving)."""
    v = (labels or {}).get(LABEL_GANG_KIND, "")
    return v if isinstance(v, str) else ""
