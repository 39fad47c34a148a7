"""Workflow data model (reference ``core/workflow/models.go:8-180``).

A workflow is a DAG of steps keyed by id.  Built-in step types are
interpreted by the engine (approval / condition / delay / notify); every
other type dispatches as a job on the step's topic.  ``for_each`` is a
modifier on a dispatching step that fans out one child per item with
``max_parallel`` throttling.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils.ids import now_us

BUILTIN_STEP_TYPES = {"approval", "condition", "delay", "notify"}

# Workflow SLO classes: mirror protocol.types.Priority values (kept as a
# local literal so the model layer stays dependency-free).  The class rides
# into every dispatched JobRequest.priority, so a whole agent swarm can be
# shed on the admission ladder before one interactive loop degrades.
SLO_CLASSES = ("INTERACTIVE", "BATCH", "CRITICAL")

# ops the engine executes in-process against the ContextService (the embeds
# themselves still run as pool jobs); every other op dispatches on the bus
CONTEXT_STEP_OPS = ("context.update", "context.window")

# run / step statuses
PENDING = "PENDING"
RUNNING = "RUNNING"
WAITING = "WAITING"        # delay steps / parked retries
WAITING_APPROVAL = "WAITING_APPROVAL"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
SKIPPED = "SKIPPED"        # condition gate false

RUN_TERMINAL = {SUCCEEDED, FAILED, CANCELLED}
STEP_TERMINAL = {SUCCEEDED, FAILED, CANCELLED, SKIPPED}


@dataclass
class RetryPolicy:
    max_retries: int = 0
    backoff_sec: float = 1.0
    multiplier: float = 2.0
    max_backoff_sec: float = 300.0


@dataclass
class Step:
    id: str = ""
    type: str = "worker"          # builtin type or job-dispatch type
    topic: str = ""
    depends_on: list[str] = field(default_factory=list)
    condition: str = ""           # expression gate; false → SKIPPED
    for_each: str = ""            # expression yielding a list → fan-out
    max_parallel: int = 0         # 0 = unlimited children at once
    input: Any = None             # templated payload (${...} expansion)
    input_schema_id: str = ""
    output_schema_id: str = ""
    output_path: str = ""         # where to graft the result in run ctx
    meta: dict[str, Any] = field(default_factory=dict)  # → JobMetadata
    route_labels: dict[str, str] = field(default_factory=dict)
    retry: Optional[RetryPolicy] = None
    timeout_sec: float = 0.0
    delay_sec: float = 0.0        # delay steps
    delay_until: str = ""         # RFC3339 or unix seconds
    notify_message: str = ""      # notify steps
    notify_severity: str = "info"
    on_error: str = ""            # "continue" → failure doesn't fail the run

    @classmethod
    def from_dict(cls, sid: str, d: dict[str, Any]) -> "Step":
        retry = None
        if d.get("retry"):
            r = d["retry"]
            retry = RetryPolicy(
                max_retries=int(r.get("max_retries", 0)),
                backoff_sec=float(r.get("backoff_sec", 1.0)),
                multiplier=float(r.get("multiplier", 2.0)),
                max_backoff_sec=float(r.get("max_backoff_sec", 300.0)),
            )
        return cls(
            id=sid,
            type=str(d.get("type", "worker")),
            topic=str(d.get("topic", "")),
            depends_on=list(d.get("depends_on") or []),
            condition=str(d.get("condition", "")),
            for_each=str(d.get("for_each", "")),
            max_parallel=int(d.get("max_parallel", 0)),
            input=d.get("input"),
            input_schema_id=str(d.get("input_schema_id", "")),
            output_schema_id=str(d.get("output_schema_id", "")),
            output_path=str(d.get("output_path", "")),
            meta=dict(d.get("meta") or {}),
            route_labels={str(k): str(v) for k, v in (d.get("route_labels") or {}).items()},
            retry=retry,
            timeout_sec=float(d.get("timeout_sec", 0.0)),
            delay_sec=float(d.get("delay_sec", 0.0)),
            delay_until=str(d.get("delay_until", "")),
            notify_message=str(d.get("notify_message", d.get("message", ""))),
            notify_severity=str(d.get("notify_severity", "info")),
            on_error=str(d.get("on_error", "")),
        )

    def to_dict(self) -> dict[str, Any]:
        d = {
            "type": self.type,
            "topic": self.topic,
            "depends_on": self.depends_on,
            "condition": self.condition,
            "for_each": self.for_each,
            "max_parallel": self.max_parallel,
            "input": self.input,
            "input_schema_id": self.input_schema_id,
            "output_schema_id": self.output_schema_id,
            "output_path": self.output_path,
            "meta": self.meta,
            "route_labels": self.route_labels,
            "timeout_sec": self.timeout_sec,
            "delay_sec": self.delay_sec,
            "delay_until": self.delay_until,
            "notify_message": self.notify_message,
            "notify_severity": self.notify_severity,
            "on_error": self.on_error,
        }
        if self.retry:
            d["retry"] = dict(self.retry.__dict__)
        return d


@dataclass
class Workflow:
    id: str = ""
    name: str = ""
    org_id: str = ""
    version: int = 1
    input_schema_id: str = ""
    # SLO class stamped on every dispatched JobRequest.priority ("" = BATCH);
    # a run label `cordum.slo_class` overrides it per run
    slo_class: str = ""
    steps: dict[str, Step] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    created_at_us: int = 0

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Workflow":
        wf = cls(
            id=str(d.get("id", "")),
            name=str(d.get("name", "")),
            org_id=str(d.get("org_id", "")),
            version=int(d.get("version", 1)),
            input_schema_id=str(d.get("input_schema_id", "")),
            slo_class=str(d.get("slo_class", "")).upper(),
            labels={str(k): str(v) for k, v in (d.get("labels") or {}).items()},
            created_at_us=int(d.get("created_at_us", 0) or now_us()),
        )
        for sid, sd in (d.get("steps") or {}).items():
            wf.steps[sid] = Step.from_dict(sid, sd or {})
        return wf

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "org_id": self.org_id,
            "version": self.version,
            "input_schema_id": self.input_schema_id,
            "slo_class": self.slo_class,
            "labels": self.labels,
            "created_at_us": self.created_at_us,
            "steps": {sid: s.to_dict() for sid, s in self.steps.items()},
        }

    def validate(self) -> list[str]:
        errs = []
        if self.slo_class and self.slo_class not in SLO_CLASSES:
            errs.append(
                f"unknown slo_class {self.slo_class!r} (one of {', '.join(SLO_CLASSES)})"
            )
        for sid, step in self.steps.items():
            for dep in step.depends_on:
                if dep not in self.steps:
                    errs.append(f"step {sid}: unknown dependency {dep!r}")
            if step.type not in BUILTIN_STEP_TYPES and not step.topic:
                errs.append(f"step {sid}: dispatching step needs a topic")
        # cycle check (Kahn)
        indeg = {sid: len(s.depends_on) for sid, s in self.steps.items()}
        queue = [sid for sid, n in indeg.items() if n == 0]
        seen = 0
        while queue:
            sid = queue.pop()
            seen += 1
            for other, s in self.steps.items():
                if sid in s.depends_on:
                    indeg[other] -= 1
                    if indeg[other] == 0:
                        queue.append(other)
        if seen != len(self.steps):
            errs.append("dependency cycle detected")
        return errs


@dataclass
class StepRun:
    step_id: str = ""
    status: str = PENDING
    attempts: int = 0
    job_id: str = ""
    started_at_us: int = 0
    finished_at_us: int = 0
    error: str = ""
    next_retry_at_us: int = 0       # parked retry resume time
    wake_at_us: int = 0             # delay step resume time
    children: dict[str, "StepRun"] = field(default_factory=dict)  # for_each index → child
    processed_results: list[str] = field(default_factory=list)    # "jobid@attempt" dedupe

    def to_dict(self) -> dict[str, Any]:
        d = dict(self.__dict__)
        d["children"] = {k: c.to_dict() for k, c in self.children.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StepRun":
        c = {k: StepRun.from_dict(v) for k, v in (d.get("children") or {}).items()}
        kw = {k: v for k, v in d.items() if k in cls.__dataclass_fields__ and k != "children"}
        sr = cls(**kw)
        sr.children = c
        return sr


@dataclass
class WorkflowRun:
    run_id: str = ""
    workflow_id: str = ""
    org_id: str = ""
    status: str = PENDING
    input: Any = None
    context: dict[str, Any] = field(default_factory=dict)  # {"input":…, "steps":{…}}
    steps: dict[str, StepRun] = field(default_factory=dict)
    created_at_us: int = 0
    updated_at_us: int = 0
    finished_at_us: int = 0
    error: str = ""
    dry_run: bool = False
    labels: dict[str, str] = field(default_factory=dict)
    # run-level trace: every step-dispatch span parents under one root span
    # so the whole agent loop renders as ONE waterfall with per-step blame
    trace_id: str = ""
    root_span_id: str = ""

    def to_dict(self) -> dict[str, Any]:
        d = dict(self.__dict__)
        d["steps"] = {k: s.to_dict() for k, s in self.steps.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "WorkflowRun":
        steps = {k: StepRun.from_dict(v) for k, v in (d.get("steps") or {}).items()}
        kw = {k: v for k, v in d.items() if k in cls.__dataclass_fields__ and k != "steps"}
        run = cls(**kw)
        run.steps = steps
        return run


@dataclass
class TimelineEvent:
    ts_us: int = 0
    run_id: str = ""
    step_id: str = ""
    event: str = ""
    detail: str = ""

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)
