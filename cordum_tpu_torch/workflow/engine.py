"""Workflow engine: deterministic step state machine over the run store.

Recreates the reference engine's behavior (``core/workflow/engine.go``,
1809 LoC) in asyncio:

  * step scheduling in the reference order: DAG ``depends_on`` gating →
    condition gate → built-ins (approval / condition / delay / notify)
    inline → ``for_each`` fan-out with ``max_parallel`` throttling and child
    pre-creation → job dispatch with job id ``runID:stepID@attempt``
  * results: attempt parsing, duplicate suppression, retry with exponential
    backoff (parked via ``next_retry_at_us``, resumed by the reconciler),
    output-schema validation, inline-result capture (≤256 KiB) into run
    context ``steps.<id>`` plus optional ``output_path`` graft, child
    aggregation, run-status rollup (a failed child fails the run unless the
    step declares ``on_error: continue``)
  * ``approve_step`` resumes approval-parked runs; ``cancel_run`` broadcasts
    JobCancel for in-flight jobs; ``rerun_from`` resets a step and its
    dependent closure into a fresh run; dry runs label dispatched jobs
  * ``${...}`` template expansion over ``{input, ctx, steps, item}``
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Optional

from ..infra import logging as logx
from ..infra.bus import Bus
from ..infra.configsvc import ConfigService
from ..infra.memstore import MemoryStore
from ..infra.metrics import Metrics
from ..infra.schemareg import SchemaRegistry
from ..obs.tracer import Tracer
from ..protocol import subjects as subj
from ..protocol.types import (
    BATCHABLE_OPS,
    BusPacket,
    ENV_EFFECTIVE_CONFIG,
    JobCancel,
    JobMetadata,
    JobRequest,
    JobResult,
    JobState,
    LABEL_BATCH_KEY,
    LABEL_DRY_RUN,
    LABEL_OP,
    LABEL_SESSION_KEY,
    LABEL_SLO_CLASS,
    Priority,
    SERVING_OPS,
    SPAN_ERROR,
    SPAN_OK,
    Span,
    SystemAlert,
)
from ..utils.ids import new_id, now_us
from . import models as M
from .eval import evaluate, expand_templates, set_path, truthy
from .models import Step, StepRun, TimelineEvent, Workflow, WorkflowRun
from .store import WorkflowStore

MAX_INLINE_RESULT_BYTES = 256 * 1024


class WorkflowError(Exception):
    pass


def make_job_id(run_id: str, step_key: str, attempt: int) -> str:
    return f"{run_id}:{step_key}@{attempt}"


def split_job_id(job_id: str) -> tuple[str, str, int]:
    """→ (run_id, step_key, attempt); raises ValueError for non-wf job ids."""
    head, _, attempt = job_id.rpartition("@")
    run_id, _, step_key = head.partition(":")
    if not run_id or not step_key or not attempt.isdigit():
        raise ValueError(f"not a workflow job id: {job_id!r}")
    return run_id, step_key, int(attempt)


def run_session_key(run: WorkflowRun) -> str:
    """The per-run serving session key: an explicit run label wins, else a
    run-scoped default.  Every ``llm.generate`` step of the run carries it,
    so turn N routes via session affinity to the worker already holding the
    session's KV pages (docs/WORKFLOWS.md §Session continuity)."""
    return run.labels.get(LABEL_SESSION_KEY) or f"wf:{run.run_id}"


_PRIORITY_VALUES = frozenset(p.value for p in Priority)


def child_key(step_id: str, index: int) -> str:
    return f"{step_id}#{index}"


def parse_child_key(step_key: str) -> tuple[str, Optional[int]]:
    if "#" in step_key:
        sid, _, idx = step_key.partition("#")
        return sid, int(idx) if idx.isdigit() else None
    return step_key, None


class Engine:
    def __init__(
        self,
        *,
        store: WorkflowStore,
        bus: Bus,
        mem: MemoryStore,
        schemas: Optional[SchemaRegistry] = None,
        configsvc: Optional[ConfigService] = None,
        metrics: Optional[Metrics] = None,
        instance_id: str = "wf-engine-0",
        context_svc: Any = None,
    ):
        self.store = store
        self.bus = bus
        self.mem = mem
        self.schemas = schemas
        self.configsvc = configsvc
        self.metrics = metrics or Metrics()
        self.instance_id = instance_id
        self.tracer = Tracer("workflow-engine", bus)
        # ContextService executing context.update / context.window steps
        # in-engine; its embedder submits embed jobs to the worker pool, so
        # the heavy leg still rides micro-batching (docs/WORKFLOWS.md)
        self.context_svc = context_svc
        self._context_tasks: set = set()

    # ------------------------------------------------------------------
    # run lifecycle
    # ------------------------------------------------------------------
    async def start_run(
        self,
        workflow_id: str,
        input_value: Any = None,
        *,
        org_id: str = "",
        idempotency_key: str = "",
        dry_run: bool = False,
        labels: Optional[dict[str, str]] = None,
        max_concurrent_runs: int = 0,
    ) -> WorkflowRun:
        wf = await self.store.get_workflow(workflow_id)
        if wf is None:
            raise WorkflowError(f"unknown workflow {workflow_id!r}")
        if self.schemas is not None and wf.input_schema_id:
            errs = await self.schemas.validate_id(wf.input_schema_id, input_value)
            if errs:
                raise WorkflowError(f"input schema validation failed: {errs}")
        if max_concurrent_runs and org_id:
            active = await self.store.count_active_runs(org_id)
            if active >= max_concurrent_runs:
                raise WorkflowError(
                    f"org {org_id} at max concurrent runs ({max_concurrent_runs})"
                )
        run_id = new_id()
        run = WorkflowRun(
            run_id=run_id,
            workflow_id=workflow_id,
            org_id=org_id or wf.org_id,
            status=M.RUNNING,
            input=input_value,
            context={"input": input_value, "steps": {}},
            steps={sid: StepRun(step_id=sid) for sid in wf.steps},
            created_at_us=now_us(),
            dry_run=dry_run,
            labels=labels or {},
            # one trace per run: every step-dispatch span parents under the
            # root span emitted at run end, so the whole agent loop renders
            # as a single waterfall with per-step critical-path blame
            trace_id=new_id(),
            root_span_id=new_id(),
        )
        # resolve the SLO class once and pin it as a run label (a caller
        # label override wins over the workflow default); every dispatched
        # JobRequest.priority reads it back
        slo = (run.labels.get(LABEL_SLO_CLASS) or wf.slo_class or "").upper()
        if slo in _PRIORITY_VALUES:
            run.labels[LABEL_SLO_CLASS] = slo
        self.metrics.workflow_runs.inc(status="STARTED")
        if idempotency_key:
            # persist the run shell BEFORE claiming the key: the loser of the
            # setnx race must always be able to read the winner's run
            await self.store.put_run(run)
            fresh, existing = await self.store.try_set_run_idempotency(idempotency_key, run_id)
            if not fresh:
                await self.store.delete_run(run_id)
                winner = await self.store.get_run(existing)
                if winner is not None:
                    return winner
        await self._timeline(run, "", "run_started", workflow_id)
        await self.schedule_ready(run, wf)
        await self._rollup_and_save(run, wf)
        return run

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _scope(self, run: WorkflowRun, item: Any = None, index: Optional[int] = None) -> dict:
        scope = {
            "input": run.context.get("input"),
            "ctx": run.context,
            "steps": run.context.get("steps", {}),
            "item": item,
        }
        if index is not None:
            scope["foreach_index"] = index
        return scope

    def _deps_satisfied(self, run: WorkflowRun, wf: Workflow, step: Step) -> bool:
        for dep in step.depends_on:
            sr = run.steps.get(dep)
            if sr is None:
                return False
            if sr.status in (M.SUCCEEDED, M.SKIPPED):
                continue
            dstep = wf.steps.get(dep)
            # continue-on-error: a FAILED dep still unblocks dependents
            if sr.status == M.FAILED and dstep and dstep.on_error == "continue":
                continue
            return False
        return True

    def _deps_failed(self, run: WorkflowRun, wf: Workflow, step: Step) -> bool:
        """A dep in a terminal failure state (not continue-on-error) means
        this step can never run."""
        for dep in step.depends_on:
            sr = run.steps.get(dep)
            if sr is None:
                return True
            dstep = wf.steps.get(dep)
            if sr.status in (M.FAILED, M.CANCELLED) and not (
                dstep and dstep.on_error == "continue"
            ):
                return True
        return False

    async def schedule_ready(self, run: WorkflowRun, wf: Optional[Workflow] = None) -> None:
        """One scheduling wave (reference scheduleReady, engine.go:453-827)."""
        if run.status in M.RUN_TERMINAL or run.status == M.WAITING_APPROVAL:
            return
        wf = wf or await self.store.get_workflow(run.workflow_id)
        if wf is None:
            return
        progress = True
        while progress:
            progress = False
            for sid, step in wf.steps.items():
                sr = run.steps.get(sid)
                if sr is None:
                    continue  # definition gained a step after this run started
                if sr.status != M.PENDING:
                    # for_each parents may need more children dispatched
                    if sr.status == M.RUNNING and step.for_each:
                        await self._dispatch_pending_children(run, wf, step, sr)
                    continue
                if self._deps_failed(run, wf, step):
                    sr.status = M.SKIPPED
                    sr.error = "dependency failed"
                    await self._timeline(run, sid, "step_skipped", "dependency failed")
                    progress = True
                    continue
                if not self._deps_satisfied(run, wf, step):
                    continue
                if step.condition and not truthy(evaluate(step.condition, self._scope(run))):
                    sr.status = M.SKIPPED
                    await self._timeline(run, sid, "step_skipped", "condition false")
                    progress = True
                    continue
                started = await self._start_step(run, wf, step, sr)
                progress = progress or started
                if run.status == M.WAITING_APPROVAL:
                    return  # approval pauses the wave

    async def _start_step(self, run: WorkflowRun, wf: Workflow, step: Step, sr: StepRun) -> bool:
        sid = step.id
        if step.type == "approval":
            sr.status = M.WAITING_APPROVAL
            run.status = M.WAITING_APPROVAL
            await self._timeline(run, sid, "approval_required", "")
            return True
        if step.type == "condition":
            value = truthy(evaluate(step.condition or str(step.input or ""), self._scope(run)))
            sr.status = M.SUCCEEDED
            sr.finished_at_us = now_us()
            self._inline_result(run, sid, {"value": value}, step)
            await self._timeline(run, sid, "condition_evaluated", str(value))
            return True
        if step.type == "delay":
            wake = self._delay_wake_us(step)
            if wake <= now_us():
                sr.status = M.SUCCEEDED
                sr.finished_at_us = now_us()
                await self._timeline(run, sid, "delay_elapsed", "")
            else:
                sr.status = M.WAITING
                sr.wake_at_us = wake
                await self._timeline(run, sid, "delay_started", str(wake))
            return True
        if step.type == "notify":
            msg = expand_templates(step.notify_message, self._scope(run))
            alert = SystemAlert(
                severity=step.notify_severity,
                source=f"workflow:{run.workflow_id}",
                message=str(msg),
                labels={"run_id": run.run_id, "step_id": sid},
            )
            await self.bus.publish(subj.WORKFLOW_EVENT, BusPacket.wrap(alert, sender_id=self.instance_id))
            sr.status = M.SUCCEEDED
            sr.finished_at_us = now_us()
            await self._timeline(run, sid, "notified", str(msg)[:120])
            return True
        if step.for_each:
            items = evaluate(step.for_each, self._scope(run))
            if not isinstance(items, list):
                sr.status = M.FAILED
                sr.error = f"for_each did not yield a list: {step.for_each!r}"
                await self._timeline(run, sid, "step_failed", sr.error)
                return True
            # pre-create all children, then dispatch up to max_parallel
            sr.children = {
                str(i): StepRun(step_id=child_key(sid, i)) for i in range(len(items))
            }
            sr.status = M.SUCCEEDED if not items else M.RUNNING
            sr.started_at_us = now_us()
            run.context.setdefault("_foreach_items", {})[sid] = items
            await self._timeline(run, sid, "fanout_started", f"{len(items)} children")
            await self._dispatch_pending_children(run, wf, step, sr)
            return True
        # plain job-dispatch step
        await self._dispatch_job(run, step, sr, key=sid, item=None, index=None)
        return True

    async def _dispatch_pending_children(
        self, run: WorkflowRun, wf: Workflow, step: Step, sr: StepRun
    ) -> None:
        items = (run.context.get("_foreach_items") or {}).get(step.id)
        if items is None:
            return
        active = sum(1 for c in sr.children.values() if c.status in (M.RUNNING, M.WAITING))
        limit = step.max_parallel or len(items)
        for i, item in enumerate(items):
            if active >= limit:
                break
            child = sr.children[str(i)]
            if child.status != M.PENDING:
                continue
            await self._dispatch_job(
                run, step, child, key=child_key(step.id, i), item=item, index=i
            )
            active += 1

    async def _dispatch_job(
        self,
        run: WorkflowRun,
        step: Step,
        sr: StepRun,
        *,
        key: str,
        item: Any,
        index: Optional[int],
    ) -> None:
        sr.attempts += 1
        sr.status = M.RUNNING
        sr.started_at_us = sr.started_at_us or now_us()
        job_id = make_job_id(run.run_id, key, sr.attempts)
        sr.job_id = job_id
        scope = self._scope(run, item=item, index=index)
        payload = expand_templates(step.input, scope)
        op = str(payload.get("op", "")) if isinstance(payload, dict) else ""
        if op in SERVING_OPS and not payload.get("session_id"):
            # agent-loop continuity: default the serving session to the
            # per-run key, so turn N of the loop prefills once and every
            # later turn routes (session affinity) to the worker already
            # holding the pages — no cold prefill across turns
            payload["session_id"] = run_session_key(run)
        if index is not None:
            payload = {"item": item, "foreach_index": index, "input": payload}
        if self.schemas is not None and step.input_schema_id:
            errs = await self.schemas.validate_id(step.input_schema_id, payload)
            if errs:
                sr.status = M.FAILED
                sr.error = f"input schema validation failed: {errs}"
                await self._timeline(run, key, "step_failed", sr.error)
                return
        if op in M.CONTEXT_STEP_OPS:
            # context.* steps execute in-engine against the ContextService;
            # the embeds inside still ride the worker pool (BusEmbedder) as
            # micro-batched jobs.  Completion feeds back through the normal
            # result path so run locking applies unchanged.
            await self.mem.put_context(job_id, payload)
            self._spawn_context_step(run, step, job_id, payload, key)
            self.metrics.workflow_steps.inc(topic=step.topic)
            await self._timeline(run, key, "step_dispatched", job_id)
            return
        req = await self._build_job_request(run, step, job_id, payload, index, op=op)
        # step-dispatch spans parent under the run's root span — the whole
        # run is ONE trace; scheduler/worker legs attach below via the
        # packet's span context
        async with self.tracer.span(
            "step-dispatch",
            trace_id=run.trace_id or new_id(),
            parent_span_id=run.root_span_id,
            attrs={"run_id": run.run_id, "step": key, "job_id": job_id},
        ) as sp:
            await self.mem.put_context(job_id, payload)
            await self.bus.publish(
                subj.SUBMIT,
                BusPacket.wrap(
                    req, trace_id=sp.trace_id, sender_id=self.instance_id,
                    span_id=sp.span_id,
                ),
            )
        self.metrics.workflow_steps.inc(topic=step.topic)
        await self._timeline(run, key, "step_dispatched", job_id)

    async def _build_job_request(
        self, run: WorkflowRun, step: Step, job_id: str, payload: Any,
        index: Optional[int], op: str = "",
    ) -> JobRequest:
        """Reference buildJobRequest (engine.go:1320-1415): step meta →
        JobMetadata, route labels, dry-run label, effective-config env —
        plus the gateway submit path's routing labels (op / session key) and
        the run's SLO class as the job priority."""
        labels = dict(step.route_labels)
        labels.update(run.labels)
        if run.dry_run:
            labels[LABEL_DRY_RUN] = "true"
        # mirror gateway _submit_one label stamping: consumers (throughput
        # matrix, session/batch affinity) never read the payload behind the
        # context pointer
        if op and LABEL_OP not in labels:
            labels[LABEL_OP] = op
        if op in SERVING_OPS and LABEL_SESSION_KEY not in labels:
            labels[LABEL_SESSION_KEY] = run_session_key(run)
        if op in SERVING_OPS and LABEL_BATCH_KEY not in labels:
            # template co-location (docs/SERVING.md §Prefix cache and
            # tiering): every run of one workflow template opens with the
            # same templated prompt, so batch affinity steers their first
            # turns onto one worker where the radix prefix cache turns the
            # shared prefill into a hit (later turns ride session affinity)
            labels[LABEL_BATCH_KEY] = f"wf-tpl:{run.workflow_id}"
        if op in BATCHABLE_OPS and LABEL_BATCH_KEY not in labels:
            labels[LABEL_BATCH_KEY] = op
        env: dict[str, str] = {}
        if index is not None:
            env["foreach_index"] = str(index)
        if self.configsvc is not None:
            snap = await self.configsvc.effective_snapshot(
                org=run.org_id, workflow=run.workflow_id
            )
            env[ENV_EFFECTIVE_CONFIG] = snap["config"]
        meta = None
        if step.meta:
            meta = JobMetadata(
                capability=str(step.meta.get("capability", "")),
                risk_tags=list(step.meta.get("risk_tags") or []),
                requires=list(step.meta.get("requires") or []),
                pack_id=str(step.meta.get("pack_id", "")),
            )
        slo = labels.get(LABEL_SLO_CLASS, "")
        return JobRequest(
            job_id=job_id,
            topic=step.topic,
            priority=slo if slo in _PRIORITY_VALUES else Priority.BATCH.value,
            context_ptr=f"kv://ctx:{job_id}",
            tenant_id=run.org_id,
            labels=labels,
            env=env,
            workflow_id=run.workflow_id,
            run_id=run.run_id,
            metadata=meta,
        )

    # ------------------------------------------------------------------
    # context.* steps (docs/WORKFLOWS.md §Context engine on the pool)
    # ------------------------------------------------------------------
    def _spawn_context_step(
        self, run: WorkflowRun, step: Step, job_id: str, payload: dict, key: str
    ) -> None:
        """Run a context.* step as a background task.  The task publishes a
        normal JobResult on ``sys.workflow.step.result`` when done, so the
        queue-group consumer applies it under the run lock exactly like a
        worker result (multi-replica safe) while the scheduler — which never
        saw these jobs — stays out of the loop; embedded/unit setups without
        a result consumer get the result applied directly."""
        task = asyncio.ensure_future(
            self._run_context_step(run, step, job_id, payload, key)
        )
        self._context_tasks.add(task)
        task.add_done_callback(self._context_tasks.discard)

    async def drain_context_steps(self) -> None:
        """Await in-flight context.* executor tasks (tests / benches)."""
        while self._context_tasks:
            await asyncio.gather(*list(self._context_tasks), return_exceptions=True)

    async def _run_context_step(
        self, run: WorkflowRun, step: Step, job_id: str, payload: dict, key: str
    ) -> None:
        res = JobResult(job_id=job_id, worker_id=self.instance_id)
        sp = self.tracer.begin(
            "context-execute",
            trace_id=run.trace_id,
            parent_span_id=run.root_span_id,
            attrs={"run_id": run.run_id, "step": key,
                   "op": str(payload.get("op", ""))},
        )
        t0 = time.monotonic()
        try:
            if self.context_svc is None:
                raise WorkflowError("no context service wired into this engine")
            coro = self._execute_context_op(run, payload)
            if step.timeout_sec > 0:
                output = await asyncio.wait_for(coro, step.timeout_sec)
            else:
                output = await coro
            res.result_ptr = await self.mem.put_result(job_id, output)
            res.status = JobState.SUCCEEDED.value
        except asyncio.TimeoutError:
            res.status = JobState.TIMEOUT.value
            res.error_code = "CONTEXT_TIMEOUT"
            res.error_message = f"context step exceeded {step.timeout_sec}s"
        except Exception as e:  # noqa: BLE001 - becomes a step failure
            res.status = JobState.FAILED.value
            res.error_code = "CONTEXT_STEP"
            res.error_message = str(e)
        res.execution_ms = int((time.monotonic() - t0) * 1000)
        ok = res.status == JobState.SUCCEEDED.value
        await self.tracer.finish(sp, status=SPAN_OK if ok else SPAN_ERROR)
        if self.bus.has_listener(subj.STEP_RESULT):
            await self.bus.publish(
                subj.STEP_RESULT,
                BusPacket.wrap(res, trace_id=run.trace_id,
                               sender_id=self.instance_id, span_id=sp.span_id),
            )
        else:
            await self.handle_job_result(res)

    async def _execute_context_op(self, run: WorkflowRun, payload: dict) -> Any:
        """``context.update`` appends chat events / (re-)indexes RAG chunks;
        ``context.window`` builds the model window.  The memory defaults to
        the run's session key so an agent loop reads the memory it wrote."""
        svc = self.context_svc
        op = str(payload.get("op", ""))
        memory_id = str(payload.get("memory_id") or run_session_key(run))
        if op == "context.update":
            await svc.update_memory(
                memory_id,
                user_payload=payload.get("user_payload"),
                model_response=str(payload.get("model_response", "")),
                mode=str(payload.get("mode", "CHAT")),
            )
            embedded = 0
            chunks = payload.get("chunks")
            if chunks:
                embedded = await svc.put_chunks(memory_id, list(chunks))
            if payload.get("summary"):
                await svc.set_summary(memory_id, str(payload["summary"]))
            return {"memory_id": memory_id, "updated": True, "embedded": embedded}
        if op == "context.window":
            msgs = await svc.build_window(
                memory_id,
                mode=str(payload.get("mode", "CHAT")),
                payload=payload.get("payload", payload.get("query")),
                max_input_tokens=int(payload.get("max_input_tokens", 0) or 4000),
            )
            return {
                "memory_id": memory_id,
                "messages": [m.to_dict() for m in msgs],
                "message_count": len(msgs),
            }
        raise WorkflowError(f"unknown context op {op!r}")

    @staticmethod
    def _delay_wake_us(step: Step) -> int:
        if step.delay_until:
            try:
                return int(float(step.delay_until) * 1e6)
            except ValueError:
                import datetime as dt

                t = dt.datetime.fromisoformat(step.delay_until.replace("Z", "+00:00"))
                return int(t.timestamp() * 1e6)
        return now_us() + int(step.delay_sec * 1e6)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    async def handle_job_result(self, res: JobResult) -> bool:
        """Apply a worker result to its run; returns True if it was a
        workflow job this engine advanced."""
        try:
            run_id, step_key, attempt = split_job_id(res.job_id)
        except ValueError:
            return False
        run = await self.store.get_run(run_id)
        if run is None:
            return False
        wf = await self.store.get_workflow(run.workflow_id)
        if wf is None:
            return False
        sid, child_idx = parse_child_key(step_key)
        step = wf.steps.get(sid)
        parent = run.steps.get(sid)
        if step is None or parent is None:
            return False
        sr = parent if child_idx is None else parent.children.get(str(child_idx))
        if sr is None:
            return False
        marker = f"{res.job_id}"
        if marker in sr.processed_results:
            return True  # duplicate result (redelivery) — already applied
        if attempt != sr.attempts:
            return True  # stale attempt
        if sr.status in M.STEP_TERMINAL:
            return True
        sr.processed_results.append(marker)
        sr.processed_results = sr.processed_results[-8:]  # bounded dedupe window

        status = res.status
        if status == JobState.SUCCEEDED.value:
            output = None
            if res.result_ptr:
                output = await self.mem.get_pointer(res.result_ptr)
            if self.schemas is not None and step.output_schema_id:
                errs = await self.schemas.validate_id(step.output_schema_id, output)
                if errs:
                    await self._apply_failure(run, step, sr, f"output schema: {errs}")
                    await self._after_result(run, wf, step, parent, sr)
                    return True
            sr.status = M.SUCCEEDED
            sr.finished_at_us = now_us()
            if child_idx is None:
                self._inline_result(run, sid, output, step)
            else:
                self._inline_child_result(run, sid, child_idx, output)
            await self._timeline(run, step_key, "step_succeeded", res.job_id)
        elif status in (JobState.FAILED.value, JobState.TIMEOUT.value):
            await self._apply_failure(run, step, sr, res.error_message or status)
        elif status == JobState.CANCELLED.value:
            sr.status = M.CANCELLED
            sr.finished_at_us = now_us()
            await self._timeline(run, step_key, "step_cancelled", res.job_id)
        elif status == JobState.DENIED.value:
            sr.status = M.FAILED
            sr.error = f"denied: {res.error_message}"
            sr.finished_at_us = now_us()
            await self._timeline(run, step_key, "step_denied", res.error_message)
        else:
            return True  # non-terminal hint

        if sr.status in M.STEP_TERMINAL and sr.started_at_us:
            # wall-clock step latency (dispatch → terminal result), with the
            # run trace as exemplar so a slow bucket resolves to a waterfall
            self.metrics.workflow_step_seconds.observe(
                max(0.0, ((sr.finished_at_us or now_us()) - sr.started_at_us) / 1e6),
                exemplar=run.trace_id, topic=step.topic,
            )
        await self._after_result(run, wf, step, parent, sr)
        return True

    async def _apply_failure(self, run: WorkflowRun, step: Step, sr: StepRun, err: str) -> None:
        """Retry with exponential backoff or mark FAILED (reference
        applyResult/shouldRetry/computeBackoff, engine.go:1524-1595)."""
        retry = step.retry
        if retry and sr.attempts <= retry.max_retries:
            backoff = min(
                retry.backoff_sec * (retry.multiplier ** (sr.attempts - 1)),
                retry.max_backoff_sec,
            )
            sr.status = M.WAITING
            sr.error = err
            sr.next_retry_at_us = now_us() + int(backoff * 1e6)
            await self._timeline(
                run, sr.step_id, "step_retry_scheduled", f"attempt {sr.attempts} failed: {err}"
            )
        else:
            sr.status = M.FAILED
            sr.error = err
            sr.finished_at_us = now_us()
            await self._timeline(run, sr.step_id, "step_failed", err)

    async def _after_result(
        self, run: WorkflowRun, wf: Workflow, step: Step, parent: StepRun, sr: StepRun
    ) -> None:
        if sr is not parent:
            self._aggregate_children(run, step, parent)
            if parent.status == M.RUNNING:
                await self._dispatch_pending_children(run, wf, step, parent)
        await self.schedule_ready(run, wf)
        await self._rollup_and_save(run, wf)

    def _aggregate_children(self, run: WorkflowRun, step: Step, parent: StepRun) -> None:
        """Reference aggregateChildren (engine.go:1623-1645)."""
        children = parent.children.values()
        if any(c.status in (M.PENDING, M.RUNNING, M.WAITING) for c in children):
            return
        failed = [c for c in children if c.status in (M.FAILED, M.CANCELLED)]
        parent.finished_at_us = now_us()
        if failed and step.on_error != "continue":
            parent.status = M.FAILED
            parent.error = f"{len(failed)} child step(s) failed"
        else:
            parent.status = M.SUCCEEDED
            outputs = (run.context.get("steps", {}).get(step.id) or {}).get("children", [])
            self._inline_result(run, step.id, {"children": outputs, "count": len(parent.children)}, step)

    def _inline_result(self, run: WorkflowRun, step_id: str, output: Any, step: Step) -> None:
        """Inline result ≤256KiB into run context steps.<id> + output_path."""
        try:
            size = len(json.dumps(output)) if output is not None else 0
        except (TypeError, ValueError):
            output, size = {"unserializable": True}, 0
        if size > MAX_INLINE_RESULT_BYTES:
            output = {"truncated": True, "bytes": size}
        steps_ctx = run.context.setdefault("steps", {})
        prior = steps_ctx.get(step_id)
        if isinstance(prior, dict) and isinstance(output, dict) and "children" in prior and "children" in output:
            pass  # aggregation result replaces child list wholesale
        steps_ctx[step_id] = output
        if step.output_path:
            set_path(run.context, step.output_path, output)

    def _inline_child_result(self, run: WorkflowRun, step_id: str, index: int, output: Any) -> None:
        steps_ctx = run.context.setdefault("steps", {})
        slot = steps_ctx.setdefault(step_id, {})
        if not isinstance(slot, dict) or "children" not in slot:
            slot = {"children": []}
            steps_ctx[step_id] = slot
        children = slot["children"]
        while len(children) <= index:
            children.append(None)
        try:
            if output is not None and len(json.dumps(output)) > MAX_INLINE_RESULT_BYTES:
                output = {"truncated": True}
        except (TypeError, ValueError):
            output = {"unserializable": True}
        children[index] = output

    # ------------------------------------------------------------------
    # rollup
    # ------------------------------------------------------------------
    async def _rollup_and_save(self, run: WorkflowRun, wf: Workflow) -> None:
        was_terminal = run.status in M.RUN_TERMINAL
        self._update_run_status(run, wf)
        if run.status in M.RUN_TERMINAL and not was_terminal:
            await self._finish_run(run)
        await self.store.put_run(run)

    async def _finish_run(self, run: WorkflowRun) -> None:
        """The run just went terminal: count it and emit the run-root span
        (explicit start = run creation), closing the one-trace-per-run
        waterfall every step-dispatch/execute span parented under."""
        self.metrics.workflow_runs.inc(status=run.status)
        if run.trace_id and run.root_span_id:
            await self.tracer.emit(
                Span(
                    span_id=run.root_span_id,
                    trace_id=run.trace_id,
                    name="workflow-run",
                    service="workflow-engine",
                    start_us=run.created_at_us,
                    end_us=run.finished_at_us or now_us(),
                    attrs={
                        "run_id": run.run_id,
                        "workflow_id": run.workflow_id,
                        "status": run.status,
                    },
                )
            )

    def _update_run_status(self, run: WorkflowRun, wf: Workflow) -> None:
        """Reference updateRunStatus (engine.go:1647-1699)."""
        if run.status in M.RUN_TERMINAL:
            return
        statuses = {sid: sr.status for sid, sr in run.steps.items()}
        hard_failed = [
            sid
            for sid, st in statuses.items()
            if st == M.FAILED and wf.steps.get(sid) and wf.steps[sid].on_error != "continue"
        ]
        if hard_failed:
            run.status = M.FAILED
            run.error = f"step(s) failed: {', '.join(sorted(hard_failed))}"
            run.finished_at_us = now_us()
            return
        if any(st == M.CANCELLED for st in statuses.values()):
            run.status = M.CANCELLED
            run.finished_at_us = now_us()
            return
        if any(sr.status == M.WAITING_APPROVAL for sr in run.steps.values()):
            run.status = M.WAITING_APPROVAL
            return
        if all(st in M.STEP_TERMINAL for st in statuses.values()):
            run.status = M.SUCCEEDED
            run.finished_at_us = now_us()
            return
        if any(
            sr.status == M.WAITING and (sr.wake_at_us or sr.next_retry_at_us)
            for sr in run.steps.values()
        ):
            run.status = M.WAITING
            return
        run.status = M.RUNNING

    # ------------------------------------------------------------------
    # approvals / cancel / resume
    # ------------------------------------------------------------------
    async def approve_step(
        self, run_id: str, step_id: str, *, approve: bool, approved_by: str = ""
    ) -> WorkflowRun:
        run = await self.store.get_run(run_id)
        if run is None:
            raise WorkflowError(f"unknown run {run_id!r}")
        sr = run.steps.get(step_id)
        if sr is None or sr.status != M.WAITING_APPROVAL:
            raise WorkflowError(f"step {step_id!r} is not awaiting approval")
        wf = await self.store.get_workflow(run.workflow_id)
        sr.finished_at_us = now_us()
        run.status = M.RUNNING  # un-park so the scheduling wave can settle deps
        if approve:
            sr.status = M.SUCCEEDED
            await self._timeline(run, step_id, "approved", approved_by)
        else:
            sr.status = M.FAILED
            sr.error = f"rejected by {approved_by or 'admin'}"
            await self._timeline(run, step_id, "rejected", approved_by)
        await self.schedule_ready(run, wf)
        await self._rollup_and_save(run, wf)
        return run

    async def cancel_run(self, run_id: str, *, reason: str = "") -> WorkflowRun:
        run = await self.store.get_run(run_id)
        if run is None:
            raise WorkflowError(f"unknown run {run_id!r}")
        if run.status in M.RUN_TERMINAL:
            return run
        wf = await self.store.get_workflow(run.workflow_id)
        for sid, sr in run.steps.items():
            for target in [sr, *sr.children.values()]:
                if target.status in (M.RUNNING,) and target.job_id:
                    await self.bus.publish(
                        subj.CANCEL,
                        BusPacket.wrap(
                            JobCancel(job_id=target.job_id, reason=reason or "run cancelled"),
                            sender_id=self.instance_id,
                        ),
                    )
                if target.status not in M.STEP_TERMINAL:
                    target.status = M.CANCELLED
                    target.finished_at_us = now_us()
        run.status = M.CANCELLED
        run.error = reason
        run.finished_at_us = now_us()
        await self._finish_run(run)
        await self._timeline(run, "", "run_cancelled", reason)
        await self.store.put_run(run)
        return run

    async def rerun_from(
        self, run_id: str, step_id: str, *, dry_run: bool = False
    ) -> WorkflowRun:
        """New run seeded from an existing one, with ``step_id`` and its
        dependent closure reset (reference RerunFrom, engine.go:85-151)."""
        src = await self.store.get_run(run_id)
        if src is None:
            raise WorkflowError(f"unknown run {run_id!r}")
        wf = await self.store.get_workflow(src.workflow_id)
        if wf is None or step_id not in wf.steps:
            raise WorkflowError(f"unknown step {step_id!r}")
        closure = self._dependent_closure(wf, step_id)
        run = WorkflowRun(
            run_id=new_id(),
            workflow_id=src.workflow_id,
            org_id=src.org_id,
            status=M.RUNNING,
            input=src.input,
            context=json.loads(json.dumps(src.context)),
            created_at_us=now_us(),
            dry_run=dry_run,
            labels=dict(src.labels),
            # a rerun is a fresh trace: the re-executed closure renders as
            # its own waterfall, linked back via the rerun_from timeline row
            trace_id=new_id(),
            root_span_id=new_id(),
        )
        for sid in wf.steps:
            if sid in closure:
                run.steps[sid] = StepRun(step_id=sid)
                run.context.get("steps", {}).pop(sid, None)
            else:
                run.steps[sid] = StepRun.from_dict(src.steps[sid].to_dict())
        await self._timeline(run, step_id, "rerun_from", run_id)
        await self.schedule_ready(run, wf)
        await self._rollup_and_save(run, wf)
        return run

    @staticmethod
    def _dependent_closure(wf: Workflow, step_id: str) -> set[str]:
        closure = {step_id}
        changed = True
        while changed:
            changed = False
            for sid, step in wf.steps.items():
                if sid not in closure and any(d in closure for d in step.depends_on):
                    closure.add(sid)
                    changed = True
        return closure

    async def resume_due(self, run_id: str) -> bool:
        """Wake delay steps whose time has come and re-dispatch parked
        retries (called by the reconciler).  Returns True if progressed."""
        run = await self.store.get_run(run_id)
        if run is None or run.status in M.RUN_TERMINAL:
            return False
        wf = await self.store.get_workflow(run.workflow_id)
        if wf is None:
            return False
        now = now_us()
        progressed = False
        for sid, sr in run.steps.items():
            step = wf.steps.get(sid)
            if step is None:
                continue  # definition lost this step after the run started
            targets = [sr, *sr.children.values()]
            for t in targets:
                if t.status != M.WAITING:
                    continue
                if t.wake_at_us and t.wake_at_us <= now:
                    t.status = M.SUCCEEDED
                    t.finished_at_us = now
                    await self._timeline(run, t.step_id, "delay_elapsed", "")
                    progressed = True
                elif t.next_retry_at_us and t.next_retry_at_us <= now:
                    t.next_retry_at_us = 0
                    sid_key, idx = parse_child_key(t.step_id)
                    items = (run.context.get("_foreach_items") or {}).get(sid_key)
                    item = items[idx] if (items is not None and idx is not None) else None
                    await self._dispatch_job(
                        run, step, t, key=t.step_id, item=item, index=idx
                    )
                    progressed = True
        if progressed:
            await self.schedule_ready(run, wf)
            await self._rollup_and_save(run, wf)
        return progressed

    # ------------------------------------------------------------------
    async def _timeline(self, run: WorkflowRun, step_id: str, event: str, detail: str) -> None:
        await self.store.append_timeline(
            TimelineEvent(run_id=run.run_id, step_id=step_id, event=event, detail=str(detail))
        )
