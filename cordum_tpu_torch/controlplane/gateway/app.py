"""API gateway: the HTTP/WS surface of the control plane.

Recreates the reference gateway's API (``core/controlplane/gateway/
gateway.go``, 4373 LoC — route table :701-805) on aiohttp:

  jobs            POST/GET/list/cancel/remediate, trace reader
  approvals       list / approve / reject with job-hash + snapshot binding
  workflows       CRUD + run start (Idempotency-Key header, max-concurrent
                  guard) / cancel / rerun / step-approve / timeline
  DLQ             list / get / delete / retry-with-new-job-id
  policy          evaluate / simulate / explain / snapshots
  config          scoped get/set + effective view
  schemas         CRUD
  locks           list / acquire / release
  artifacts       put / get
  memory          pointer reader (``?ptr=kv://...``)
  workers         live registry snapshot
  status/healthz  bus+kv health;  /metrics Prometheus text
  /api/v1/stream  WebSocket event stream (bus tap broadcast)

Bus taps (reference gateway.go:531-650): heartbeats → worker map, DLQ tap →
DLQStore, ``sys.job.>`` + workflow events → WS broadcast.
"""
from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any, Optional

from aiohttp import WSMsgType, web

from ...infra import logging as logx
from ...infra.artifacts import ArtifactStore
from ...infra.bus import Bus
from ...infra.configsvc import ConfigService
from ...infra.dlq import DLQEntry, DLQStore
from ...infra.jobstore import ApprovalRecord, JobStore
from ...infra.kv import KV
from ...infra.locks import LockStore
from ...infra.memstore import MemoryStore
from ...infra.metrics import Metrics
from ...infra.registry import WorkerRegistry
from ...infra.schemareg import SchemaError, SchemaRegistry
from ...infra.secrets import contains_secret_refs
from ...obs.assembler import aggregate_critical_paths, assemble
from ...obs.collector import SpanCollector
from ...obs.fleet import FleetAggregator
from ...obs.profiler import RuntimeProfiler
from ...obs.slo import SLOTracker
from ...obs.telemetry import TelemetryExporter
from ...obs.tracer import Tracer
from ...protocol import subjects as subj
from ...protocol.jobhash import job_hash
from ...protocol.partition import partition_of
from ...protocol.types import (
    Budget,
    BusPacket,
    ContextHints,
    JobCancel,
    JobMetadata,
    JobRequest,
    JobState,
    LABEL_APPROVAL_GRANTED,
    LABEL_BATCH_KEY,
    LABEL_BUS_MSG_ID,
    LABEL_GANG_CHIPS,
    LABEL_GANG_KIND,
    LABEL_GANG_WORKERS,
    LABEL_OP,
    LABEL_SECRETS_PRESENT,
    LABEL_SESSION_KEY,
    LABEL_SLO_CLASS,
    PolicyCheckRequest,
    TERMINAL_STATES,
    WorkerDrain,
    payload_batch_key,
    payload_gang,
    payload_session_key,
)
from ...utils.ids import new_id, now_us
from ...workflow.engine import Engine as WorkflowEngine, WorkflowError
from ...workflow.models import Workflow
from ...workflow.store import WorkflowStore
from ..safetykernel.kernel import SafetyKernel
from .admission import AdmissionController
from .auth import AuthProvider, BasicAuthProvider, Principal, TokenBucket

MAX_BODY_BYTES = 2 * 1024 * 1024  # 2 MiB submit cap (reference gateway.go:1757)
MAX_BULK_JOBS = 256  # jobs per POST /api/v1/jobs:batch


def _err(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _retry_after_headers(status: int, doc: dict) -> Optional[dict[str, str]]:
    """429 responses carry an honest Retry-After so SDK clients back off
    instead of retrying immediately (docs/ADMISSION.md)."""
    if status != 429:
        return None
    retry = float(doc.get("retry_after_s") or 0.25)
    return {"Retry-After": f"{retry:.3f}"}


class Gateway:
    def __init__(
        self,
        *,
        kv: KV,
        bus: Bus,
        job_store: JobStore,
        mem: MemoryStore,
        kernel: SafetyKernel,
        wf_store: WorkflowStore,
        wf_engine: WorkflowEngine,
        schemas: Optional[SchemaRegistry] = None,
        configsvc: Optional[ConfigService] = None,
        registry: Optional[WorkerRegistry] = None,
        context_svc: Optional[Any] = None,
        auth: Optional[AuthProvider] = None,
        metrics: Optional[Metrics] = None,
        rate_rps: float = 0.0,
        max_concurrent_runs: int = 0,
        ws_allowed_origins: Optional[list[str]] = None,
        instance_id: str = "gateway-0",
        scheduler_shards: int = 1,
        slo_config: Optional[dict] = None,
        admission_config: Optional[dict] = None,
        telemetry: bool = True,
        trace_keep_fraction: float = 1.0,
    ):
        self.kv = kv
        self.bus = bus
        self.job_store = job_store
        self.mem = mem
        self.kernel = kernel
        self.wf_store = wf_store
        self.wf_engine = wf_engine
        self.schemas = schemas or SchemaRegistry(kv)
        self.configsvc = configsvc
        self.registry = registry
        self.context_svc = context_svc
        self.dlq = DLQStore(kv)
        self.locks = LockStore(kv)
        self.artifacts = ArtifactStore(kv)
        self.auth = auth or BasicAuthProvider()
        self.metrics = metrics or Metrics()
        self.tracer = Tracer("gateway", bus)
        # the gateway hosts the deployment's span collector: it owns /metrics
        # (stage histograms land there) and serves the trace API from the
        # same KV the collector writes.  trace_keep_fraction < 1.0 turns on
        # tail-based retention: every slower-than-rolling-p95 trace is kept,
        # the fast rest is sampled (docs/OBSERVABILITY.md §Capacity
        # observatory)
        self.span_collector = SpanCollector(
            kv, bus, metrics=self.metrics,
            tail_keep_fraction=trace_keep_fraction,
        )
        # ... and the fleet telemetry plane: the aggregator merges
        # every process's sys.telemetry.<service> snapshots into the fleet
        # view (/api/v1/fleet, /metrics?scope=fleet, cordumctl top); the SLO
        # tracker burns the pools.yaml slo: objectives against it; the
        # gateway exports its own registry + runs the runtime profiler like
        # any other process
        self.fleet = FleetAggregator(bus, metrics=self.metrics)
        self.slo_tracker = SLOTracker.from_config(
            slo_config or {}, metrics=self.metrics
        )
        self.profiler = RuntimeProfiler(self.metrics, service="gateway")
        # overload resilience (docs/ADMISSION.md): the admission controller
        # sheds analytically against the capacity matrix + SLO burn rates
        # the aggregator/tracker above already maintain, and beacons
        # pressure to the scheduler's preemption governor.  No admission:
        # stanza → disabled (pure pass-through).
        self.admission = AdmissionController(
            fleet=self.fleet, slo_tracker=self.slo_tracker,
            config=admission_config, metrics=self.metrics, bus=bus,
            instance_id=instance_id,
        )
        self._admission_task: Optional[asyncio.Task] = None
        self._telemetry_enabled = telemetry
        self.telemetry = TelemetryExporter(
            "gateway", bus, self.metrics, instance_id=instance_id,
            health_fn=self._telemetry_health,
        )
        self.rate = TokenBucket(rate_rps)
        self.max_concurrent_runs = max_concurrent_runs
        self.ws_allowed_origins = ws_allowed_origins
        self.instance_id = instance_id
        # keyspace-sharded scheduler: the gateway stamps the partition at
        # submit time by publishing straight to the owner shard's subject
        # (sys.job.submit.<p>); 1 = unsharded plain subjects
        self.scheduler_shards = max(1, scheduler_shards)
        self._ws_clients: set[web.WebSocketResponse] = set()
        self._subs: list = []
        self._runner: Optional[web.AppRunner] = None
        self.app = self._build_app()

    # ------------------------------------------------------------------
    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=MAX_BODY_BYTES, middlewares=[self._middleware])
        r = app.router
        v1 = "/api/v1"
        r.add_post(f"{v1}/jobs", self.submit_job)
        # bulk submit: many jobs, one HTTP round trip (micro-batching's
        # client-side leg — amortizes per-job HTTP+bus overhead)
        r.add_post(f"{v1}/jobs:batch", self.submit_jobs_bulk)
        r.add_get(f"{v1}/jobs", self.list_jobs)
        r.add_get(f"{v1}/jobs/{{job_id}}", self.get_job)
        r.add_post(f"{v1}/jobs/{{job_id}}/cancel", self.cancel_job)
        r.add_post(f"{v1}/jobs/{{job_id}}/remediate", self.remediate_job)
        r.add_get(f"{v1}/approvals", self.list_approvals)
        r.add_post(f"{v1}/approvals/{{job_id}}/approve", self.approve_job)
        r.add_post(f"{v1}/approvals/{{job_id}}/reject", self.reject_job)
        r.add_post(f"{v1}/workflows", self.put_workflow)
        r.add_get(f"{v1}/workflows", self.list_workflows)
        r.add_get(f"{v1}/workflows/{{wf_id}}", self.get_workflow)
        r.add_delete(f"{v1}/workflows/{{wf_id}}", self.delete_workflow)
        r.add_post(f"{v1}/workflows/{{wf_id}}/runs", self.start_run)
        r.add_get(f"{v1}/runs", self.list_runs)
        r.add_get(f"{v1}/runs/{{run_id}}", self.get_run)
        r.add_post(f"{v1}/runs/{{run_id}}/cancel", self.cancel_run)
        r.add_post(f"{v1}/runs/{{run_id}}/rerun", self.rerun)
        r.add_post(f"{v1}/runs/{{run_id}}/steps/{{step_id}}/approve", self.approve_step)
        r.add_get(f"{v1}/runs/{{run_id}}/timeline", self.run_timeline)
        r.add_get(f"{v1}/dlq", self.list_dlq)
        r.add_post(f"{v1}/dlq/retry-all", self.retry_all_dlq)
        r.add_post(f"{v1}/dlq/purge", self.purge_dlq)
        r.add_delete(f"{v1}/dlq/{{job_id}}", self.delete_dlq)
        r.add_post(f"{v1}/dlq/{{job_id}}/retry", self.retry_dlq)
        r.add_post(f"{v1}/policy/evaluate", self.policy_evaluate)
        r.add_post(f"{v1}/policy/simulate", self.policy_simulate)
        r.add_post(f"{v1}/policy/explain", self.policy_explain)
        r.add_get(f"{v1}/policy/snapshots", self.policy_snapshots)
        r.add_get(f"{v1}/policy/bundles", self.bundles_list)
        r.add_get(f"{v1}/policy/bundles/{{bundle_id}}", self.bundles_get)
        r.add_put(f"{v1}/policy/bundles/{{bundle_id}}", self.bundles_put)
        r.add_delete(f"{v1}/policy/bundles/{{bundle_id}}", self.bundles_delete)
        r.add_post(f"{v1}/policy/bundles/{{bundle_id}}/publish", self.bundles_publish)
        r.add_post(f"{v1}/policy/bundles/{{bundle_id}}/unpublish", self.bundles_unpublish)
        r.add_post(f"{v1}/policy/bundles/{{bundle_id}}/simulate", self.bundles_simulate)
        r.add_post(f"{v1}/policy/snapshots/capture", self.snapshots_capture)
        r.add_get(f"{v1}/policy/snapshots/captured", self.snapshots_captured)
        r.add_post(f"{v1}/policy/snapshots/{{snapshot_id}}/rollback", self.snapshots_rollback)
        r.add_get(f"{v1}/policy/audit", self.policy_audit)
        r.add_post(f"{v1}/packs", self.install_pack)
        r.add_get(f"{v1}/packs", self.list_packs)
        r.add_get(f"{v1}/packs/{{pack_id}}", self.show_pack)
        r.add_delete(f"{v1}/packs/{{pack_id}}", self.uninstall_pack)
        r.add_get(f"{v1}/pack-catalogs", self.list_catalogs)
        r.add_post(f"{v1}/pack-catalogs", self.add_catalog)
        r.add_get(f"{v1}/pack-catalogs/{{catalog}}/packs", self.catalog_packs)
        r.add_post(f"{v1}/pack-catalogs/{{catalog}}/install/{{pack_id}}", self.catalog_install)
        r.add_get(f"{v1}/config/effective", self.config_effective)
        r.add_get(f"{v1}/config/{{scope}}/{{doc_id:.+}}", self.config_get)
        r.add_put(f"{v1}/config/{{scope}}/{{doc_id:.+}}", self.config_set)
        r.add_get(f"{v1}/schemas", self.list_schemas)
        r.add_get(f"{v1}/schemas/{{schema_id}}", self.get_schema)
        r.add_put(f"{v1}/schemas/{{schema_id}}", self.put_schema)
        r.add_delete(f"{v1}/schemas/{{schema_id}}", self.delete_schema)
        r.add_get(f"{v1}/locks", self.list_locks)
        r.add_post(f"{v1}/locks/{{resource}}/acquire", self.acquire_lock)
        r.add_post(f"{v1}/locks/{{resource}}/release", self.release_lock)
        r.add_post(f"{v1}/artifacts", self.put_artifact)
        r.add_get(f"{v1}/artifacts/{{artifact_id}}", self.get_artifact)
        r.add_get(f"{v1}/memory", self.read_pointer)
        r.add_post(f"{v1}/context/window", self.context_window)
        r.add_post(f"{v1}/context/memory/{{memory_id}}", self.context_update)
        r.add_put(f"{v1}/context/chunks/{{memory_id}}", self.context_chunks)
        r.add_get(f"{v1}/traces", self.list_traces)
        # literal route must register before the {trace_id} wildcard or
        # "analysis" would be read as a trace id
        r.add_get(f"{v1}/traces/analysis", self.traces_analysis)
        r.add_get(f"{v1}/traces/{{trace_id}}", self.get_trace)
        r.add_get(f"{v1}/fleet", self.get_fleet)
        r.add_get(f"{v1}/capacity", self.get_capacity)
        r.add_get(f"{v1}/gangs", self.get_gangs)
        r.add_get(f"{v1}/admission", self.get_admission)
        r.add_get(f"{v1}/workers", self.get_workers)
        r.add_post(f"{v1}/workers/{{worker_id}}/drain", self.drain_worker)
        r.add_get(f"{v1}/status", self.get_status)
        r.add_get(f"{v1}/stream", self.ws_stream)
        r.add_get("/healthz", self.healthz)
        r.add_get("/metrics", self.get_metrics)
        # operations dashboard (reference dashboard/ React app → served-static
        # SPA here; same /api/v1 + WS surface underneath)
        dash = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dashboard")
        if os.path.isdir(dash):
            r.add_get("/", self._dash_index)
            r.add_get("/ui", self._dash_index)
            r.add_get("/ui/", self._dash_index)
            r.add_static("/ui/", dash)
        return app

    async def _dash_index(self, request: web.Request) -> web.Response:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "dashboard", "index.html")
        return web.FileResponse(path)

    @web.middleware
    async def _middleware(self, request: web.Request, handler):
        t0 = time.perf_counter()
        if not self.rate.allow(request.headers.get("X-Api-Key", request.remote or "")):
            # honest Retry-After: one token accrues in 1/rps seconds
            retry = max(0.25, 1.0 / self.rate.rps) if self.rate.rps > 0 else 1.0
            self.metrics.gateway_shed.inc(reason="rate_limit", job_class="unknown")
            return web.json_response(
                {"error": "rate limited", "retry_after_s": round(retry, 3)},
                status=429, headers={"Retry-After": f"{retry:.3f}"},
            )
        if request.path in ("/healthz", "/metrics", "/") or request.path.startswith("/ui"):
            request["principal"] = Principal()
            return await handler(request)
        headers = request.headers
        if (
            request.path.endswith("/stream")
            and "X-Api-Key" not in headers
            and "Authorization" not in headers  # Bearer clients keep working
        ):
            # browsers can't set arbitrary WS headers; accept the API key as
            # the first Sec-WebSocket-Protocol token (reference gateway.go:2002)
            proto = headers.get("Sec-WebSocket-Protocol", "")
            key = proto.split(",")[0].strip()
            if key:
                from multidict import CIMultiDict

                # CIMultiDict copy: case-insensitive lookups (x-tenant-id
                # etc.) must keep working on the overlaid header map
                overlaid = CIMultiDict(headers)
                overlaid["X-Api-Key"] = key
                headers = overlaid
        principal = self.auth.authenticate(headers)
        if principal is None:
            return _err(401, "invalid API key")
        request["principal"] = principal
        try:
            resp = await handler(request)
        except web.HTTPException:
            raise
        except WorkflowError as e:
            resp = _err(400, str(e))
        except SchemaError as e:
            resp = _err(400, str(e))
        except Exception as e:  # noqa: BLE001
            logx.error("gateway handler error", path=request.path, err=str(e))
            resp = _err(500, "internal error")
        self.metrics.http_requests.inc(method=request.method, path=request.match_info.route.resource.canonical if request.match_info.route.resource else request.path, status=str(resp.status))
        self.metrics.http_latency.observe(time.perf_counter() - t0)
        return resp

    # ------------------------------------------------------------------
    # lifecycle + bus taps
    # ------------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 8081) -> None:
        self._subs.append(await self.bus.subscribe(subj.DLQ, self._tap_dlq))
        self._subs.append(await self.bus.subscribe(subj.JOB_EVENTS_WILDCARD, self._tap_events))
        self._subs.append(await self.bus.subscribe(subj.WORKFLOW_EVENT, self._tap_events))
        await self.span_collector.start()
        if self._telemetry_enabled:
            await self.fleet.start()
            await self.telemetry.start()
            await self.profiler.start()
        if self.admission.enabled and self._admission_task is None:
            self._admission_task = asyncio.ensure_future(self._admission_loop())
        if self.registry is not None:
            self._subs.append(await self.bus.subscribe(subj.HEARTBEAT, self._tap_heartbeat))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        logx.info("gateway listening", host=host, port=port)

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        if self._admission_task is not None:
            task, self._admission_task = self._admission_task, None
            task.cancel()
            await logx.join_task(task, name="admission-refresh")
        if self._telemetry_enabled:
            await self.profiler.stop()
            await self.telemetry.stop()
            await self.fleet.stop()
        await self.span_collector.stop()
        for ws in list(self._ws_clients):
            await ws.close()
        if self._runner:
            await self._runner.cleanup()
            self._runner = None

    async def _admission_loop(self) -> None:
        """Periodic admission refresh: rolls offered rates, re-reads the
        capacity matrix + SLO burn states, and beacons pressure to the
        scheduler's preemption governor (docs/ADMISSION.md)."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self.admission.refresh()
                await self.admission.publish_pressure()
            except Exception as e:  # noqa: BLE001 - refresh must never die silently
                logx.warn("admission refresh failed", err=str(e))

    async def _tap_heartbeat(self, subject: str, pkt: BusPacket) -> None:
        if pkt.heartbeat and self.registry is not None:
            self.registry.update(pkt.heartbeat)

    async def _tap_dlq(self, subject: str, pkt: BusPacket) -> None:
        res = pkt.job_result
        if res is None:
            return
        await self.dlq.add(
            DLQEntry(
                job_id=res.job_id,
                topic=res.labels.get("topic", ""),
                status=res.status,
                reason=res.error_message,
                reason_code=res.error_code,
                last_state=res.status,
                tenant_id=res.labels.get("tenant_id", ""),
            )
        )
        # synthesize a result payload for UI reads (reference gateway.go:553-607)
        if not res.result_ptr:
            await self.mem.put_result(
                res.job_id, {"error": res.error_message, "code": res.error_code}
            )

    async def _tap_events(self, subject: str, pkt: BusPacket) -> None:
        if not self._ws_clients:
            return
        event = json.dumps({"subject": subject, "packet": pkt.to_dict()}, default=str)
        dead = []
        for ws in list(self._ws_clients):  # set mutates during awaits
            try:
                await ws.send_str(event)
            except Exception:
                dead.append(ws)
        for ws in dead:
            self._ws_clients.discard(ws)

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------
    async def submit_job(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        try:
            body = await request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        status, doc = await self._submit_one(
            body, principal,
            idempotency_header=request.headers.get("Idempotency-Key", ""),
        )
        return web.json_response(doc, status=status,
                                 headers=_retry_after_headers(status, doc))

    async def submit_jobs_bulk(self, request: web.Request) -> web.Response:
        """``POST /api/v1/jobs:batch`` — submit many jobs in one round trip
        (body ``{"jobs": [<single-submit bodies>]}``).  Per-job verdicts ride
        back positionally; one bad job does not reject its batch-mates."""
        principal: Principal = request["principal"]
        try:
            body = await request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        jobs = body.get("jobs")
        if not isinstance(jobs, list) or not jobs:
            return _err(400, "jobs: non-empty list required")
        if len(jobs) > MAX_BULK_JOBS:
            return _err(400, f"too many jobs in one batch (max {MAX_BULK_JOBS})")
        out: list[dict[str, Any]] = []
        accepted = 0
        retry_after = 0.0
        for doc in jobs:
            if not isinstance(doc, dict):
                out.append({"error": "job body must be an object", "status": 400})
                continue
            status, res = await self._submit_one(doc, principal)
            if status >= 400:
                entry = {"error": str(res.get("error", "rejected")), "status": status}
                if status == 429:
                    entry["retry_after_s"] = res.get("retry_after_s", 0.0)
                    retry_after = max(
                        retry_after, float(res.get("retry_after_s") or 0.0))
                out.append(entry)
            else:
                accepted += 1
                out.append(res)
        headers = (
            {"Retry-After": f"{retry_after:.3f}"} if retry_after > 0 else None
        )
        return web.json_response(
            {"jobs": out, "accepted": accepted, "rejected": len(out) - accepted},
            status=202 if accepted else 400, headers=headers,
        )

    async def _submit_one(
        self, body: dict, principal: Principal, *, idempotency_header: str = ""
    ) -> tuple[int, dict]:
        """The submit core shared by the single and bulk routes: validate,
        stamp labels (secrets, batch key), persist, publish.  Returns
        (http_status, response_doc)."""
        topic = str(body.get("topic", ""))
        if not topic:
            return 400, {"error": "topic is required"}
        payload = body.get("payload", body.get("context"))
        tenant = str(body.get("tenant_id") or principal.tenant_id)
        if tenant != principal.tenant_id and not principal.key_admin:
            # body tenant_id may not escape the key's tenant scope; gate on
            # key-derived admin status, not the forgeable role header
            # (reference RequireTenantAccess, basic_auth.go:100-122)
            return 403, {"error": f"tenant {tenant!r} not permitted for this principal"}
        # capacity-aware admission (docs/ADMISSION.md): shed BEFORE minting
        # state — a shed submission costs no KV writes and no bus traffic.
        # The op keys into the fleet throughput matrix the same way the
        # worker profiles it (payload op, else the topic).
        op = ""
        if isinstance(payload, dict):
            op = str(payload.get("op") or "")
        op = op or topic
        job_class = str(body.get("priority", "BATCH"))
        verdict = self.admission.admit(op=op, job_class=job_class, tenant=tenant)
        if not verdict.allowed:
            return 429, {
                "error": f"shed: {verdict.reason}",
                "reason": verdict.reason,
                "retry_after_s": verdict.retry_after_s,
            }
        job_id = str(body.get("job_id") or new_id())

        idem = str(body.get("idempotency_key") or idempotency_header)
        if idem:
            fresh, existing = await self.job_store.try_set_idempotency_key(tenant, idem, job_id)
            if not fresh:
                return 200, {"job_id": existing, "deduplicated": True}

        labels = {str(k): str(v) for k, v in (body.get("labels") or {}).items()}
        # batchable payloads carry their batch key as a label so the
        # scheduler can batch-affinity-route without reading the payload
        bkey = payload_batch_key(payload)
        if bkey and LABEL_BATCH_KEY not in labels:
            labels[LABEL_BATCH_KEY] = bkey
        # serving payloads carry their session id as a label so the
        # scheduler can route every turn of a conversation to the worker
        # holding its KV pages (session affinity, docs/SERVING.md)
        skey = payload_session_key(payload)
        if skey and LABEL_SESSION_KEY not in labels:
            labels[LABEL_SESSION_KEY] = skey
        # the resolved op rides as a label so capacity-aware consumers (the
        # ThroughputAwareStrategy's matrix lookup) never read the payload
        if LABEL_OP not in labels:
            labels[LABEL_OP] = op
        # gang payloads (docs/GANG.md) carry their placement ask as labels
        # so the scheduler's gang path (reserve N co-located workers,
        # all-or-nothing) never reads the payload behind the context pointer
        gspec = payload_gang(payload)
        if gspec is not None and LABEL_GANG_WORKERS not in labels:
            labels[LABEL_GANG_WORKERS] = str(int(gspec.get("workers", 1)))
            try:
                chips = int(gspec.get("chips_per_worker", 0) or 0)
            except (TypeError, ValueError):
                chips = 0
            if chips > 0:
                labels[LABEL_GANG_CHIPS] = str(chips)
            kind = str(gspec.get("kind", "") or "")
            if kind:
                # "serving" routes members into the worker's sharded
                # serving path (docs/SERVING.md §Sharded serving)
                labels[LABEL_GANG_KIND] = kind
        meta_doc = body.get("metadata") or {}
        metadata = JobMetadata(
            capability=str(meta_doc.get("capability", "")),
            risk_tags=list(meta_doc.get("risk_tags") or []),
            requires=list(meta_doc.get("requires") or []),
            pack_id=str(meta_doc.get("pack_id", "")),
        )
        if contains_secret_refs(payload) or contains_secret_refs(body.get("env")):
            labels[LABEL_SECRETS_PRESENT] = "true"
            if "secrets" not in metadata.risk_tags:
                metadata.risk_tags.append("secrets")

        ctx_ptr = await self.mem.put_context(job_id, payload)
        budget = Budget.from_dict(body.get("budget")) if body.get("budget") else None
        hints = ContextHints.from_dict(body.get("context_hints")) if body.get("context_hints") else None
        req = JobRequest(
            job_id=job_id,
            topic=topic,
            priority=str(body.get("priority", "BATCH")),
            context_ptr=ctx_ptr,
            memory_id=str(body.get("memory_id", "")),
            tenant_id=tenant,
            principal_id=principal.principal_id,
            adapter_id=str(body.get("adapter_id", "")),
            labels=labels,
            env={str(k): str(v) for k, v in (body.get("env") or {}).items()},
            metadata=metadata,
            budget=budget,
            context_hints=hints,
        )
        trace_id = str(body.get("trace_id") or new_id())
        # submit span: the trace root for API-submitted jobs; downstream
        # scheduler/kernel/worker spans hang off the packet's span context
        async with self.tracer.span(
            "submit",
            trace_id=trace_id,
            attrs={"job_id": job_id, "topic": topic, "tenant_id": tenant},
        ) as sp:
            await self.job_store.set_state(
                job_id,
                JobState.PENDING,
                fields={
                    "topic": topic,
                    "tenant_id": tenant,
                    "principal_id": principal.principal_id,
                    "context_ptr": ctx_ptr,
                    "trace_id": trace_id,
                    # SLO job class: the result path labels the class-split
                    # e2e/terminal metrics from this persisted field
                    "priority": req.priority,
                    "submitted_at_us": str(now_us()),
                },
                event="submit",
            )
            await self.job_store.put_request(req)
            await self.job_store.add_to_trace(trace_id, job_id)
            await self.bus.publish(
                subj.submit_subject_for(job_id, self.scheduler_shards),
                BusPacket.wrap(
                    req, trace_id=trace_id, sender_id=self.instance_id,
                    span_id=sp.span_id,
                ),
            )
        return 202, {"job_id": job_id, "trace_id": trace_id, "state": JobState.PENDING.value}

    async def get_job(self, request: web.Request) -> web.Response:
        job_id = request.match_info["job_id"]
        meta = await self.job_store.get_meta(job_id)
        if not meta:
            return _err(404, f"unknown job {job_id}")
        out: dict[str, Any] = {"job_id": job_id, **meta}
        if request.query.get("events") == "true":
            out["events"] = await self.job_store.events(job_id)
        if request.query.get("result") == "true" and meta.get("result_ptr"):
            out["result"] = await self.mem.get_pointer(meta["result_ptr"])
        return web.json_response(out)

    async def list_jobs(self, request: web.Request) -> web.Response:
        state = request.query.get("state", "")
        limit = int(request.query.get("limit", "50"))
        ids = (
            await self.job_store.list_by_state(state, limit)
            if state
            else await self.job_store.list_recent(limit)
        )
        jobs = []
        for jid in ids:
            meta = await self.job_store.get_meta(jid)
            jobs.append({"job_id": jid, "state": meta.get("state"), "topic": meta.get("topic"),
                         "tenant_id": meta.get("tenant_id")})
        return web.json_response({"jobs": jobs})

    async def cancel_job(self, request: web.Request) -> web.Response:
        job_id = request.match_info["job_id"]
        principal: Principal = request["principal"]
        if not await self.job_store.get_meta(job_id):
            return _err(404, f"unknown job {job_id}")
        await self.bus.publish(
            subj.cancel_subject(
                partition_of(job_id, self.scheduler_shards), self.scheduler_shards
            ),
            BusPacket.wrap(
                JobCancel(job_id=job_id, reason="api cancel", requested_by=principal.principal_id),
                sender_id=self.instance_id,
            ),
        )
        return web.json_response({"job_id": job_id, "cancelled": True})

    async def remediate_job(self, request: web.Request) -> web.Response:
        """Apply a safety-decision remediation: new job with safer topic/
        capability/labels (reference POST /jobs/{id}/remediate)."""
        job_id = request.match_info["job_id"]
        body = await request.json() if request.can_read_body else {}
        rem_id = str((body or {}).get("remediation_id", ""))
        decision = await self.job_store.get_safety_decision(job_id)
        if decision is None or not decision.remediations:
            return _err(404, "no remediations recorded for this job")
        rem = next((r for r in decision.remediations if not rem_id or r.get("id") == rem_id), None)
        if rem is None:
            return _err(404, f"unknown remediation {rem_id!r}")
        orig = await self.job_store.get_request(job_id)
        if orig is None:
            return _err(404, "original job request not found")
        new_id_ = new_id()
        ctx = await self.mem.get_context(orig.context_ptr) if orig.context_ptr else None
        new_ptr = await self.mem.put_context(new_id_, ctx)
        labels = {k: v for k, v in orig.labels.items() if k not in (rem.get("remove_labels") or [])}
        labels.update(rem.get("add_labels") or {})
        meta = orig.metadata or JobMetadata()
        new_req = JobRequest(
            job_id=new_id_,
            topic=rem.get("replacement_topic") or orig.topic,
            priority=orig.priority,
            context_ptr=new_ptr,
            memory_id=orig.memory_id,
            tenant_id=orig.tenant_id,
            principal_id=orig.principal_id,
            labels=labels,
            env=dict(orig.env),
            metadata=JobMetadata(
                capability=rem.get("replacement_capability") or meta.capability,
                risk_tags=list(meta.risk_tags),
                requires=list(meta.requires),
                pack_id=meta.pack_id,
            ),
        )
        await self.job_store.set_state(
            new_id_, JobState.PENDING,
            fields={"topic": new_req.topic, "tenant_id": new_req.tenant_id,
                    "remediated_from": job_id, "submitted_at_us": str(now_us())},
            event="remediate",
        )
        await self.job_store.put_request(new_req)
        await self.bus.publish(
            subj.submit_subject_for(new_id_, self.scheduler_shards),
            BusPacket.wrap(new_req, sender_id=self.instance_id),
        )
        return web.json_response({"job_id": new_id_, "remediated_from": job_id}, status=202)

    # ------------------------------------------------------------------
    # approvals (reference gateway.go:3700-3838)
    # ------------------------------------------------------------------
    async def list_approvals(self, request: web.Request) -> web.Response:
        ids = await self.job_store.list_by_state(JobState.APPROVAL_REQUIRED.value, 200)
        out = []
        for jid in ids:
            meta = await self.job_store.get_meta(jid)
            rec = await self.job_store.get_safety_decision(jid)
            out.append({
                "job_id": jid,
                "topic": meta.get("topic"),
                "tenant_id": meta.get("tenant_id"),
                "reason": meta.get("approval_reason", ""),
                "policy_snapshot": rec.policy_snapshot if rec else "",
            })
        return web.json_response({"approvals": out})

    async def approve_job(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "approvals require the admin role")
        job_id = request.match_info["job_id"]
        state = await self.job_store.get_state(job_id)
        if state != JobState.APPROVAL_REQUIRED.value:
            return _err(409, f"job is {state or 'unknown'}, not APPROVAL_REQUIRED")
        rec = await self.job_store.get_safety_decision(job_id)
        req = await self.job_store.get_request(job_id)
        if rec is None or req is None or not rec.job_hash:
            return _err(409, "no bound safety decision for this job")
        if rec.job_hash != job_hash(req):
            return _err(409, "stored request no longer matches the approved content")
        # re-check against the CURRENT kernel: policy may have tightened
        fresh = await self.kernel.check(
            PolicyCheckRequest(
                job_id=job_id, tenant_id=req.tenant_id, principal_id=req.principal_id,
                topic=req.topic, labels=dict(req.labels), metadata=req.metadata,
            )
        )
        if fresh.decision == "DENY":
            return _err(409, f"current policy denies this job: {fresh.reason}")
        await self.job_store.put_approval(
            ApprovalRecord(job_id=job_id, approved_by=principal.principal_id, approved=True,
                           job_hash=rec.job_hash, policy_snapshot=rec.policy_snapshot)
        )
        await self.job_store.append_event(job_id, "approved", by=principal.principal_id)
        republish = JobRequest.from_dict(req.to_dict())
        republish.labels = dict(republish.labels or {})
        republish.labels[LABEL_APPROVAL_GRANTED] = "true"
        republish.labels[LABEL_BUS_MSG_ID] = f"approve-{job_id}-{now_us()}"
        await self.bus.publish(
            subj.submit_subject_for(job_id, self.scheduler_shards),
            BusPacket.wrap(republish, sender_id=self.instance_id),
        )
        return web.json_response({"job_id": job_id, "approved": True})

    async def reject_job(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "approvals require the admin role")
        job_id = request.match_info["job_id"]
        state = await self.job_store.get_state(job_id)
        if state != JobState.APPROVAL_REQUIRED.value:
            return _err(409, f"job is {state or 'unknown'}, not APPROVAL_REQUIRED")
        body = await request.json() if request.can_read_body else {}
        reason = str((body or {}).get("reason", "rejected"))
        await self.job_store.put_approval(
            ApprovalRecord(job_id=job_id, approved_by=principal.principal_id, approved=False, reason=reason)
        )
        await self.job_store.set_state(
            job_id, JobState.DENIED, fields={"deny_reason": f"approval rejected: {reason}"},
            event="approval_rejected",
        )
        return web.json_response({"job_id": job_id, "approved": False})

    # ------------------------------------------------------------------
    # workflows + runs
    # ------------------------------------------------------------------
    async def put_workflow(self, request: web.Request) -> web.Response:
        doc = await request.json()
        wf = Workflow.from_dict(doc)
        if not wf.id:
            wf.id = new_id()
        errs = wf.validate()
        if errs:
            return _err(400, "; ".join(errs))
        await self.wf_store.put_workflow(wf)
        return web.json_response({"id": wf.id, "version": wf.version}, status=201)

    async def list_workflows(self, request: web.Request) -> web.Response:
        ids = await self.wf_store.list_workflows()
        return web.json_response({"workflows": ids})

    async def get_workflow(self, request: web.Request) -> web.Response:
        wf = await self.wf_store.get_workflow(request.match_info["wf_id"])
        if wf is None:
            return _err(404, "unknown workflow")
        return web.json_response(wf.to_dict())

    async def delete_workflow(self, request: web.Request) -> web.Response:
        ok = await self.wf_store.delete_workflow(request.match_info["wf_id"])
        return web.json_response({"deleted": ok}, status=200 if ok else 404)

    async def start_run(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        wf_id = request.match_info["wf_id"]
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        org = str(body.get("org_id") or principal.tenant_id)
        if org != principal.tenant_id and not principal.key_admin:
            # body org_id may not escape the key's tenant scope (same class
            # as the submit_job tenant guard)
            return _err(403, f"org {org!r} not permitted for this principal")
        labels = {str(k): str(v) for k, v in (body.get("labels") or {}).items()}
        wf = await self.wf_store.get_workflow(wf_id)
        if wf is None:
            return _err(404, "unknown workflow")
        # a run rides the admission ladder like a job: its SLO class (per-run
        # label override > workflow default) is the job class every dispatched
        # step inherits, so shedding happens before any step is scheduled
        slo = str(labels.get(LABEL_SLO_CLASS) or wf.slo_class or "").upper()
        if slo:
            labels[LABEL_SLO_CLASS] = slo
        verdict = self.admission.admit(
            op="workflow.run", job_class=slo or "BATCH", tenant=org
        )
        if not verdict.allowed:
            doc = {
                "error": f"shed: {verdict.reason}",
                "reason": verdict.reason,
                "retry_after_s": verdict.retry_after_s,
            }
            return web.json_response(
                doc, status=429, headers=_retry_after_headers(429, doc))
        run = await self.wf_engine.start_run(
            wf_id,
            body.get("input"),
            org_id=org,
            idempotency_key=request.headers.get("Idempotency-Key", str(body.get("idempotency_key", ""))),
            dry_run=bool(body.get("dry_run", False)),
            labels=labels,
            max_concurrent_runs=self.max_concurrent_runs,
        )
        return web.json_response({"run_id": run.run_id, "status": run.status}, status=202)

    async def list_runs(self, request: web.Request) -> web.Response:
        ids = await self.wf_store.list_runs(request.query.get("workflow_id", ""))
        if request.query.get("detail") in ("1", "true"):
            # summary docs in one batched fetch (cordumctl runs table)
            runs = await self.wf_store.get_runs(ids)
            docs = [
                {
                    "run_id": r.run_id,
                    "workflow_id": r.workflow_id,
                    "status": r.status,
                    "org_id": r.org_id,
                    "slo_class": r.labels.get(LABEL_SLO_CLASS, ""),
                    "trace_id": r.trace_id,
                    "created_at_us": r.created_at_us,
                    "finished_at_us": r.finished_at_us,
                    "steps": {k: sr.status for k, sr in r.steps.items()},
                }
                for r in runs
                if r is not None
            ]
            return web.json_response({"runs": docs})
        return web.json_response({"runs": ids})

    async def get_run(self, request: web.Request) -> web.Response:
        run = await self.wf_store.get_run(request.match_info["run_id"])
        if run is None:
            return _err(404, "unknown run")
        return web.json_response(run.to_dict())

    async def _with_run_lock(self, run_id: str, fn):
        """Run mutations must hold the same per-run lock the workflow-engine
        service uses, or concurrent result handling loses updates."""
        for _ in range(40):  # ~2s of 50ms retries before giving up
            if await self.wf_engine.store.acquire_run_lock(run_id, self.instance_id):
                try:
                    return await fn()
                finally:
                    await self.wf_engine.store.release_run_lock(run_id, self.instance_id)
            await asyncio.sleep(0.05)
        raise web.HTTPConflict(reason=f"run {run_id} is busy; retry")

    async def cancel_run(self, request: web.Request) -> web.Response:
        run_id = request.match_info["run_id"]
        run = await self._with_run_lock(
            run_id, lambda: self.wf_engine.cancel_run(run_id, reason="api cancel")
        )
        return web.json_response({"run_id": run.run_id, "status": run.status})

    async def rerun(self, request: web.Request) -> web.Response:
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        step_id = str(body.get("from_step", ""))
        if not step_id:
            return _err(400, "from_step is required")
        run_id = request.match_info["run_id"]
        run = await self._with_run_lock(
            run_id,
            lambda: self.wf_engine.rerun_from(
                run_id, step_id, dry_run=bool(body.get("dry_run", False))
            ),
        )
        return web.json_response({"run_id": run.run_id, "status": run.status}, status=202)

    async def approve_step(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "step approvals require the admin role")
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        run_id = request.match_info["run_id"]
        run = await self._with_run_lock(
            run_id,
            lambda: self.wf_engine.approve_step(
                run_id,
                request.match_info["step_id"],
                approve=bool(body.get("approve", True)),
                approved_by=principal.principal_id,
            ),
        )
        return web.json_response({"run_id": run.run_id, "status": run.status})

    async def run_timeline(self, request: web.Request) -> web.Response:
        tl = await self.wf_store.timeline(request.match_info["run_id"])
        return web.json_response({"timeline": tl})

    # ------------------------------------------------------------------
    # DLQ
    # ------------------------------------------------------------------
    async def list_dlq(self, request: web.Request) -> web.Response:
        offset = int(request.query.get("offset", "0"))
        limit = int(request.query.get("limit", "50"))
        entries = await self.dlq.list(offset, limit)
        return web.json_response({
            "entries": [e.__dict__ for e in entries],
            "total": await self.dlq.count(),
        })

    async def delete_dlq(self, request: web.Request) -> web.Response:
        ok = await self.dlq.delete(request.match_info["job_id"])
        return web.json_response({"deleted": ok}, status=200 if ok else 404)

    async def _retry_dlq_job(self, job_id: str) -> Optional[str]:
        """The per-job DLQ re-drive: NEW job id, rehydrated context, fresh
        submit (reference gateway.go:3452).  Returns the new job id, or None
        when the entry/original request is gone.  Shared by the single-job
        route and ``retry-all``."""
        entry = await self.dlq.get(job_id)
        orig = await self.job_store.get_request(job_id)
        if entry is None or orig is None:
            return None
        new_jid = new_id()
        ctx = await self.mem.get_context(orig.context_ptr) if orig.context_ptr else None
        new_ptr = await self.mem.put_context(new_jid, ctx)
        req = JobRequest.from_dict(orig.to_dict())
        req.job_id = new_jid
        req.context_ptr = new_ptr
        req.labels = {k: v for k, v in (req.labels or {}).items() if k != LABEL_BUS_MSG_ID}
        await self.job_store.set_state(
            new_jid, JobState.PENDING,
            fields={"topic": req.topic, "tenant_id": req.tenant_id, "retried_from": job_id,
                    "submitted_at_us": str(now_us())},
            event="dlq_retry",
        )
        await self.job_store.put_request(req)
        await self.bus.publish(
            subj.submit_subject_for(new_jid, self.scheduler_shards),
            BusPacket.wrap(req, sender_id=self.instance_id),
        )
        await self.dlq.delete(job_id)
        return new_jid

    async def retry_dlq(self, request: web.Request) -> web.Response:
        job_id = request.match_info["job_id"]
        new_jid = await self._retry_dlq_job(job_id)
        if new_jid is None:
            return _err(404, "job not found in DLQ")
        return web.json_response({"job_id": new_jid, "retried_from": job_id}, status=202)

    async def retry_all_dlq(self, request: web.Request) -> web.Response:
        """Re-drive every dead-lettered job via the per-job retry path
        (admin: a bulk resubmit can flood the scheduler)."""
        if (deny := self._require_admin(request)) is not None:
            return deny
        body = await request.json() if request.can_read_body else {}
        results = await self.dlq.retry_all(
            self._retry_dlq_job, limit=int((body or {}).get("limit", 0))
        )
        return web.json_response({
            "retried": [
                {"job_id": jid, "new_job_id": new} for jid, new in results if new
            ],
            "skipped": [jid for jid, new in results if not new],
            "count": sum(1 for _, new in results if new),
        }, status=202)

    async def purge_dlq(self, request: web.Request) -> web.Response:
        """Drop DLQ entries older than a cutoff: body ``{"older_than_us": N}``
        or ``{"max_age_s": N}`` (admin: purging is irreversible)."""
        if (deny := self._require_admin(request)) is not None:
            return deny
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        if "older_than_us" in body:
            cutoff = int(body["older_than_us"])
        elif "max_age_s" in body:
            cutoff = now_us() - int(float(body["max_age_s"]) * 1e6)
        else:
            return _err(400, "older_than_us or max_age_s is required")
        purged = await self.dlq.purge_older_than(cutoff)
        return web.json_response({"purged": purged})

    # ------------------------------------------------------------------
    # policy admin
    # ------------------------------------------------------------------
    @staticmethod
    def _policy_check_request(doc: dict) -> PolicyCheckRequest:
        meta = doc.get("metadata")
        return PolicyCheckRequest(
            job_id=str(doc.get("job_id", "")),
            tenant_id=str(doc.get("tenant_id", "")),
            principal_id=str(doc.get("principal_id", "")),
            topic=str(doc.get("topic", "")),
            labels={str(k): str(v) for k, v in (doc.get("labels") or {}).items()},
            metadata=JobMetadata.from_dict(meta) if meta else None,
            actor_id=str(doc.get("actor_id", "")),
            actor_type=str(doc.get("actor_type", "")),
            effective_config=doc.get("effective_config") or {},
        )

    async def policy_evaluate(self, request: web.Request) -> web.Response:
        doc = await request.json()
        resp = await self.kernel.evaluate_raw(self._policy_check_request(doc))
        return web.json_response(resp.to_dict())

    async def policy_simulate(self, request: web.Request) -> web.Response:
        doc = await request.json()
        results = await self.kernel.simulate(
            doc.get("policy") or {},
            [self._policy_check_request(r) for r in (doc.get("requests") or [])],
        )
        return web.json_response({"results": results})

    async def policy_explain(self, request: web.Request) -> web.Response:
        doc = await request.json()
        return web.json_response(await self.kernel.explain(self._policy_check_request(doc)))

    async def policy_snapshots(self, request: web.Request) -> web.Response:
        return web.json_response({"snapshots": self.kernel.list_snapshots(),
                                  "current": self.kernel.snapshot_id})

    # ------------------------------------------------------------------
    # pack catalogs (local-directory marketplace equivalent)
    # ------------------------------------------------------------------
    def _catalog(self):
        from ...packs import PackCatalog

        return PackCatalog(self.configsvc, self._pack_installer())

    async def list_catalogs(self, request: web.Request) -> web.Response:
        return web.json_response({"catalogs": await self._catalog().list_catalogs()})

    async def add_catalog(self, request: web.Request) -> web.Response:
        from ...packs import PackError

        if (deny := self._require_admin(request)) is not None:
            return deny
        body = await request.json()
        try:
            cat = self._catalog()
            if body.get("allowed_roots") is not None:
                await cat.set_allowed_roots(list(body["allowed_roots"]))
            entry = None
            if body.get("name") and body.get("path"):
                entry = await cat.add_catalog(str(body["name"]), str(body["path"]))
        except PackError as e:
            return _err(400, str(e))
        return web.json_response({"added": entry}, status=201)

    async def catalog_packs(self, request: web.Request) -> web.Response:
        from ...packs import PackError

        try:
            packs = await self._catalog().list_packs(request.match_info["catalog"])
        except PackError as e:
            return _err(404, str(e))
        return web.json_response({"packs": packs})

    async def catalog_install(self, request: web.Request) -> web.Response:
        from ...packs import PackError

        if (deny := self._require_admin(request)) is not None:
            return deny
        try:
            record = await self._catalog().install_from_catalog(
                request.match_info["catalog"], request.match_info["pack_id"]
            )
        except PackError as e:
            return _err(400, str(e))
        return web.json_response(record, status=201)

    # ------------------------------------------------------------------
    # policy bundles (reference policy_bundles.go)
    # ------------------------------------------------------------------
    def _bundles(self):
        from ..safetykernel.bundles import PolicyBundleAdmin

        if self.configsvc is None:
            raise web.HTTPNotImplemented(reason="config service not wired")
        return PolicyBundleAdmin(self.kv, self.configsvc, self.kernel)

    @staticmethod
    def _bundle_id(request: web.Request) -> str:
        from ..safetykernel.bundles import unescape_bundle_id

        return unescape_bundle_id(request.match_info["bundle_id"])

    def _require_admin(self, request: web.Request) -> Optional[web.Response]:
        if request["principal"].role != "admin":
            return _err(403, "policy administration requires the admin role")
        return None

    async def bundles_list(self, request: web.Request) -> web.Response:
        return web.json_response({"bundles": await self._bundles().list_bundles()})

    async def bundles_get(self, request: web.Request) -> web.Response:
        b = await self._bundles().get_bundle(self._bundle_id(request))
        return web.json_response(b) if b else _err(404, "unknown bundle")

    async def bundles_put(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        result = await self._bundles().put_bundle(
            self._bundle_id(request), await request.json(),
            actor=request["principal"].principal_id,
        )
        return web.json_response(result, status=201)

    async def bundles_delete(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        ok = await self._bundles().delete_bundle(
            self._bundle_id(request), actor=request["principal"].principal_id
        )
        return web.json_response({"deleted": ok}, status=200 if ok else 404)

    async def bundles_publish(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        try:
            result = await self._bundles().publish(
                self._bundle_id(request), actor=request["principal"].principal_id
            )
        except KeyError as e:
            return _err(404, str(e))
        return web.json_response(result)

    async def bundles_unpublish(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        try:
            result = await self._bundles().unpublish(
                self._bundle_id(request), actor=request["principal"].principal_id
            )
        except KeyError as e:
            return _err(404, str(e))
        return web.json_response(result)

    async def bundles_simulate(self, request: web.Request) -> web.Response:
        doc = await request.json()
        bundle = await self._bundles().get_bundle(self._bundle_id(request))
        data = doc.get("draft") or (bundle or {}).get("data") or {}
        results = await self._bundles().simulate_draft(
            data, [self._policy_check_request(r) for r in (doc.get("requests") or [])]
        )
        return web.json_response({"results": results})

    async def snapshots_capture(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        body = await request.json() if request.can_read_body else {}
        result = await self._bundles().capture_snapshot(
            actor=request["principal"].principal_id, note=str((body or {}).get("note", ""))
        )
        return web.json_response(result, status=201)

    async def snapshots_captured(self, request: web.Request) -> web.Response:
        return web.json_response({"snapshots": await self._bundles().list_captured()})

    async def snapshots_rollback(self, request: web.Request) -> web.Response:
        if (deny := self._require_admin(request)) is not None:
            return deny
        try:
            result = await self._bundles().rollback(
                request.match_info["snapshot_id"], actor=request["principal"].principal_id
            )
        except KeyError as e:
            return _err(404, str(e))
        return web.json_response(result)

    async def policy_audit(self, request: web.Request) -> web.Response:
        return web.json_response({"audit": await self._bundles().audit_log()})

    # ------------------------------------------------------------------
    # packs (reference gateway packs.go installer endpoints)
    # ------------------------------------------------------------------
    def _pack_installer(self):
        from ...packs import PackInstaller

        if self.configsvc is None:
            raise web.HTTPNotImplemented(reason="config service not wired")
        return PackInstaller(
            configsvc=self.configsvc, schemas=self.schemas,
            wf_store=self.wf_store, kernel=self.kernel,
        )

    async def install_pack(self, request: web.Request) -> web.Response:
        from ...packs import PackError, manifest_from_doc

        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "pack installs require the admin role")
        try:
            m = manifest_from_doc(await request.json())
            record = await self._pack_installer().install(m)
        except PackError as e:
            return _err(400, str(e))
        return web.json_response(record, status=201)

    async def list_packs(self, request: web.Request) -> web.Response:
        installed = await self._pack_installer().list_installed()
        return web.json_response({"packs": installed})

    async def show_pack(self, request: web.Request) -> web.Response:
        installed = await self._pack_installer().list_installed()
        rec = installed.get(request.match_info["pack_id"])
        if rec is None:
            return _err(404, "pack not installed")
        return web.json_response(rec)

    async def uninstall_pack(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "pack uninstalls require the admin role")
        ok = await self._pack_installer().uninstall(request.match_info["pack_id"])
        return web.json_response({"uninstalled": ok}, status=200 if ok else 404)

    # ------------------------------------------------------------------
    # config / schemas / locks / artifacts / memory / traces
    # ------------------------------------------------------------------
    async def config_get(self, request: web.Request) -> web.Response:
        if self.configsvc is None:
            return _err(501, "config service not wired")
        doc = await self.configsvc.get(request.match_info["scope"], request.match_info["doc_id"])
        if doc is None:
            return _err(404, "unknown config doc")
        return web.json_response({"scope": doc.scope, "id": doc.doc_id, "revision": doc.revision,
                                  "data": doc.data})

    async def config_set(self, request: web.Request) -> web.Response:
        principal: Principal = request["principal"]
        if principal.role != "admin":
            return _err(403, "config writes require the admin role")
        if self.configsvc is None:
            return _err(501, "config service not wired")
        body = await request.json()
        scope, doc_id = request.match_info["scope"], request.match_info["doc_id"]
        if body.get("patch"):
            doc = await self.configsvc.patch(scope, doc_id, body["patch"])
        else:
            doc = await self.configsvc.set(scope, doc_id, body.get("data") or {})
        await self.kernel.reload()  # policy fragments may have changed
        return web.json_response({"scope": scope, "id": doc_id, "revision": doc.revision})

    async def config_effective(self, request: web.Request) -> web.Response:
        if self.configsvc is None:
            return _err(501, "config service not wired")
        q = request.query
        eff = await self.configsvc.effective(
            org=q.get("org", ""), team=q.get("team", ""),
            workflow=q.get("workflow", ""), step=q.get("step", ""),
        )
        return web.json_response({"effective": eff})

    async def list_schemas(self, request: web.Request) -> web.Response:
        return web.json_response({"schemas": await self.schemas.list()})

    async def get_schema(self, request: web.Request) -> web.Response:
        s = await self.schemas.get(request.match_info["schema_id"])
        if s is None:
            return _err(404, "unknown schema")
        return web.json_response(s)

    async def put_schema(self, request: web.Request) -> web.Response:
        await self.schemas.put(request.match_info["schema_id"], await request.json())
        return web.json_response({"id": request.match_info["schema_id"]}, status=201)

    async def delete_schema(self, request: web.Request) -> web.Response:
        ok = await self.schemas.delete(request.match_info["schema_id"])
        return web.json_response({"deleted": ok}, status=200 if ok else 404)

    async def list_locks(self, request: web.Request) -> web.Response:
        infos = await self.locks.list()
        return web.json_response({"locks": [i.__dict__ for i in infos]})

    async def acquire_lock(self, request: web.Request) -> web.Response:
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        principal: Principal = request["principal"]
        ok = await self.locks.acquire(
            request.match_info["resource"],
            str(body.get("owner") or principal.principal_id),
            mode=str(body.get("mode", "exclusive")),
            ttl_s=float(body.get("ttl_s", 30.0)),
        )
        return web.json_response({"acquired": ok}, status=200 if ok else 409)

    async def release_lock(self, request: web.Request) -> web.Response:
        body = await request.json() if request.can_read_body else {}
        body = body or {}
        principal: Principal = request["principal"]
        ok = await self.locks.release(
            request.match_info["resource"], str(body.get("owner") or principal.principal_id)
        )
        return web.json_response({"released": ok}, status=200 if ok else 404)

    async def put_artifact(self, request: web.Request) -> web.Response:
        data = await request.read()
        meta = await self.artifacts.put(
            data,
            content_type=request.content_type or "application/octet-stream",
            retention=request.query.get("retention", "standard"),
        )
        return web.json_response(
            {"artifact_id": meta.artifact_id, "pointer": self.artifacts.pointer(meta.artifact_id),
             "size": meta.size},
            status=201,
        )

    async def get_artifact(self, request: web.Request) -> web.Response:
        data, meta = await self.artifacts.get(request.match_info["artifact_id"])
        if data is None:
            return _err(404, "unknown artifact")
        return web.Response(body=data, content_type=meta.content_type if meta else "application/octet-stream")

    async def context_window(self, request: web.Request) -> web.Response:
        if getattr(self, "context_svc", None) is None:
            return _err(501, "context engine not wired")
        body = await request.json()
        msgs = await self.context_svc.build_window(
            str(body.get("memory_id", "")),
            mode=str(body.get("mode", "RAW")).upper(),
            payload=body.get("payload"),
            max_input_tokens=int(body.get("max_input_tokens", 4000)),
        )
        return web.json_response({"messages": [m.to_dict() for m in msgs]})

    async def context_update(self, request: web.Request) -> web.Response:
        if getattr(self, "context_svc", None) is None:
            return _err(501, "context engine not wired")
        body = await request.json()
        await self.context_svc.update_memory(
            request.match_info["memory_id"],
            user_payload=body.get("payload"),
            model_response=str(body.get("model_response", "")),
            mode=str(body.get("mode", "CHAT")).upper(),
        )
        return web.json_response({"ok": True})

    async def context_chunks(self, request: web.Request) -> web.Response:
        if getattr(self, "context_svc", None) is None:
            return _err(501, "context engine not wired")
        body = await request.json()
        n = await self.context_svc.put_chunks(
            request.match_info["memory_id"], list(body.get("chunks") or [])
        )
        return web.json_response({"embedded": n})

    async def read_pointer(self, request: web.Request) -> web.Response:
        ptr = request.query.get("ptr", "")
        if not ptr:
            return _err(400, "ptr query param required")
        value = await self.mem.get_pointer(ptr)
        if value is None:
            return _err(404, "pointer not found")
        return web.json_response({"ptr": ptr, "value": value})

    async def get_trace(self, request: web.Request) -> web.Response:
        """Trace reader: job-id grouping (legacy shape) + the flight-recorder
        span waterfall — tree, per-stage durations, critical path."""
        trace_id = request.match_info["trace_id"]
        job_ids = sorted(await self.job_store.trace(trace_id))
        jobs = []
        for jid in job_ids:
            meta = await self.job_store.get_meta(jid)
            jobs.append({"job_id": jid, "state": meta.get("state"), "topic": meta.get("topic")})
        doc = assemble(trace_id, await self.span_collector.spans(trace_id))
        doc["jobs"] = jobs
        return web.json_response(doc)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    async def get_workers(self, request: web.Request) -> web.Response:
        if self.registry is not None:
            return web.json_response(self.registry.snapshot_json())
        snap = await self.kv.get("sys:workers:snapshot")
        return web.json_response(json.loads(snap) if snap else {"workers": {}, "count": 0})

    async def drain_worker(self, request: web.Request) -> web.Response:
        """``POST /api/v1/workers/{worker_id}/drain`` — ask a worker to
        drain gracefully: stop admitting, live-migrate its serving sessions
        to peers, finish per-job work, then exit (docs/SERVING.md
        §Migration, drain, and failover).  Fire-and-forget: the drain
        request fans out on the bus and progress shows up as the worker's
        ``draining`` heartbeat and its fleet beacon."""
        principal: Principal = request["principal"]
        worker_id = request.match_info["worker_id"]
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except Exception:  # noqa: BLE001 - body is optional
                body = {}
        await self.bus.publish(
            subj.DRAIN,
            BusPacket.wrap(
                WorkerDrain(
                    worker_id=worker_id,
                    reason=str((body or {}).get("reason", "api drain")),
                    requested_by=principal.principal_id,
                ),
                sender_id=self.instance_id,
            ),
        )
        return web.json_response(
            {"worker_id": worker_id, "draining": True}, status=202
        )

    async def get_status(self, request: web.Request) -> web.Response:
        return web.json_response({
            "bus": await self.bus.ping(),
            "kv": await self.kv.ping(),
            "policy_snapshot": self.kernel.snapshot_id,
            "workers": len(self.registry.snapshot()) if self.registry else None,
            "ws_clients": len(self._ws_clients),
        })

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    def _telemetry_health(self) -> dict:
        return {
            "role": "gateway",
            "ws_clients": len(self._ws_clients),
            "scheduler_shards": self.scheduler_shards,
            **self.profiler.health(),
        }

    async def get_fleet(self, request: web.Request) -> web.Response:
        """``GET /api/v1/fleet`` — per-service health beacons, fleet-wide
        rates and stage latencies, SLO burn states (docs/OBSERVABILITY.md
        §Fleet telemetry)."""
        return web.json_response(self.fleet.fleet_doc(self.slo_tracker))

    async def list_traces(self, request: web.Request) -> web.Response:
        """``GET /api/v1/traces?last=N`` — newest trace summaries from the
        collector index (`cordum traces --last N`)."""
        n = min(200, max(1, int(request.query.get("last", "20"))))
        return web.json_response(
            {"traces": await self.span_collector.recent(n)}
        )

    async def traces_analysis(self, request: web.Request) -> web.Response:
        """``GET /api/v1/traces/analysis?last=N`` — cross-trace critical-path
        blame over the newest N stored traces: per-stage blame shares
        (summing to ~1.0) with p50/p99 of each stage's exclusive time, plus
        the slowest trace ids as exemplars (`cordum traces blame`)."""
        n = min(500, max(1, int(request.query.get("last", "100"))))
        ids = await self.span_collector.recent_trace_ids(n)
        docs = [
            assemble(tid, await self.span_collector.spans(tid)) for tid in ids
        ]
        return web.json_response(aggregate_critical_paths(docs))

    async def get_capacity(self, request: web.Request) -> web.Response:
        """``GET /api/v1/capacity`` — the op × worker throughput matrix
        folded from the workers' capacity beacons (`cordumctl capacity`;
        the heterogeneity-aware strategy's read-only input)."""
        return web.json_response(self.fleet.capacity_doc())

    async def get_admission(self, request: web.Request) -> web.Response:
        """``GET /api/v1/admission`` — live admission-controller state:
        per-(op, class) headroom, current brownout tier, per-tenant bucket
        levels (`cordumctl admission`, docs/ADMISSION.md)."""
        return web.json_response(self.admission.doc())

    async def get_gangs(self, request: web.Request) -> web.Response:
        """``GET /api/v1/gangs`` — the live gang table merged from the
        scheduler shards' health beacons (`cordumctl gangs`,
        docs/GANG.md)."""
        return web.json_response(self.fleet.gangs_doc())

    async def get_metrics(self, request: web.Request) -> web.Response:
        # ?scope=fleet: the aggregator's fleet-merged exposition (counters/
        # histograms summed across processes, gauges per instance)
        if request.query.get("scope") == "fleet":
            return web.Response(
                text=self.fleet.render(), content_type="text/plain"
            )
        return web.Response(text=self.metrics.render(), content_type="text/plain")

    async def ws_stream(self, request: web.Request) -> web.WebSocketResponse:
        origin = request.headers.get("Origin", "")
        if self.ws_allowed_origins is not None and origin and origin not in self.ws_allowed_origins:
            raise web.HTTPForbidden(reason="origin not allowed")
        # echo the offered subprotocol back so browser handshakes complete
        # when the API key rides Sec-WebSocket-Protocol
        offered = [p.strip() for p in
                   request.headers.get("Sec-WebSocket-Protocol", "").split(",") if p.strip()]
        ws = web.WebSocketResponse(heartbeat=30, protocols=offered or ())
        await ws.prepare(request)
        self._ws_clients.add(ws)
        try:
            async for msg in ws:
                if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            self._ws_clients.discard(ws)
        return ws
