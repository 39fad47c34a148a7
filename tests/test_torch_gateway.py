"""The port's API gateway against the JAX package's, request by request.

Each scenario builds the same control plane twice, once from each package,
as ``tests/test_gateway.py`` builds the reference's: a ``MemoryKV`` and a
``LoopbackBus``, the scheduler (``LeastLoadedStrategy``, embedded safety
kernel), the workflow engine and its result service, and the ``Gateway``
behind aiohttp's test server.  A scripted worker (``Responder``) answers
the jobs the scheduler dispatches to it, the same in both.  Ids are drawn
from a counter in both runs (``uuid.uuid4`` and the span-id counter are
replaced), ``random`` is seeded, and wall-clock values are normalised; the
sequence of HTTP status codes and bodies, the WebSocket events, the
``/metrics`` lines and the KV keys written must then be equal.
"""
from __future__ import annotations

import asyncio
import contextlib
import importlib
import itertools
import json
import random
import re
import uuid
from types import SimpleNamespace

import pytest

PACKAGES = ("cordum_tpu", "cordum_tpu_torch")
SEED = 0
POLICY = {
    "default_tenant": "default",
    "tenants": {"default": {"allow_topics": ["job.*", "job.>"]}},
    "rules": [
        {"id": "approve-deploy", "match": {"topics": ["job.deploy.*"]},
         "decision": "require_approval",
         "remediations": [{"id": "use-staging", "replacement_topic": "job.work",
                           "add_labels": {"env": "staging"}}]},
    ],
}
POOLS = {"topics": {"job.work": "p"}, "pools": {"p": {}}}
#: dict keys whose numeric values are wall-clock readings or durations
VOLATILE_KEY = re.compile(
    r"(_us|_ms|_at|_ts|_time|_ns|_seconds|_sec|_s|^ts|^time|timestamp|^age|uptime|elapsed|"
    r"duration|latency|^started|^updated|^created|^expires|^deadline|^last_seen|rate|ewma|p50|"
    r"p95|p99|^mean|^now)$")
#: dict keys whose values map names to wall-clock readings
VOLATILE_MAP = ("owners",)
#: /metrics families whose values are timings or process readings
VOLATILE_METRIC = re.compile(
    r"(_seconds|latency|_bytes|uptime|_ms|_rate|process_|python_|runtime_|loop_|gc_|"
    r"_per_sec|_ratio|_duty)")


class Pkg:
    """One package's modules, by their shared names."""

    def __init__(self, root):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.root = root
        self.app = m("controlplane.gateway.app")
        self.auth = m("controlplane.gateway.auth")
        self.kernel = m("controlplane.safetykernel.kernel")
        self.sched = m("controlplane.scheduler.engine")
        self.safety_client = m("controlplane.scheduler.safety_client")
        self.strategy = m("controlplane.scheduler.strategy")
        self.wf_service = m("controlplane.workflowengine.service")
        self.bus = m("infra.bus")
        self.config = m("infra.config")
        self.configsvc = m("infra.configsvc")
        self.jobstore = m("infra.jobstore")
        self.kv = m("infra.kv")
        self.memstore = m("infra.memstore")
        self.registry = m("infra.registry")
        self.schemareg = m("infra.schemareg")
        self.subj = m("protocol.subjects")
        self.types = m("protocol.types")
        self.ids = m("utils.ids")
        self.wf_engine = m("workflow.engine")
        self.wf_store = m("workflow.store")
        self.context = m("context.service")


@contextlib.contextmanager
def counted_ids(pkg):
    """``uuid.uuid4`` and the package's span-id counter from a fresh
    counter, ``random`` seeded: both packages then draw the same ids."""
    ctr = itertools.count(1)
    real = uuid.uuid4
    prefix, fast = pkg.ids._FAST_PREFIX, pkg.ids._FAST_CTR
    uuid.uuid4 = lambda: uuid.UUID(int=next(ctr))
    pkg.ids._FAST_PREFIX, pkg.ids._FAST_CTR = "0" * 16, itertools.count(1)
    random.seed(SEED)
    try:
        yield
    finally:
        uuid.uuid4 = real
        pkg.ids._FAST_PREFIX, pkg.ids._FAST_CTR = prefix, fast


class Responder:
    """A scripted worker ``w1`` in pool ``p``: one heartbeat, then each job
    dispatched to it answered at once with ``{"done": True, "echo":
    payload}``, or FAILED where the payload asks for it."""

    def __init__(self, s, worker_id="w1"):
        self.s, self.worker_id = s, worker_id
        self.seen: list[str] = []
        self._subs = []

    async def start(self):
        s = self.s
        T = s.pkg.types
        for subject in (s.pkg.subj.direct_subject(self.worker_id), "job.work"):
            self._subs.append(await s.bus.subscribe(subject, self._on_job, queue="p"))
        await s.bus.publish(s.pkg.subj.HEARTBEAT, T.BusPacket.wrap(T.Heartbeat(
            worker_id=self.worker_id, pool="p", max_parallel_jobs=8, capabilities=["echo"]),
            sender_id=self.worker_id))

    async def _on_job(self, subject, pkt):
        s, T = self.s, self.s.pkg.types
        req = pkt.job_request
        if req is None:
            return
        self.seen.append(req.job_id)
        payload = await s.mem.get_context(req.context_ptr) if req.context_ptr else None
        p = payload if isinstance(payload, dict) else {}
        if p.get("fail"):
            res = T.JobResult(job_id=req.job_id, status="FAILED", worker_id=self.worker_id,
                              error_code="WORKER_ERROR",
                              error_message="worker failure requested")
        else:
            ptr = await s.mem.put_result(req.job_id, {"done": True, "echo": p})
            res = T.JobResult(job_id=req.job_id, status="SUCCEEDED", result_ptr=ptr,
                              worker_id=self.worker_id)
        await s.bus.publish(s.pkg.subj.RESULT, T.BusPacket.wrap(res, sender_id=self.worker_id))

    def stop(self):
        for sub in self._subs:
            sub.unsubscribe()


async def make_stack(pkg, *, gateway_kw=None):
    """The control plane of ``tests/test_gateway.py``'s ``GwStack`` from
    ``pkg``, the gateway behind a test server and client."""
    from aiohttp.test_utils import TestClient, TestServer

    kv = pkg.kv.MemoryKV()
    bus = pkg.bus.LoopbackBus()
    s = SimpleNamespace(pkg=pkg, kv=kv, bus=bus)
    s.job_store = pkg.jobstore.JobStore(kv)
    s.mem = pkg.memstore.MemoryStore(kv)
    s.wf_store = pkg.wf_store.WorkflowStore(kv)
    s.schemas = pkg.schemareg.SchemaRegistry(kv)
    s.configsvc = pkg.configsvc.ConfigService(kv)
    s.kernel = pkg.kernel.SafetyKernel(policy_doc=POLICY, configsvc=s.configsvc)
    s.registry = pkg.registry.WorkerRegistry()
    pc = pkg.config.parse_pool_config(POOLS)
    s.scheduler = pkg.sched.Engine(
        bus=bus, job_store=s.job_store, safety=pkg.safety_client.SafetyClient(s.kernel.check),
        strategy=pkg.strategy.LeastLoadedStrategy(s.registry, pc), registry=s.registry)
    s.wf_engine = pkg.wf_engine.Engine(store=s.wf_store, bus=bus, mem=s.mem,
                                       schemas=s.schemas, configsvc=s.configsvc)
    s.wf_service = pkg.wf_service.WorkflowEngineService(
        engine=s.wf_engine, bus=bus, job_store=s.job_store, reconcile_interval_s=0.1)
    s.gw = pkg.app.Gateway(
        kv=kv, bus=bus, job_store=s.job_store, mem=s.mem, kernel=s.kernel,
        wf_store=s.wf_store, wf_engine=s.wf_engine, schemas=s.schemas,
        configsvc=s.configsvc, registry=s.registry,
        auth=pkg.auth.BasicAuthProvider(["user-key"], admin_keys=["admin-key"]),
        **(gateway_kw or {}))
    s.responder = Responder(s)
    await s.kernel.reload()
    await s.scheduler.start()
    await s.wf_service.start()
    # the bus taps of Gateway.start, without its TCP listener
    s.gw._subs.append(await bus.subscribe(pkg.subj.DLQ, s.gw._tap_dlq))
    s.gw._subs.append(await bus.subscribe("sys.job.>", s.gw._tap_events))
    s.gw._subs.append(await bus.subscribe(pkg.subj.HEARTBEAT, s.gw._tap_heartbeat))
    await s.responder.start()
    s.client = TestClient(TestServer(s.gw.app))
    await s.client.start_server()
    await settle(s)
    return s


async def close_stack(s):
    await s.client.close()
    s.responder.stop()
    await s.wf_service.stop()
    await s.scheduler.stop()
    for sub in s.gw._subs:
        sub.unsubscribe()
    await s.bus.close()


async def settle(s, rounds=10):
    for _ in range(rounds):
        await s.bus.drain()
        await asyncio.sleep(0.01)


def hdr(admin=False, **extra):
    return {"X-Api-Key": "admin-key" if admin else "user-key", **extra}


def _number(v):
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, float)):
        return True
    return isinstance(v, str) and re.fullmatch(r"-?\d+(\.\d*)?(e-?\d+)?", v) is not None


def norm(obj):
    """``obj`` with wall-clock numbers (and the KV's numeric strings of
    them) replaced by ``"<t>"``."""
    if isinstance(obj, dict):
        return {k: ("<t>" if _number(v) and VOLATILE_KEY.search(str(k))
                    else {n: "<t>" for n in v} if k in VOLATILE_MAP and isinstance(v, dict)
                    else norm(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


class Recorder:
    """Sends requests through a stack's client and keeps (label, status,
    normalised body) for each."""

    def __init__(self, s):
        self.s = s
        self.log: list = []

    async def call(self, method, path, label=None, *, raw=False, **kw):
        r = await getattr(self.s.client, method)(path, **kw)
        if raw:
            body = (await r.read()).decode("utf-8", "replace")
        else:
            text = await r.text()
            try:
                body = norm(json.loads(text))
            except ValueError:
                body = text
        self.log.append((label or f"{method.upper()} {path}", r.status, body))
        return r.status, body

    def note(self, label, value):
        self.log.append((label, norm(value)))


def kv_keys(s):
    return sorted(s.kv._data)


def metric_lines(text):
    """``/metrics`` text with the values of timing and process families
    blanked; every line, comments included, kept in order."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            out.append(line)
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        series, _, value = line.rpartition(" ")
        if "#" in line:  # an exemplar: trace id and timestamp vary by run
            series = line.split(" # ", 1)[0].rpartition(" ")[0]
        out.append(series + (" <v>" if VOLATILE_METRIC.search(name) else " " + value.split()[0]
                             if "#" not in line else " <v>"))
    return out


def both(scenario, **stack_kw):
    """Run ``scenario(stack, recorder)`` on each package; the recorded
    requests, the extra values it returns and the KV keys must be equal.
    Returns the reference's record."""
    async def one(root):
        pkg = Pkg(root)
        with counted_ids(pkg):
            s = await make_stack(pkg, **stack_kw)
            rec = Recorder(s)
            try:
                extra = await scenario(s, rec)
                await settle(s)
                return {"requests": rec.log, "extra": extra, "kv": kv_keys(s)}
            finally:
                await close_stack(s)

    ref, port = (asyncio.run(one(root)) for root in PACKAGES)
    for a, b in zip(ref["requests"], port["requests"]):
        assert b == a
    assert port == ref
    return ref


async def wait_state(s, job_id, states=("SUCCEEDED", "FAILED", "DENIED", "CANCELLED"),
                     rounds=200):
    for _ in range(rounds):
        st = await s.job_store.get_state(job_id)
        if st in states:
            return st
        await settle(s, 1)
    return await s.job_store.get_state(job_id)


# ---------------------------------------------------------------- jobs


def test_auth_and_tenant_scope():
    async def scenario(s, rec):
        await rec.call("get", "/api/v1/jobs")
        await rec.call("get", "/api/v1/jobs", headers=hdr())
        await rec.call("get", "/api/v1/jobs", headers=hdr(**{"X-Tenant-Id": "other"}))
        await rec.call("post", "/api/v1/jobs", json={"topic": "job.work", "tenant_id": "other"},
                       headers=hdr())
        await rec.call("post", "/api/v1/jobs", json={"topic": "job.work", "tenant_id": "other"},
                       headers=hdr(admin=True))
        await rec.call("post", "/api/v1/jobs", headers={"Authorization": "Bearer user-key"},
                       json={"topic": "job.work"})

    t = both(scenario)
    assert [r[1] for r in t["requests"]] == [401, 200, 401, 403, 202, 202]


def test_job_submit_get_and_trace():
    async def scenario(s, rec):
        _, doc = await rec.call("post", "/api/v1/jobs",
                                json={"topic": "job.work", "payload": {"n": 1}}, headers=hdr())
        jid = doc["job_id"]
        await wait_state(s, jid)
        _, doc = await rec.call("get", f"/api/v1/jobs/{jid}?events=true&result=true",
                                headers=hdr())
        await rec.call("get", f"/api/v1/traces/{doc['trace_id']}", headers=hdr())
        await rec.call("get", "/api/v1/traces", headers=hdr())
        await rec.call("get", "/api/v1/jobs", headers=hdr())
        await rec.call("get", "/api/v1/jobs?state=SUCCEEDED", headers=hdr())
        await rec.call("get", "/api/v1/jobs/nope", headers=hdr())
        return s.responder.seen

    t = both(scenario)
    assert t["requests"][1][1] == 200 and t["requests"][1][2]["state"] == "SUCCEEDED"
    assert t["requests"][1][2]["result"] == {"done": True, "echo": {"n": 1}}
    assert len(t["extra"]) == 1


def test_submit_validation_idempotency_and_secrets():
    async def scenario(s, rec):
        await rec.call("post", "/api/v1/jobs", json={"payload": {}}, headers=hdr())
        await rec.call("post", "/api/v1/jobs", data=b"not json", headers=hdr())
        for _ in range(2):
            await rec.call("post", "/api/v1/jobs",
                           json={"topic": "job.work", "idempotency_key": "k1"}, headers=hdr())
        await rec.call("post", "/api/v1/jobs", json={"topic": "job.work"},
                       headers=hdr(**{"Idempotency-Key": "k2"}))
        _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(), json={
            "topic": "job.work", "payload": {"token": "secret://vault/x"}})
        req = await s.job_store.get_request(doc["job_id"])
        return {"labels": req.labels, "risk_tags": req.metadata.risk_tags}

    t = both(scenario)
    assert [r[1] for r in t["requests"]] == [400, 400, 202, 200, 202, 202]
    assert t["requests"][3][2].get("deduplicated")
    assert t["extra"]["labels"]["secrets_present"] == "true"


def test_bulk_submit():
    async def scenario(s, rec):
        _, doc = await rec.call("post", "/api/v1/jobs:batch", headers=hdr(), json={"jobs": [
            {"topic": "job.work", "payload": {"n": 0}},
            {"topic": "job.work", "payload": {"op": "embed", "texts": ["hi"]}},
            {"payload": {"missing": "topic"}}]})
        for entry in doc["jobs"][:2]:
            await wait_state(s, entry["job_id"])
        await rec.call("post", "/api/v1/jobs:batch", json={"jobs": []}, headers=hdr())
        await rec.call("post", "/api/v1/jobs:batch", json={}, headers=hdr())
        await rec.call("post", "/api/v1/jobs:batch", headers=hdr(),
                       json={"jobs": [{"payload": {}}, "not-a-dict"]})
        await rec.call("post", "/api/v1/jobs:batch", headers=hdr(),
                       json={"jobs": [{"topic": "job.work"}] * (s.pkg.app.MAX_BULK_JOBS + 1)})
        metas = [await s.job_store.get_meta(e["job_id"]) for e in doc["jobs"][:2]]
        req = await s.job_store.get_request(doc["jobs"][1]["job_id"])
        return {"states": [m["state"] for m in metas], "labels": req.labels}

    t = both(scenario)
    assert t["extra"]["states"] == ["SUCCEEDED", "SUCCEEDED"]
    assert t["extra"]["labels"]["cordum.batch_key"] == "embed"
    assert [r[1] for r in t["requests"]] == [202, 400, 400, 400, 400]


def test_cancel():
    async def scenario(s, rec):
        _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                json={"topic": "job.nopool", "payload": {}})
        jid = doc["job_id"]
        await settle(s)
        await rec.call("post", f"/api/v1/jobs/{jid}/cancel", headers=hdr())
        await settle(s)
        await rec.call("get", f"/api/v1/jobs/{jid}", headers=hdr())
        await rec.call("post", f"/api/v1/jobs/{jid}/cancel", headers=hdr())
        await rec.call("post", "/api/v1/jobs/missing/cancel", headers=hdr())
        return await s.job_store.get_state(jid)

    assert both(scenario)["extra"] == "CANCELLED"


# ---------------------------------------------------------------- approvals


def test_approval_and_rejection():
    async def scenario(s, rec):
        ids = []
        for topic in ("job.deploy.api", "job.deploy.x"):
            _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                    json={"topic": topic, "payload": {}})
            ids.append(doc["job_id"])
        await settle(s)
        approve, reject = ids
        await rec.call("get", f"/api/v1/jobs/{approve}", headers=hdr())
        await rec.call("get", "/api/v1/approvals", headers=hdr())
        await rec.call("post", f"/api/v1/approvals/{approve}/approve", headers=hdr())
        await rec.call("post", f"/api/v1/approvals/{approve}/approve", headers=hdr(admin=True))
        await settle(s)
        await rec.call("get", f"/api/v1/jobs/{approve}", headers=hdr())
        await rec.call("post", f"/api/v1/approvals/{reject}/reject", json={"reason": "too risky"},
                       headers=hdr(admin=True))
        await rec.call("get", f"/api/v1/jobs/{reject}", headers=hdr())
        await rec.call("get", "/api/v1/approvals", headers=hdr())
        a = await s.job_store.get_approval(approve)
        d = await s.job_store.get_safety_decision(approve)
        return {"approved": a.approved, "by": a.approved_by, "hash": a.job_hash,
                "decision_hash": d.job_hash}

    t = both(scenario)
    states = [r[2].get("state") for r in t["requests"] if r[0].startswith("GET /api/v1/jobs/")]
    assert states == ["APPROVAL_REQUIRED", "RUNNING", "DENIED"]
    # the approval record's hash is the one the scheduler's decision holds
    assert t["extra"]["approved"] and t["extra"]["hash"] == t["extra"]["decision_hash"]


def test_remediation():
    async def scenario(s, rec):
        _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                json={"topic": "job.deploy.api", "payload": {"x": 1}})
        jid = doc["job_id"]
        await settle(s)
        _, doc = await rec.call("post", f"/api/v1/jobs/{jid}/remediate", headers=hdr(),
                                json={"remediation_id": "use-staging"})
        new = doc["job_id"]
        await wait_state(s, new)
        await rec.call("get", f"/api/v1/jobs/{new}?result=true", headers=hdr())
        await rec.call("post", f"/api/v1/jobs/{jid}/remediate", headers=hdr(),
                       json={"remediation_id": "nope"})
        return (await s.job_store.get_request(new)).labels

    assert both(scenario)["extra"]["env"] == "staging"


# ---------------------------------------------------------------- DLQ


def test_dlq_list_retry_delete_purge():
    async def scenario(s, rec):
        ids = []
        for _ in range(2):
            _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                    json={"topic": "job.work", "payload": {"fail": True}})
            ids.append(doc["job_id"])
            await wait_state(s, doc["job_id"])
        await settle(s)
        await rec.call("get", "/api/v1/dlq", headers=hdr())
        _, doc = await rec.call("post", f"/api/v1/dlq/{ids[0]}/retry", headers=hdr())
        await wait_state(s, doc["job_id"])
        await settle(s)
        meta = await s.job_store.get_meta(doc["job_id"])
        await rec.call("get", "/api/v1/dlq?limit=1", headers=hdr())
        await rec.call("delete", f"/api/v1/dlq/{doc['job_id']}", headers=hdr())
        await rec.call("post", "/api/v1/dlq/retry-all", headers=hdr(admin=True))
        await settle(s)
        await rec.call("post", "/api/v1/dlq/purge", headers=hdr(admin=True))
        await rec.call("get", "/api/v1/dlq", headers=hdr())
        await rec.call("post", "/api/v1/dlq/missing/retry", headers=hdr())
        return meta.get("retried_from") == ids[0]

    assert both(scenario)["extra"] is True


# ---------------------------------------------------------------- workflows


def test_workflow_routes():
    async def scenario(s, rec):
        wf = {"id": "wf-http", "name": "t",
              "steps": {"a": {"topic": "job.work", "input": {"n": "${input.n}"}},
                        "b": {"topic": "job.work", "depends_on": ["a"],
                              "input": {"prev": "${steps.a.echo.n}"}}}}
        await rec.call("post", "/api/v1/workflows", json=wf, headers=hdr())
        await rec.call("post", "/api/v1/workflows", headers=hdr(),
                       json={"id": "bad", "steps": {"a": {"topic": "t", "depends_on": ["z"]}}})
        await rec.call("get", "/api/v1/workflows", headers=hdr())
        await rec.call("get", "/api/v1/workflows/wf-http", headers=hdr())
        _, doc = await rec.call("post", "/api/v1/workflows/wf-http/runs",
                                json={"input": {"n": 5}}, headers=hdr())
        run_id = doc["run_id"]
        for _ in range(100):
            await settle(s, 2)
            run = await s.wf_store.get_run(run_id)
            if run.status in ("SUCCEEDED", "FAILED"):
                break
        await rec.call("get", f"/api/v1/runs/{run_id}", headers=hdr())
        await rec.call("get", f"/api/v1/runs/{run_id}/timeline", headers=hdr())
        await rec.call("get", "/api/v1/runs", headers=hdr())
        for _ in range(2):
            await rec.call("post", "/api/v1/workflows/wf-http/runs", json={},
                           headers=hdr(**{"Idempotency-Key": "run-1"}))
        await settle(s)
        await rec.call("post", f"/api/v1/runs/{run_id}/rerun", json={"from_step": "b"},
                       headers=hdr())
        await settle(s)
        await rec.call("delete", "/api/v1/workflows/wf-http", headers=hdr())
        await rec.call("get", "/api/v1/workflows/wf-http", headers=hdr())

    t = both(scenario)
    run = next(r for r in t["requests"] if r[0].startswith("GET /api/v1/runs/")
               and "timeline" not in r[0])
    assert run[2]["status"] == "SUCCEEDED"
    assert run[2]["context"]["steps"]["b"] == {"done": True, "echo": {"prev": 5}}


# ---------------------------------------------------------------- admin surfaces


def test_policy_config_schemas_locks_artifacts_memory():
    async def scenario(s, rec):
        await rec.call("post", "/api/v1/policy/evaluate", json={"topic": "job.deploy.api"},
                       headers=hdr())
        await rec.call("post", "/api/v1/policy/explain", json={"topic": "job.deploy.api"},
                       headers=hdr())
        await rec.call("post", "/api/v1/policy/simulate", headers=hdr(), json={
            "policy": {"rules": [{"id": "d", "match": {"topics": ["job.*"]},
                                  "decision": "deny"}]},
            "requests": [{"topic": "job.x"}]})
        await rec.call("get", "/api/v1/policy/snapshots", headers=hdr())
        data = {"data": {"models": {"default_model": "llama"}}}
        await rec.call("put", "/api/v1/config/system/default", json=data, headers=hdr())
        await rec.call("put", "/api/v1/config/system/default", json=data, headers=hdr(admin=True))
        await rec.call("get", "/api/v1/config/system/default", headers=hdr())
        await rec.call("get", "/api/v1/config/effective", headers=hdr())
        before = s.kernel.snapshot_id
        await rec.call("put", "/api/v1/config/system/policy/frag1", headers=hdr(admin=True),
                       json={"data": {"enabled": True, "rules": [
                           {"id": "f", "match": {"topics": ["job.frag"]}, "decision": "deny"}]}})
        await rec.call("post", "/api/v1/policy/evaluate", json={"topic": "job.frag"},
                       headers=hdr())
        await rec.call("put", "/api/v1/schemas/s1", json={"type": "object", "required": ["x"]},
                       headers=hdr())
        await rec.call("put", "/api/v1/schemas/s2", json={"type": "nonsense"}, headers=hdr())
        await rec.call("get", "/api/v1/schemas/s1", headers=hdr())
        await rec.call("get", "/api/v1/schemas", headers=hdr())
        await rec.call("delete", "/api/v1/schemas/s1", headers=hdr())
        await rec.call("get", "/api/v1/schemas/s1", headers=hdr())
        await rec.call("post", "/api/v1/locks/res1/acquire", json={"owner": "me"}, headers=hdr())
        await rec.call("post", "/api/v1/locks/res1/acquire", json={"owner": "you"},
                       headers=hdr())
        await rec.call("get", "/api/v1/locks", headers=hdr())
        await rec.call("post", "/api/v1/locks/res1/release", json={"owner": "you"},
                       headers=hdr())
        await rec.call("post", "/api/v1/locks/res1/release", json={"owner": "me"}, headers=hdr())
        _, doc = await rec.call("post", "/api/v1/artifacts?retention=short", data=b"blob",
                                headers=hdr())
        await rec.call("get", f"/api/v1/artifacts/{doc['artifact_id']}", headers=hdr(),
                       raw=True)
        await rec.call("get", "/api/v1/artifacts/missing", headers=hdr())
        ptr = await s.mem.put_context("jx", {"v": 1})
        await rec.call("get", f"/api/v1/memory?ptr={ptr}", headers=hdr())
        return s.kernel.snapshot_id != before

    assert both(scenario)["extra"] is True


def test_workers_status_metrics_health():
    async def scenario(s, rec):
        _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                json={"topic": "job.work", "payload": {"n": 2}})
        await wait_state(s, doc["job_id"])
        await rec.call("get", "/api/v1/workers", headers=hdr())
        await rec.call("post", "/api/v1/workers/w1/drain", headers=hdr(admin=True))
        await rec.call("get", "/api/v1/status", headers=hdr())
        await rec.call("get", "/healthz")
        await rec.call("get", "/api/v1/fleet", headers=hdr())
        await rec.call("get", "/api/v1/capacity", headers=hdr())
        await rec.call("get", "/api/v1/gangs", headers=hdr())
        await rec.call("get", "/api/v1/admission", headers=hdr())
        await rec.call("get", "/api/v1/traces/analysis", headers=hdr())
        r = await s.client.get("/metrics", headers=hdr())
        text = await r.text()
        r2 = await s.client.get("/metrics?scope=fleet", headers=hdr())
        return {"metrics": metric_lines(text), "status": r.status,
                "fleet": metric_lines(await r2.text()), "fleet_status": r2.status}

    t = both(scenario)
    assert any(line.startswith("cordum_http_requests_total") for line in t["extra"]["metrics"])
    assert t["extra"]["status"] == 200


def test_dashboard_served():
    async def scenario(s, rec):
        for path in ("/", "/ui/app.js", "/ui/style.css"):
            await rec.call("get", path, raw=True)

    t = both(scenario)
    assert [r[1] for r in t["requests"]] == [200, 200, 200]


def test_context_routes():
    async def scenario(s, rec):
        s.gw.context_svc = s.pkg.context.ContextService(s.kv)
        await rec.call("post", "/api/v1/context/memory/m1", headers=hdr(),
                       json={"payload": "hello", "model_response": "world"})
        await rec.call("post", "/api/v1/context/window", headers=hdr(),
                       json={"memory_id": "m1", "mode": "CHAT", "payload": "next"})
        await rec.call("put", "/api/v1/context/chunks/m1", headers=hdr(),
                       json={"chunks": [{"file_path": "a.py", "content": "def next(): pass"},
                                        {"file_path": "b.md", "content": "notes"}]})
        await rec.call("post", "/api/v1/context/window", headers=hdr(),
                       json={"memory_id": "m1", "mode": "RAG", "payload": "next",
                             "max_input_tokens": 64})

    t = both(scenario)
    assert [m["content"] for m in t["requests"][1][2]["messages"]] == ["hello", "world", "next"]


# ---------------------------------------------------------------- WebSocket


def test_ws_stream_events_in_order():
    """One job's lifecycle as the stream shows it: the subjects and packets
    in the order they arrived (ids counted, times normalised)."""
    async def scenario(s, rec):
        ws = await s.client.ws_connect("/api/v1/stream", headers=hdr())
        await settle(s)
        _, doc = await rec.call("post", "/api/v1/jobs", headers=hdr(),
                                json={"topic": "job.work", "payload": {"ws": 1}})
        await wait_state(s, doc["job_id"])
        await settle(s)
        events = []
        while True:
            try:
                msg = await asyncio.wait_for(ws.receive_json(), 0.5)
            except asyncio.TimeoutError:
                break
            events.append(norm(msg))
        await ws.close()
        bad = []
        with contextlib.suppress(Exception):
            await s.client.ws_connect("/api/v1/stream", protocols=("wrong-key",))
            bad.append("accepted")
        ws2 = await s.client.ws_connect("/api/v1/stream", protocols=("user-key",))
        proto = ws2._response.headers.get("Sec-WebSocket-Protocol")
        await ws2.close()
        return {"events": events, "bad": bad, "proto": proto}

    t = both(scenario)
    subjects = [e["subject"] for e in t["extra"]["events"]]
    assert subjects and all(sj.startswith("sys.job.") for sj in subjects)
    assert "sys.job.result" in subjects
    assert t["extra"]["bad"] == [] and t["extra"]["proto"] == "user-key"


# ---------------------------------------------------------------- rate limit


def test_rate_limit_and_concurrent_run_cap():
    async def scenario(s, rec):
        for _ in range(4):
            await rec.call("get", "/api/v1/jobs", headers=hdr())
        await rec.call("get", "/api/v1/jobs", headers=hdr(admin=True))

    # one token a hundred seconds: no refill between the requests
    t = both(scenario, gateway_kw={"rate_rps": 0.01})
    statuses = [r[1] for r in t["requests"]]
    assert 429 in statuses and statuses[0] == 200


@pytest.mark.parametrize("rps,burst", [(0.0, 5), (2.0, 3), (5.0, 8)])
def test_token_bucket_decisions(monkeypatch, rps, burst):
    """``TokenBucket`` under an injected clock: the same allow/deny
    sequence from both packages."""
    outs = []
    for root in PACKAGES:
        auth = importlib.import_module(f"{root}.controlplane.gateway.auth")
        now = [100.0]
        monkeypatch.setattr(auth, "time", SimpleNamespace(monotonic=lambda: now[0]))
        tb = auth.TokenBucket(rps, burst=burst)
        seq = []
        for i in range(40):
            now[0] += (i % 5) * 0.02
            seq.append(tb.allow("k0" if i % 4 else "k1"))
        outs.append(seq)
    assert outs[1] == outs[0]
    assert (False in outs[0]) == (rps > 0)


# ---------------------------------------------------------------- packs, bundles

REPO_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
DENY_BUNDLE = {"rules": [{"id": "no-x", "match": {"topics": ["job.x"]}, "decision": "deny"}]}


def test_policy_bundles_snapshots_and_audit():
    async def scenario(s, rec):
        await rec.call("put", "/api/v1/policy/bundles/team~frag", json=DENY_BUNDLE, headers=hdr())
        await rec.call("put", "/api/v1/policy/bundles/team~frag", json=DENY_BUNDLE,
                       headers=hdr(admin=True))
        await rec.call("get", "/api/v1/policy/bundles", headers=hdr())
        await rec.call("get", "/api/v1/policy/bundles/team~frag", headers=hdr())
        await rec.call("post", "/api/v1/policy/bundles/team~frag/simulate", headers=hdr(),
                       json={"requests": [{"topic": "job.x"}, {"topic": "job.y"}]})
        await rec.call("post", "/api/v1/policy/evaluate", json={"topic": "job.x"}, headers=hdr())
        _, cap = await rec.call("post", "/api/v1/policy/snapshots/capture", json={"note": "n"},
                                headers=hdr(admin=True))
        await rec.call("post", "/api/v1/policy/bundles/team~frag/publish", headers=hdr(admin=True))
        await rec.call("post", "/api/v1/policy/evaluate", json={"topic": "job.x"}, headers=hdr())
        await rec.call("post", "/api/v1/policy/bundles/team~frag/unpublish",
                       headers=hdr(admin=True))
        await rec.call("post", "/api/v1/policy/bundles/team~frag/publish", headers=hdr(admin=True))
        await rec.call("get", "/api/v1/policy/snapshots/captured", headers=hdr())
        await rec.call("post", f"/api/v1/policy/snapshots/{cap['snapshot_id']}/rollback",
                       headers=hdr(admin=True))
        await rec.call("post", "/api/v1/policy/evaluate", json={"topic": "job.x"}, headers=hdr())
        await rec.call("delete", "/api/v1/policy/bundles/team~frag", headers=hdr(admin=True))
        await rec.call("get", "/api/v1/policy/bundles/team~frag", headers=hdr())
        await rec.call("get", "/api/v1/policy/audit", headers=hdr())

    t = both(scenario)
    decisions = [r[2]["decision"] for r in t["requests"] if r[0] == "POST /api/v1/policy/evaluate"]
    assert decisions == ["ALLOW", "DENY", "ALLOW"]


def test_packs_and_catalogs(tmp_path):
    import shutil

    shutil.copytree(REPO_ROOT / "examples" / "hello-pack", tmp_path / "hello-pack")

    async def scenario(s, rec):
        m = importlib.import_module(f"{s.pkg.root}.packs").load_pack_dir(
            str(REPO_ROOT / "examples" / "demo-guardrails"))
        doc = {"id": m.id, "name": m.name, "version": m.version, "topics": m.topics,
               "resources": {"workflows": m.workflows, "schemas": m.schemas},
               "overlays": {"config": m.config_overlays, "policy": m.policy_overlays},
               "simulations": m.simulations}
        await rec.call("post", "/api/v1/packs", json=doc, headers=hdr())
        await rec.call("post", "/api/v1/packs", json=doc, headers=hdr(admin=True))
        await rec.call("get", "/api/v1/packs", headers=hdr())
        await rec.call("get", f"/api/v1/packs/{m.id}", headers=hdr())
        await rec.call("post", "/api/v1/policy/evaluate", headers=hdr(), json={
            "topic": "job.x", "metadata": {"risk_tags": ["destructive"]}})
        await rec.call("get", "/api/v1/config/effective", headers=hdr())
        bad = dict(doc, id="broken", simulations=[
            {"name": "wrong", "request": {"topic": "job.y"}, "expect": "DENY"}])
        await rec.call("post", "/api/v1/packs", json=bad, headers=hdr(admin=True))
        await rec.call("post", "/api/v1/pack-catalogs", headers=hdr(admin=True), json={
            "name": "local", "path": str(tmp_path), "allowed_roots": [str(tmp_path)]})
        await rec.call("post", "/api/v1/pack-catalogs", headers=hdr(admin=True), json={
            "name": "evil", "path": str(REPO_ROOT / "examples")})
        await rec.call("get", "/api/v1/pack-catalogs", headers=hdr())
        await rec.call("get", "/api/v1/pack-catalogs/local/packs", headers=hdr())
        await rec.call("post", "/api/v1/pack-catalogs/local/install/hello-pack",
                       headers=hdr(admin=True))
        await rec.call("post", "/api/v1/pack-catalogs/local/install/nope",
                       headers=hdr(admin=True))
        await rec.call("get", "/api/v1/workflows/hello-pack-echo", headers=hdr())
        await rec.call("delete", f"/api/v1/packs/{m.id}", headers=hdr(admin=True))
        await rec.call("delete", "/api/v1/packs/hello-pack", headers=hdr(admin=True))
        await rec.call("get", "/api/v1/packs", headers=hdr())

    t = both(scenario)
    statuses = {r[0]: r[1] for r in t["requests"]}
    assert statuses["POST /api/v1/pack-catalogs/local/install/hello-pack"] == 201
    assert [r[1] for r in t["requests"][:2]] == [403, 201]
