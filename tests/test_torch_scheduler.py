"""The port's scheduler against the JAX package's, scenario by scenario.

Each scenario is built twice, once from each package, from the same
documents and inputs: a ``LoopbackBus`` (``sync=True`` unless the scenario
needs event-loop ticks), a ``MemoryKV``, the same pools and policy
documents, the same heartbeats, ``random.seed`` fixed (the engine draws
its NAK jitter from ``random``).  The traces must be equal once new ids
and timestamps are normalised: each job's chosen subject and meta, its
sequence of states and events, its DLQ reason and code, its safety
decision record, and every packet the scheduler sent a worker.

The port's scheduler picks with its native C scan where this host has a
C compiler (``tests/test_torch_native_scan.py`` holds the scan to the
Python scan and the reference's); the reference's picks as it picks here.
"""
from __future__ import annotations

import asyncio
import dataclasses
import importlib
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("cordum_tpu", "cordum_tpu_torch")
SEED = 0
POOLS = {"topics": {"job.default": "default", "job.gpu.>": "gpu", "job.gang": "gangpool"},
         "pools": {"default": {}, "gpu": {"requires": ["gpu"], "min_chips": 1},
                   "gangpool": {}}}
TENANTS = {"default": {"allow_topics": ["job.*", "job.>"]}}
VOLATILE = ("_us", "trace_id", "policy_snapshot")


class Pkg:
    """One package's scheduler modules, by their shared names."""

    def __init__(self, root):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.root = root
        self.engine = m("controlplane.scheduler.engine")
        self.strategy = m("controlplane.scheduler.strategy")
        self.reconciler = m("controlplane.scheduler.reconciler")
        self.gang = m("controlplane.scheduler.gang")
        self.safety_client = m("controlplane.scheduler.safety_client")
        self.kernel = m("controlplane.safetykernel.kernel")
        self.bus = m("infra.bus")
        self.kv = m("infra.kv")
        self.config = m("infra.config")
        self.jobstore = m("infra.jobstore")
        self.memstore = m("infra.memstore")
        self.registry = m("infra.registry")
        self.subj = m("protocol.subjects")
        self.types = m("protocol.types")
        self.jobhash = m("protocol.jobhash")


async def make(pkg, *, policy=None, sync=True, heartbeats=(), **engine_kw):
    random.seed(SEED)
    kv = pkg.kv.MemoryKV()
    bus = pkg.bus.LoopbackBus(sync=sync)
    js = pkg.jobstore.JobStore(kv)
    reg = pkg.registry.WorkerRegistry()
    pc = pkg.config.parse_pool_config(POOLS)
    kernel = pkg.kernel.SafetyKernel(policy_doc=policy or {"tenants": TENANTS})
    eng = pkg.engine.Engine(bus=bus, job_store=js,
                            safety=pkg.safety_client.SafetyClient(kernel.check),
                            strategy=pkg.strategy.LeastLoadedStrategy(reg, pc),
                            registry=reg, **engine_kw)
    for hb in heartbeats:
        reg.update(pkg.types.Heartbeat(**hb))
    await eng.start()
    return SimpleNamespace(pkg=pkg, kv=kv, bus=bus, js=js, reg=reg, pc=pc, eng=eng,
                           mem=pkg.memstore.MemoryStore(kv))


def _plain(d):
    return {k: v for k, v in d.items() if not any(k.endswith(x) for x in VOLATILE)}


async def trace(s, job_ids):
    """The normalised trace of ``job_ids`` on stack ``s``."""
    T = s.pkg.types
    out = {}
    for jid in job_ids:
        rec = await s.js.get_safety_decision(jid)
        out[jid] = {
            "meta": _plain(await s.js.get_meta(jid)),
            "events": [_plain(e) for e in await s.js.events(jid)],
            "decision": None if rec is None else _plain(dataclasses.asdict(rec)),
            "request": None if (r := await s.js.get_request(jid)) is None else r.to_dict(),
        }
    sent = []
    for subject, pkt in s.bus.published:
        if subject in (s.pkg.subj.SUBMIT, s.pkg.subj.HEARTBEAT):
            continue
        body = pkt.to_dict()
        for k in ("trace_id", "span_id", "parent_span_id", "created_at_us", "msg_id",
                  "sender_id"):
            body.pop(k, None)
        if isinstance(pkt.payload, T.JobRequest) or isinstance(pkt.payload, T.JobResult):
            sent.append((subject, body))
    out["packets"] = sent
    out["dlq"] = [(p.job_result.job_id, p.job_result.error_code, p.job_result.error_message)
                  for subject, p in s.bus.published if subject == s.pkg.subj.DLQ]
    return out


def both(scenario, **make_kw):
    """Run ``scenario(stack)`` (returning the job ids to trace) on each
    package; the traces must be equal.  Returns them."""
    async def one(root):
        s = await make(Pkg(root), **make_kw)
        try:
            ids = await scenario(s)
            if not s.bus._sync:
                await s.bus.drain()
            return await trace(s, ids)
        finally:
            await s.eng.stop()

    ref, port = (asyncio.run(one(root)) for root in PACKAGES)
    assert port == ref
    return ref


def hb(worker_id, pool="default", **kw):
    return {"worker_id": worker_id, "pool": pool, "max_parallel_jobs": 10, **kw}


def submit(s, job_id, topic="job.default", **kw):
    T = s.pkg.types
    return s.bus.publish(s.pkg.subj.SUBMIT, T.BusPacket.wrap(
        T.JobRequest(job_id=job_id, topic=topic, **kw), sender_id="gateway"))


def result(s, job_id, status="SUCCEEDED", **kw):
    T = s.pkg.types
    return s.bus.publish(s.pkg.subj.RESULT, T.BusPacket.wrap(T.JobResult(
        job_id=job_id, status=status, result_ptr=f"kv://res:{job_id}", **kw), sender_id="w"))


def requires(s, *reqs):
    return s.pkg.types.JobMetadata(requires=list(reqs))


# ---------------------------------------------------------------- routing

def test_least_loaded_routing():
    async def scenario(s):
        for i, load in enumerate((5, 1, 1, 0)):
            s.reg.update(s.pkg.types.Heartbeat(**hb(f"w{i}", active_jobs=load,
                                                     cpu_load=50.0 * (i == 2))))
        s.reg.update(s.pkg.types.Heartbeat(**hb("w3", active_jobs=9)))  # overloaded
        for i in range(3):
            await submit(s, f"j{i}", tenant_id="t")
            await result(s, f"j{i}")
        return ["j0", "j1", "j2"]

    t = both(scenario)
    assert t["j0"]["meta"]["dispatch_subject"] == "worker.w1.jobs"
    assert t["j0"]["meta"]["state"] == "SUCCEEDED"


def test_chips_and_topology_requirements():
    fleet = [hb("cpu1", "gpu", capabilities=["echo"], chip_count=8),
             hb("g1", "gpu", capabilities=["gpu"], chip_count=1),
             hb("g4", "gpu", capabilities=["gpu"], chip_count=4, slice_topology="2x2"),
             hb("g8", "gpu", capabilities=["gpu"], chip_count=8, slice_topology="2x4",
                active_jobs=3)]

    async def scenario(s):
        await submit(s, "any", "job.gpu.echo")
        await submit(s, "chips8", "job.gpu.echo", metadata=requires(s, "chips:8"))
        await submit(s, "topo", "job.gpu.echo", metadata=requires(s, "topology:2x2"))
        await submit(s, "both", "job.gpu.echo", metadata=requires(s, "chips:4", "topology:2x4"))
        return ["any", "chips8", "topo", "both"]

    t = both(scenario, heartbeats=fleet)
    assert [t[j]["meta"]["dispatch_subject"] for j in ("any", "chips8", "topo", "both")] == [
        "worker.g1.jobs", "worker.g8.jobs", "worker.g4.jobs", "worker.g8.jobs"]


def test_no_eligible_worker_falls_to_the_topic():
    async def scenario(s):
        await submit(s, "big", "job.gpu.echo", metadata=requires(s, "chips:16"))
        await submit(s, "unrouted", "job.nowhere")
        return ["big", "unrouted"]

    t = both(scenario, heartbeats=[hb("g1", "gpu", capabilities=["gpu"], chip_count=1)])
    assert t["big"]["meta"]["dispatch_subject"] == "job.gpu.echo"
    assert t["unrouted"]["meta"]["dispatch_subject"] == "job.nowhere"


# ---------------------------------------------------------------- safety

POLICY = {"tenants": TENANTS, "rules": [
    {"id": "deny-bad", "match": {"topics": ["job.bad"]}, "decision": "deny", "reason": "nope"},
    {"id": "approve-big", "match": {"topics": ["job.big"]}, "decision": "require_approval",
     "reason": "big jobs need a human"},
    {"id": "slow", "match": {"topics": ["job.slow"]}, "decision": "throttle",
     "reason": "rate", "throttle_delay_s": 0.001},
    {"id": "constrain", "match": {"topics": ["job.gpu.>"]},
     "decision": "allow_with_constraints",
     "constraints": {"max_chips": 4, "max_tokens": 100, "env": {"SANDBOX": "strict"}}},
]}


def test_deny_goes_to_the_dlq():
    async def scenario(s):
        await submit(s, "d", "job.bad")
        return ["d"]

    t = both(scenario, policy=POLICY, heartbeats=[hb("w1")])
    assert t["d"]["meta"]["state"] == "DENIED" and t["dlq"][0][1] == "SAFETY_DENY"
    assert t["d"]["decision"]["rule_id"] == "deny-bad"


def test_require_approval_and_the_hash_recheck():
    async def scenario(s):
        T = s.pkg.types
        labels = {"x": "1"}
        await submit(s, "a", "job.big", labels=dict(labels))
        req = T.JobRequest(job_id="a", topic="job.big", labels=dict(labels))
        assert (await s.js.get_safety_decision("a")).job_hash == s.pkg.jobhash.job_hash(req)
        granted = {T.LABEL_APPROVAL_GRANTED: "true"}
        await submit(s, "a", "job.big", labels={"x": "EVIL", **granted})  # edited: refused
        assert await s.js.get_state("a") == "APPROVAL_REQUIRED"
        await submit(s, "a", "job.big", labels={**labels, **granted})  # faithful
        await result(s, "a")
        return ["a"]

    t = both(scenario, policy=POLICY, heartbeats=[hb("w1")])
    assert [e["state"] for e in t["a"]["events"]][:3] == ["PENDING", "APPROVAL_REQUIRED",
                                                          "SCHEDULED"]
    assert t["a"]["meta"]["state"] == "SUCCEEDED"


def test_throttle_and_constraints():
    async def scenario(s):
        T = s.pkg.types
        await submit(s, "c", "job.gpu.echo", budget=T.Budget(max_tokens=99999))
        req = T.JobRequest(job_id="t", topic="job.slow")
        for _ in range(4):  # backpressure: no attempt is burnt
            with pytest.raises(s.pkg.bus.RetryAfter):
                await s.eng.handle_job_request(req)
        return ["c", "t"]

    t = both(scenario, policy=POLICY, max_attempts=2,
             heartbeats=[hb("w1"), hb("g1", "gpu", capabilities=["gpu"], chip_count=8)])
    sent = [body for subject, body in t["packets"] if subject == "worker.g1.jobs"][0]
    env = sent["payload"]["env"]
    assert env["CORDUM_MAX_CHIPS"] == "4" and env["SANDBOX"] == "strict"
    assert "CORDUM_POLICY_CONSTRAINTS" in env
    assert sent["payload"]["budget"]["max_tokens"] == 100
    assert t["c"]["decision"]["rule_id"] == "constrain"
    assert t["t"]["meta"]["state"] == "PENDING" and t["t"]["meta"].get("attempts", "0") == "0"


# ---------------------------------------------------------------- limits

def test_max_attempts():
    async def scenario(s):
        T = s.pkg.types
        JS = s.pkg.types.JobState
        await s.js.put_request(T.JobRequest(job_id="m", topic="job.default"))
        await s.js.set_state("m", JS.PENDING)
        await s.js.set_state("m", JS.SCHEDULED)
        await s.js.set_fields("m", {"attempts": str(s.eng.max_attempts)})
        rep = s.pkg.reconciler.PendingReplayer(
            s.eng, s.js, s.pkg.config.Timeouts(dispatch_timeout_s=0.0, pending_replay_s=0.0))
        await asyncio.sleep(0.01)
        await rep.run_once()
        return ["m"]

    t = both(scenario, heartbeats=[hb("w1")], max_attempts=2)
    assert t["m"]["meta"]["state"] == "FAILED" and t["dlq"]


def test_tenant_concurrency():
    async def scenario(s):
        RetryAfter = s.pkg.bus.RetryAfter
        T = s.pkg.types
        await s.eng.handle_job_request(T.JobRequest(job_id="t1", topic="job.default",
                                                    tenant_id="t"))
        with pytest.raises(RetryAfter):
            await s.eng.handle_job_request(T.JobRequest(job_id="t2", topic="job.default",
                                                        tenant_id="t"))
        await s.eng.handle_job_request(T.JobRequest(job_id="o1", topic="job.default",
                                                    tenant_id="other"))
        await result(s, "t1")
        await s.eng.handle_job_request(T.JobRequest(job_id="t2", topic="job.default",
                                                    tenant_id="t"))
        return ["t1", "t2", "o1"]

    t = both(scenario, heartbeats=[hb("w1")], tenant_concurrency_limit=1)
    assert t["t2"]["meta"]["state"] == "RUNNING"


def test_sixty_four_submits_in_one_tick():
    async def scenario(s):
        for i in range(64):
            await submit(s, f"b{i:02d}", "job.gpu.echo" if i % 2 else "job.default",
                         tenant_id="t")
        await asyncio.sleep(0)
        await s.bus.drain()
        assert s.eng.metrics.sched_tick_batch.quantile(1.0) >= 32  # one grouped tick
        for i in range(64):
            await result(s, f"b{i:02d}")
        await s.bus.drain()
        return [f"b{i:02d}" for i in range(64)]

    t = both(scenario, sync=False,
             heartbeats=[hb("w1"), hb("w2", active_jobs=1),
                         hb("g1", "gpu", capabilities=["gpu"], chip_count=1)])
    assert all(t[f"b{i:02d}"]["meta"]["state"] == "SUCCEEDED" for i in range(64))


def test_redelivered_result_is_idempotent():
    async def scenario(s):
        await submit(s, "r")
        await result(s, "r")
        await result(s, "r")
        await result(s, "r", status="FAILED", error_code="LATE")
        await submit(s, "r")  # a redelivered submit after the end: no-op
        return ["r"]

    t = both(scenario, heartbeats=[hb("w1")])
    assert [e["state"] for e in t["r"]["events"]].count("SUCCEEDED") == 1
    assert not t["dlq"]


def test_cancel():
    async def scenario(s):
        T = s.pkg.types
        await submit(s, "c")
        await s.bus.publish(s.pkg.subj.CANCEL, T.BusPacket.wrap(
            T.JobCancel(job_id="c", reason="user")))
        await result(s, "c")  # a result after the cancel changes nothing
        return ["c"]

    t = both(scenario, heartbeats=[hb("w1")])
    assert t["c"]["meta"]["state"] == "CANCELLED"


def test_reconciler_timeouts_and_the_pending_replayer():
    async def scenario(s):
        T = s.pkg.types
        JS = T.JobState
        Timeouts = s.pkg.config.Timeouts
        await s.js.set_state("stale", JS.PENDING)
        await s.js.set_state("stale", JS.SCHEDULED)
        await s.js.set_state("stale", JS.DISPATCHED)
        await s.js.set_state("stale", JS.RUNNING)
        await s.js.set_state("late", JS.PENDING)
        await s.js.set_state("late", JS.SCHEDULED)
        await s.js.set_state("late", JS.DISPATCHED)
        await s.js.set_state("late", JS.RUNNING)
        await s.js.register_deadline("late", int(time.time() * 1000) - 1000)
        await s.js.put_request(T.JobRequest(job_id="p", topic="job.default"))
        await s.js.set_state("p", JS.PENDING)
        await asyncio.sleep(0.01)
        rec = s.pkg.reconciler.Reconciler(
            s.js, Timeouts(dispatch_timeout_s=9999, running_timeout_s=9999))
        assert await rec.run_once() == 1  # the deadline
        rec = s.pkg.reconciler.Reconciler(
            s.js, Timeouts(dispatch_timeout_s=0.0, running_timeout_s=0.0))
        assert await rec.run_once() == 1  # the stale running job
        rep = s.pkg.reconciler.PendingReplayer(
            s.eng, s.js, Timeouts(dispatch_timeout_s=0.0, pending_replay_s=0.0))
        assert await rep.run_once() == 1
        return ["stale", "late", "p"]

    t = both(scenario, heartbeats=[hb("w1")])
    assert [t[j]["meta"]["state"] for j in ("stale", "late", "p")] == [
        "TIMEOUT", "TIMEOUT", "RUNNING"]


# ---------------------------------------------------------------- gangs

async def _gang_run(root):
    """A two-member ``gang_echo`` job under each package's GangScheduler,
    with that package's workers and gang runners."""
    pkg = Pkg(root)
    s = await make(pkg, sync=False)
    gangs = pkg.gang.GangScheduler(s.eng, s.pc, rendezvous_timeout_s=3.0, watch_interval_s=0.05)
    await gangs.start()
    runtime = importlib.import_module(f"{root}.worker.runtime")
    gang_runner = importlib.import_module(f"{root}.worker.gang")
    kw = {"device": "cpu"} if root.endswith("_torch") else {}
    workers = []
    try:
        for i in range(2):
            w = runtime.Worker(bus=s.bus, store=s.mem, worker_id=f"w{i}", pool="gangpool",
                               heartbeat_interval_s=0.3, **kw)
            w.attach_gang(gang_runner.GangRunner(w, beacon_interval_s=0.05,
                                                 rendezvous_timeout_s=3.0),
                          metrics=s.eng.metrics)
            await w.start()
            workers.append(w)
        await asyncio.sleep(0.05)
        T = pkg.types
        ptr = await s.mem.put_context("g", {"op": "gang_echo"})
        await s.bus.publish(pkg.subj.SUBMIT, T.BusPacket.wrap(T.JobRequest(
            job_id="g", topic="job.gang", tenant_id="default", context_ptr=ptr,
            labels={T.LABEL_GANG_WORKERS: "2"}), sender_id="gateway"))
        deadline = time.monotonic() + 30
        while await s.js.get_state("g") not in ("SUCCEEDED", "FAILED"):
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        meta = await s.js.get_meta("g")
        res = await s.mem.get_result("g")
        return {"state": meta["state"],
                "events": [e["state"] for e in await s.js.events("g")],
                "members": sorted(meta["gang_members"].split(",")),
                "subject": meta["dispatch_subject"].startswith(pkg.subj.GANG_PREFIX),
                "ranks": sorted(res["per_rank"]), "workers": sorted(res["workers"]),
                "ledger": (gangs.ledger.reserved_workers, gangs.ledger.verify()),
                "admissions": s.eng.metrics.gang_admissions.value(outcome="reserved")}
    finally:
        await gangs.stop()
        await s.eng.stop()
        for w in workers:
            await w.stop()
        await s.bus.close()


def test_gang_job_under_the_port_gang_scheduler():
    ref, port = (asyncio.run(_gang_run(root)) for root in PACKAGES)
    assert port == ref
    assert port["state"] == "SUCCEEDED" and port["members"] == ["w0", "w1"]


# ---------------------------------------------------------------- the binary's parts

def test_timeouts_parse_as_the_reference_parses_them():
    from cordum_tpu.infra import config as ref_config
    from cordum_tpu_torch.infra import config as port_config

    want = ref_config.load_timeouts(str(REPO / "config" / "timeouts.yaml"))
    got = port_config.load_timeouts(str(REPO / "config" / "timeouts.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    doc = {"reconciler": {"scan_interval_seconds": 5}, "topics": {"job.x": 7}}
    assert (dataclasses.asdict(port_config.parse_timeouts(doc))
            == dataclasses.asdict(ref_config.parse_timeouts(doc)))
    with pytest.raises(ValueError):
        port_config.parse_timeouts({"reconciler": {"scan_interval_seconds": "soon"}})


def test_remote_safety_kernel_over_http():
    """``SAFETY_KERNEL_ADDR`` selects the remote kernel (the port's
    ``KernelService`` here): its decisions equal the embedded kernel's."""
    from cordum_tpu_torch.controlplane.safetykernel.kernel import SafetyKernel
    from cordum_tpu_torch.controlplane.safetykernel.service import KernelService, remote_check
    from cordum_tpu_torch.protocol.types import PolicyCheckRequest

    async def body():
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        svc = KernelService(SafetyKernel(policy_doc=POLICY))
        await svc.start("127.0.0.1", port)
        check = remote_check(f"http://127.0.0.1:{port}")
        local = SafetyKernel(policy_doc=POLICY)
        try:
            for topic in ("job.bad", "job.big", "job.gpu.echo", "job.default"):
                req = PolicyCheckRequest(job_id="j", topic=topic, tenant_id="default")
                got, want = await check(req), await local.check(req)
                assert (got.decision, got.rule_id, got.reason) == (
                    want.decision, want.rule_id, want.reason)
        finally:
            await check.close()
            await svc.stop()

    asyncio.run(body())


def test_scheduler_modules_import_without_msgpack_or_jax():
    """The scheduler binary's modules import with ``jax``, the JAX package
    and ``msgpack`` blocked (the import scan of
    ``tests/test_torch_serving.py`` covers every module of the port)."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack', 'torch'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in ('cmd.scheduler', 'cmd.safety_kernel', 'controlplane.scheduler.gang',
          'controlplane.scheduler.placer', 'controlplane.scheduler.overlay', 'native'):
    importlib.import_module('cordum_tpu_torch.' + m)
print('ok')
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr
