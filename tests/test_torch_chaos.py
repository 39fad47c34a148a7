"""The port's fault-injection harness (``cordum_tpu_torch/infra/chaos.py``)
and its statebus binaries under chaos, on the CPU; phase 18 of
``chip_smoke.py`` rehearsed, with the faults it must refuse planted.

* ``ChaosProxy``: the reference's five cases (delay, sever, per-direction
  blackhole and delay, a blackhole found by the ping and failed over).
* ``ServerProc`` around ``python -m cordum_tpu_torch.cmd.statebus``: a
  SIGKILL and a restart replaying the AOF; a SIGTERM's GOAWAY failing over
  with no heartbeat wait.
* The reference's headline: 2 scheduler shards × 2 replicated partitions
  of the port's statebus binary, partition 0's primary SIGKILLed mid-burst:
  every job SUCCEEDED with its canonical lifecycle, the returning old
  primary demoted and caught up.
* The reference's serving chaos case as phase 18.2 runs it: two port worker
  processes under ``CORDUM_FORCE_CPU=1`` at ``LlamaConfig.tiny()``, the one
  holding three ``llm.generate`` sessions SIGKILLed mid-decode; every
  session resumes on the other equal to the fp32 oracle.
* Phase 18.1 and 18.3 at a small size, then the planted faults: a server
  that acks before its AOF flush, a replica that acks before it applies, a
  lost job, a resumed stream with a duplicated token.

Every subprocess test runs under its own deadline (``asyncio.wait_for``)
and stops its processes on every path.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from cordum_tpu_torch.controlplane.safetykernel.kernel import SafetyKernel
from cordum_tpu_torch.controlplane.scheduler.engine import Engine
from cordum_tpu_torch.controlplane.scheduler.reconciler import PendingReplayer
from cordum_tpu_torch.controlplane.scheduler.safety_client import SafetyClient
from cordum_tpu_torch.controlplane.scheduler.strategy import LeastLoadedStrategy
from cordum_tpu_torch.infra.chaos import ChaosProxy, ServerProc, free_port
from cordum_tpu_torch.infra.config import Timeouts, parse_pool_config
from cordum_tpu_torch.infra.jobstore import JobStore
from cordum_tpu_torch.infra.registry import WorkerRegistry
from cordum_tpu_torch.infra.replication import probe_role
from cordum_tpu_torch.infra.statebus import StateBusServer, connect, connect_partitioned
from cordum_tpu_torch.protocol import subjects as subj
from cordum_tpu_torch.protocol.types import (LABEL_PARTITION, BusPacket, Heartbeat, JobProgress,
                                             JobRequest, JobResult, JobState)

from .test_torch_scheduler_process import _record

pytestmark = pytest.mark.chaos

REPO_ROOT = str(Path(__file__).resolve().parents[1])
CPU = torch.device("cpu")


async def wait_for(cond, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = cond()
        if asyncio.iscoroutine(v):
            v = await v
        if v:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# ChaosProxy
# ---------------------------------------------------------------------------


async def proxied():
    srv = StateBusServer(port=0)
    await srv.start()
    proxy = ChaosProxy("127.0.0.1", srv.port)
    await proxy.start()
    return srv, proxy


async def test_proxy_passthrough_and_delay():
    srv, proxy = await proxied()
    kv, _, conn = await connect(proxy.url)
    try:
        await kv.set("through-proxy", b"1")
        assert await kv.get("through-proxy") == b"1"
        assert proxy.connections_total == 1
        proxy.set_delay(0.15)
        t0 = time.monotonic()
        assert await kv.get("through-proxy") == b"1"
        assert time.monotonic() - t0 >= 0.15  # request and reply each delayed
        proxy.restore()
        t0 = time.monotonic()
        await kv.get("through-proxy")
        assert time.monotonic() - t0 < 0.15
    finally:
        await conn.close()
        await proxy.stop()
        await srv.stop()


async def test_proxy_sever_client_reconnects():
    srv, proxy = await proxied()
    kv, _, conn = await connect(proxy.url)
    try:
        await kv.set("pre", b"1")
        proxy.sever()
        assert await kv.get("pre") == b"1"
        await wait_for(lambda: conn.reconnect_count >= 1, msg="reconnect count")
        assert proxy.connections_total >= 2
    finally:
        await conn.close()
        await proxy.stop()
        await srv.stop()


async def test_proxy_per_direction_blackhole_is_asymmetric():
    """``blackhole("s2c")``: requests reach the server, replies stall until
    ``restore``; ``blackhole("c2s")``: requests vanish."""
    srv, proxy = await proxied()
    kv, _, conn = await connect(proxy.url)
    try:
        await kv.set("pre", b"0")
        proxy.blackhole("s2c")
        task = asyncio.ensure_future(kv.set("one-way", b"1"))
        await wait_for(lambda: srv.kv.get("one-way"), msg="server got the write")
        await asyncio.sleep(0.1)
        assert not task.done(), "a reply crossed a blackholed s2c direction"
        proxy.restore()
        await asyncio.wait_for(task, timeout=10)
        proxy.blackhole("c2s")
        t2 = asyncio.ensure_future(kv.set("other-way", b"2"))
        await asyncio.sleep(0.2)
        assert await srv.kv.get("other-way") is None, "a write crossed the c2s hole"
        assert not t2.done()
        proxy.restore()
        await asyncio.wait_for(t2, timeout=10)
    finally:
        await conn.close()
        await proxy.stop()
        await srv.stop()


async def test_proxy_per_direction_delay_composes():
    srv, proxy = await proxied()
    kv, _, conn = await connect(proxy.url)
    try:
        await kv.set("k", b"1")
        proxy.set_delay(0.15, "c2s")
        t0 = time.monotonic()
        await kv.get("k")
        assert 0.15 <= time.monotonic() - t0 < 0.45
        proxy.set_delay(0.15, "s2c")
        t0 = time.monotonic()
        await kv.get("k")
        assert time.monotonic() - t0 >= 0.3
        proxy.restore()
        t0 = time.monotonic()
        await kv.get("k")
        assert time.monotonic() - t0 < 0.15
    finally:
        await conn.close()
        await proxy.stop()
        await srv.stop()


async def test_proxy_blackhole_detected_by_ping_and_failed_over():
    primary, proxy = await proxied()
    standby = StateBusServer(port=0)
    await standby.start()
    kv, _, conn = await connect(f"{proxy.url}|statebus://127.0.0.1:{standby.port}",
                                ping_interval_s=0.2)
    try:
        await kv.set("alive", b"1")
        proxy.blackhole()
        await wait_for(lambda: (conn.host, conn.port) == ("127.0.0.1", standby.port),
                       20.0, "failover to the standby")
        await kv.set("after-blackhole", b"2")
        assert await standby.kv.get("after-blackhole") == b"2"
    finally:
        await conn.close()
        await proxy.stop()
        await standby.stop()
        await primary.stop()


# ---------------------------------------------------------------------------
# ServerProc: the port's statebus binary
# ---------------------------------------------------------------------------


async def test_server_proc_kill_and_restart_replays_aof(tmp_path):
    port = free_port()
    proc = ServerProc(port, env={"STATEBUS_AOF": str(tmp_path / "p.aof")}, cwd=REPO_ROOT)

    async def body():
        await proc.start()
        kv, _, conn = await connect(f"statebus://127.0.0.1:{port}")
        await kv.set("durable", b"1")
        await conn.close()
        proc.kill()  # SIGKILL: no GOAWAY, no graceful drain
        assert not proc.alive
        await proc.start()
        kv, _, conn = await connect(f"statebus://127.0.0.1:{port}")
        assert await kv.get("durable") == b"1"
        await conn.close()

    try:
        await asyncio.wait_for(body(), 60)
    finally:
        proc.kill()


async def test_sigterm_goaway_fails_over_without_heartbeat_wait(tmp_path):
    """A SIGTERM's GOAWAY promotes the replica and fails the client over at
    once: the 30 s heartbeat timeout here would fail the test otherwise."""
    p_port, r_port = free_port(), free_port()
    peers = f"statebus://127.0.0.1:{p_port},statebus://127.0.0.1:{r_port}"
    primary = ServerProc(p_port, env={
        "STATEBUS_AOF": str(tmp_path / "p.aof"), "STATEBUS_PEERS": peers,
        "STATEBUS_HEARTBEAT_TIMEOUT": "30.0"}, cwd=REPO_ROOT)
    replica = ServerProc(r_port, env={
        "STATEBUS_AOF": str(tmp_path / "r.aof"), "STATEBUS_PEERS": peers,
        "STATEBUS_REPLICA_OF": f"statebus://127.0.0.1:{p_port}",
        "STATEBUS_HEARTBEAT_TIMEOUT": "30.0"}, cwd=REPO_ROOT)

    async def body():
        await primary.start()
        await replica.start()
        kv, _, conn = await connect(
            f"statebus://127.0.0.1:{p_port}|statebus://127.0.0.1:{r_port}")
        try:
            await kv.set("pre-term", b"1")

            async def replicated():
                doc = await probe_role("127.0.0.1", r_port)
                return doc is not None and doc.get("offset", 0) >= 1

            await wait_for(replicated, msg="replica caught up")
            t0 = time.monotonic()
            await asyncio.to_thread(primary.terminate)  # SIGTERM -> GOAWAY
            await kv.set("post-term", b"2")  # parked, retransmitted on failover
            assert time.monotonic() - t0 < 15.0
            doc = await probe_role("127.0.0.1", r_port)
            assert doc["role"] == "primary" and doc["epoch"] == 1
            assert await kv.get("pre-term") == b"1"
        finally:
            await conn.close()

    try:
        await asyncio.wait_for(body(), 60)
    finally:
        primary.kill()
        replica.kill()


# ---------------------------------------------------------------------------
# the reference's headline: kill a partition's primary mid-burst
# ---------------------------------------------------------------------------


def mk_engine(bus, kv, *, index, count):
    """``tests/test_sharding.py``'s ``_mk_engine`` on the port."""
    kernel = SafetyKernel(policy_doc={"tenants": {"default": {"allow_topics": ["job.*", "job.>"]}}})
    reg = WorkerRegistry()
    pc = parse_pool_config({"topics": {"job.bench": "bench"},
                            "pools": {"bench": {"requires": []}}})
    eng = Engine(bus=bus, job_store=JobStore(kv), safety=SafetyClient(kernel.check),
                 strategy=LeastLoadedStrategy(reg, pc), registry=reg,
                 instance_id=f"shard-{index}", shard_index=index, shard_count=count)
    reg.update(Heartbeat(worker_id="w1", pool="bench", max_parallel_jobs=1 << 30))
    return eng


async def attach_worker(bus):
    async def handler(subject, pkt):
        req = pkt.job_request
        await bus.publish(
            subj.stamped_result_subject((req.labels or {}).get(LABEL_PARTITION, "")),
            BusPacket.wrap(JobResult(job_id=req.job_id, status="SUCCEEDED", worker_id="w1"),
                           sender_id="w1"))

    await bus.subscribe(subj.direct_subject("w1"), handler, queue="w")


async def gateway_submit(js, bus, jid):
    """The gateway's submit order: PENDING and the request, then publish."""
    from cordum_tpu_torch.utils.ids import now_us

    req = JobRequest(job_id=jid, topic="job.bench", tenant_id="default")
    await js.set_state(jid, JobState.PENDING, fields={
        "topic": "job.bench", "tenant_id": "default", "submitted_at_us": str(now_us())},
        event="submit")
    await js.put_request(req)
    await bus.publish(subj.submit_subject_for(jid, 2), BusPacket.wrap(req, sender_id="gw"))


async def test_kill_primary_mid_burst_zero_job_loss(tmp_path):
    """2 scheduler shards × 2 replicated partitions of the port's statebus
    binary (sync replication), partition 0's primary SIGKILLed mid-burst:
    every job SUCCEEDED with its canonical lifecycle, the replica promoted,
    the returning old primary demoted and caught up."""
    ports = {f"{r}{i}": free_port() for r in "pr" for i in range(2)}
    procs = {}
    for i in range(2):
        peers = f"statebus://127.0.0.1:{ports[f'p{i}']},statebus://127.0.0.1:{ports[f'r{i}']}"
        common = {"STATEBUS_PEERS": peers, "STATEBUS_SYNC_REPLICATION": "1",
                  "STATEBUS_HEARTBEAT_TIMEOUT": "1.0"}
        procs[f"p{i}"] = ServerProc(ports[f"p{i}"], env={
            **common, "STATEBUS_AOF": str(tmp_path / f"p{i}.aof")}, cwd=REPO_ROOT)
        procs[f"r{i}"] = ServerProc(ports[f"r{i}"], env={
            **common, "STATEBUS_AOF": str(tmp_path / f"r{i}.aof"),
            "STATEBUS_REPLICA_OF": f"statebus://127.0.0.1:{ports[f'p{i}']}"}, cwd=REPO_ROOT)
    url = ",".join(f"statebus://127.0.0.1:{ports[f'p{i}']}|statebus://127.0.0.1:{ports[f'r{i}']}"
                   for i in range(2))
    conns, engines, replayers = [], [], []
    jobs = [f"chaos-{i}" for i in range(40)]

    async def body():
        await asyncio.gather(*(p.start() for p in procs.values()))

        async def attached():
            docs = [await probe_role("127.0.0.1", ports[f"p{i}"]) for i in range(2)]
            return all(d and d.get("replicas") for d in docs)

        await wait_for(attached, 20.0, "both replicas attached")
        timeouts = Timeouts(dispatch_timeout_s=5.0, running_timeout_s=60.0, scan_interval_s=0.5,
                            pending_replay_s=1.5, result_replay_s=1.5)
        for i in range(2):
            kv, bus, grp = await connect_partitioned(url)
            conns.append(grp)
            eng = mk_engine(bus, kv, index=i, count=2)
            engines.append(eng)
            await eng.start()
            rep = PendingReplayer(eng, JobStore(kv), timeouts)
            replayers.append(rep)
            await rep.start()
        wkv, wbus, wgrp = await connect_partitioned(url)
        conns.append(wgrp)
        await attach_worker(wbus)
        js = JobStore(wkv)
        for jid in jobs[:15]:
            await gateway_submit(js, wbus, jid)
        procs["p0"].kill()
        for jid in jobs[15:]:
            await gateway_submit(js, wbus, jid)
        states, events = {}, {}

        async def all_succeeded():
            for jid in jobs:
                states[jid] = await js.get_state(jid)
            return all(s == "SUCCEEDED" for s in states.values())

        await wait_for(all_succeeded, 60.0, "all 40 jobs SUCCEEDED")
        for jid in jobs:
            events[jid] = await js.events(jid)
        cs.check_chaos_jobs(states, events)
        doc = await probe_role("127.0.0.1", ports["r0"])
        assert doc["role"] == "primary" and doc["epoch"] >= 1
        new, old = await cs.rejoin_old_primary(procs["p0"], procs["r0"], timeout_s=20.0)
        assert old["role"] == "replica" and old["epoch"] == new["epoch"]

    try:
        await asyncio.wait_for(body(), 120)
    finally:
        for rep in replayers:
            await rep.stop()
        for eng in engines:
            await eng.stop()
        for grp in conns:
            await grp.close()
        for p in procs.values():
            p.kill()


# ---------------------------------------------------------------------------
# phase 18 rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def count_nothing(monkeypatch):
    """The CPU counts no kernel launch: the card run checks them."""
    monkeypatch.setattr(cs, "check_sched_process_launches",
                        lambda doc, n_layers, n_embed: doc["kernel_launches"])
    monkeypatch.setattr(cs, "check_survivor_launches", lambda doc, n_layers: doc["kernel_launches"])


async def test_serving_worker_sigkill_mid_decode_sessions_resume(tmp_path, one_thread,
                                                                 monkeypatch):
    """The reference's serving chaos case as 18.2 runs it, on a statebus
    pair of the port's binary: two port worker processes on the CPU at
    ``LlamaConfig.tiny()`` fp32, the holder of three sessions SIGKILLed
    mid-decode; every client's offset-assembled stream equals the fp32
    oracle, each job failed over once."""
    count_nothing(monkeypatch)
    primary, replica, url = cs.statebus_pair(str(tmp_path), "serve", sync=True)

    async def body():
        await cs.start_pair(primary, replica)
        return await cs.drive_chaos_worker(torch, CPU, "cpu", str(tmp_path), url, timeout_s=90.0)

    try:
        launches, numbers = await asyncio.wait_for(body(), 180)
    finally:
        primary.kill()
        replica.kill()
    assert set(numbers["streamed at the kill"]) == {"chaos-gen-0", "chaos-gen-1", "chaos-gen-2"}
    assert 0 < numbers["SIGKILL -> first resumed token s"] < 60
    assert launches["paged_attention"] == 0  # the CPU counts no launch


async def test_phase18_primary_kill_rehearsed(tmp_path, one_thread, monkeypatch):
    """18.1 at a small size (40 workers, 600 jobs, an async leg of 300) with
    a port worker process on the CPU taking 16.4's embed and generate
    jobs through the failover, then 18.3's read-back from the promoted
    replica's AOF."""
    from cordum_tpu_torch.models import llama

    count_nothing(monkeypatch)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    record = await _record(cfg)

    async def body():
        launches, stack, pair, acked = await cs.drive_chaos_primary(
            torch, CPU, "cpu", str(tmp_path), record,
            {"paged_attention": 0, "embed_attention": 0},
            n_workers=40, n_jobs=600, n_async=300, timeout_s=90.0)
        try:
            doc = await probe_role("127.0.0.1", pair[1].port)
            assert doc["role"] == "primary" and doc["epoch"] == 1
        finally:
            await stack.close()
            for s in pair[:2]:
                await asyncio.to_thread(s.terminate)
        return await cs.readback(str(tmp_path), pair[1].env["STATEBUS_AOF"], acked), acked

    n, acked = await asyncio.wait_for(body(), 240)
    assert n == len(acked) == 600 + len(cs.card_jobs(record))


#: planted faults for the statebus processes, loaded at interpreter start
#: (``sitecustomize``) when ``CHAOS_PLANT`` names one
PLANT = '''
import os

fault = os.environ.get("CHAOS_PLANT")
if fault:
    from cordum_tpu_torch.infra import statebus

    if fault == "ack-before-flush":
        def _append_aof(self, rec):
            # the record waits in memory: a SIGKILL loses what was acked
            self.__dict__.setdefault("_unflushed", []).append(rec)
        statebus.StateBusServer._append_aof = _append_aof
    elif fault == "ack-before-apply":
        async def apply_replicated(self, rec, offset):
            # the offset (and so the ack) moves on; the record never applies
            if self.role == "replica" and offset > self.repl.offset:
                self.repl.offset = int(offset)
        statebus.StateBusServer.apply_replicated = apply_replicated
'''


def planted(tmp_path, fault):
    d = tmp_path / "plant"
    d.mkdir(exist_ok=True)
    (d / "sitecustomize.py").write_text(PLANT)
    return {"CHAOS_PLANT": fault,
            "PYTHONPATH": os.pathsep.join([str(d), REPO_ROOT, os.environ.get("PYTHONPATH", "")])}


async def test_phase18_write_loop_holds_every_acked_write(tmp_path):
    out = await asyncio.wait_for(cs.chaos_write_loop(str(tmp_path), "clean", writes=200), 90)
    assert out["acked before the kill"] == 200 and out["acked writes"] == 400


@pytest.mark.parametrize("fault,refusal", [
    ("ack-before-flush", "the killed primary's AOF"),
    ("ack-before-apply", "missing on the promoted replica")])
async def test_phase18_refuses_a_planted_server_fault(tmp_path, fault, refusal):
    """A server that acks before its AOF flush, and a replica that acks
    before it applies: 18.3's write loop must refuse each."""
    with pytest.raises(AssertionError, match=refusal):
        await asyncio.wait_for(cs.chaos_write_loop(
            str(tmp_path), fault, env=planted(tmp_path, fault), writes=200), 90)


async def test_phase18_refuses_a_lost_job(tmp_path):
    """A fleet worker that swallows one job: 18.1's leg must refuse it."""
    pair = cs.statebus_pair(str(tmp_path), "lost", sync=True)
    stack = cs.ChaosStack(torch, CPU, str(tmp_path), "lost", pair, worker=False)

    async def body():
        await cs.start_pair(*pair[:2])
        await stack.start()
        await cs.chaos_leg(stack, 20, 300, prefix="lost18", seed=5, timeout_s=8.0, kill=True,
                           drop={"lost18-00123"})

    try:
        with pytest.raises(AssertionError, match="1 of 300 jobs lost or stuck"):
            await asyncio.wait_for(body(), 120)
    finally:
        await stack.close()
        for s in pair[:2]:
            s.kill()


def test_phase18_refuses_a_duplicated_token():
    """18.2's stream checks: a failed-over session replaying its prefix at
    offset 0 assembles exactly once; a divergent replayed token, a gap, and
    a token duplicated at a new offset are each refused."""
    want = [5, 9, 2, 9, 7, 1]
    events = {"j": [{"event": "submit"}, {"event": "failover"}, {"event": "result"}]}

    def pr(tokens, offset, worker="w"):
        return JobProgress(job_id="j", tokens=tokens, offset=offset, worker_id=worker)

    streams = {}
    for p in (pr(want[:2], 0), pr(want[2:3], 2), pr(want[:3], 0, "w2"), pr(want[3:], 3, "w2")):
        cs.assemble_stream(streams, p)
    cs.check_resumed_streams(streams, {"j": want}, {"j": want}, {"j": []}, events)
    with pytest.raises(AssertionError, match="replayed as"):
        cs.assemble_stream({"j": want[:3]}, pr([5, 9, 4], 0))
    with pytest.raises(AssertionError, match="past a gap"):
        cs.assemble_stream({"j": want[:2]}, pr([9], 3))
    duplicated = {"j": want[:4] + [want[3]] + want[4:5]}  # 9 streamed twice, 1 lost
    with pytest.raises(AssertionError, match="duplicated or missing"):
        cs.check_resumed_streams(duplicated, {"j": want}, {"j": want}, {"j": []}, events)
    with pytest.raises(AssertionError, match="events"):
        cs.check_resumed_streams(streams, {"j": want}, {"j": want}, {"j": []},
                                 {"j": [{"event": "submit"}, {"event": "result"}]})


# ---------------------------------------------------------------------------
# two departures from the reference that phase 18's rehearsals forced
# ---------------------------------------------------------------------------


async def test_a_durable_message_routed_to_nobody_does_not_dedupe_its_replay():
    """A result retransmitted to a promoted primary before its consumer
    re-subscribed reaches no one; the replay that redelivers it must get
    through (the reference's server remembers the id anyway and drops the
    replay for its 120 s window).  Delivered messages still dedupe."""
    srv = StateBusServer(port=0)
    await srv.start()
    kv, bus, conn = await connect(f"statebus://127.0.0.1:{srv.port}")
    got = []
    try:
        pkt = BusPacket.wrap(JobResult(job_id="j", status="SUCCEEDED", worker_id="w"))
        await bus.publish(subj.RESULT, pkt)  # nobody listens yet

        async def h(s, p):
            got.append(p.job_result.job_id)

        await bus.subscribe(subj.RESULT, h, queue="sched")
        await bus.publish(subj.RESULT, pkt)  # the replay
        await bus.publish(subj.RESULT, pkt)  # a duplicate of a delivered one
        await wait_for(lambda: got, msg="the replay delivered")
        await asyncio.sleep(0.15)
        assert got == ["j"]
    finally:
        await conn.close()
        await srv.stop()


async def test_safety_check_does_not_wait_on_its_span_publish():
    """The embedded kernel's ``evaluate`` span is published off the decision
    path: a check whose span publish parks (a statebus failover) still
    answers at once, and the span goes out once the bus returns."""
    from cordum_tpu_torch.obs.tracer import Tracer
    from cordum_tpu_torch.protocol.types import PolicyCheckRequest

    release, sent = asyncio.Event(), []

    class ParkedBus:
        def has_listener(self, subject):
            return True

        async def publish(self, subject, pkt):
            await release.wait()
            sent.append(pkt.span.name)

    kernel = SafetyKernel(policy_doc={"tenants": {"default": {"allow_topics": ["job.>"]}}},
                          tracer=Tracer("safety-kernel", ParkedBus()))
    client = SafetyClient(kernel.check, timeout_s=0.5)
    tracer = Tracer("scheduler", None)
    async with tracer.span("dispatch", trace_id="t1"):
        resp = await asyncio.wait_for(client.check(PolicyCheckRequest(
            job_id="j", topic="job.x", tenant_id="default")), 2.0)
    assert resp.decision == "ALLOW", resp
    assert sent == []
    release.set()
    await wait_for(lambda: sent == ["evaluate"], msg="the span published")


async def test_a_message_that_missed_a_group_reaches_it_on_the_replay():
    """A durable message delivered to a plain subscriber while a queue
    group was away (re-subscribing after a failover) reaches the group on
    its replay, and nobody twice."""
    srv = StateBusServer(port=0)
    await srv.start()
    kv, bus, conn = await connect(f"statebus://127.0.0.1:{srv.port}")
    plain, group = [], []
    try:
        async def on_plain(s, p):
            plain.append(p.job_result.job_id)

        async def on_group(s, p):
            group.append(p.job_result.job_id)

        await bus.subscribe(subj.RESULT, on_plain)
        pkt = BusPacket.wrap(JobResult(job_id="j", status="SUCCEEDED", worker_id="w"))
        await bus.publish(subj.RESULT, pkt)  # the group is away
        await bus.subscribe(subj.RESULT, on_group, queue="sched")
        await bus.publish(subj.RESULT, pkt)  # the replay
        await bus.publish(subj.RESULT, pkt)
        await wait_for(lambda: group, msg="the replay reached the group")
        await asyncio.sleep(0.15)
        assert plain == ["j"] and group == ["j"]
    finally:
        await conn.close()
        await srv.stop()


def test_a_collection_inside_a_metrics_snapshot_does_not_hang():
    """The runtime profiler's gc callback takes no metric lock: a
    collection that fires while a thread holds ``cordum_gc_pause_seconds``'s
    lock (a telemetry snapshot allocating) must not block on it.  The
    reference's callback observes at once and hangs the process; the port's
    queues the pause and folds it in on the sampler's next tick."""
    import gc
    import threading

    from cordum_tpu_torch.infra.metrics import Metrics
    from cordum_tpu_torch.obs.profiler import RuntimeProfiler

    m = Metrics()
    prof = RuntimeProfiler(m, service="test")
    gc.callbacks.append(prof._on_gc)
    done = threading.Event()

    def snapshot_then_collect():
        with m.gc_pause_seconds._lock:  # a snapshot holds the lock...
            gc.collect()                # ...and a collection fires inside it
        done.set()

    try:
        t = threading.Thread(target=snapshot_then_collect, daemon=True)
        t.start()
        assert done.wait(10.0), "the gc callback blocked on a held metric lock"
    finally:
        gc.callbacks.remove(prof._on_gc)
    prof._fold_gc()
    assert m.gc_pauses.total() >= 1 and m.gc_pause_seconds._snapshot()
