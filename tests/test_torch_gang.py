"""Gang members on the port's workers, scheduled by the JAX package's
control plane (``GangScheduler``, ``tests/test_gang.py`` ``make_stack``),
on the CPU.

The reference stack runs on the reference ``LoopbackBus``; the port's
workers (``cordum_tpu_torch.worker``: ``Worker`` with a ``GangRunner``) run
on the port's bus, joined by ``tests/test_torch_worker.py``'s ``Bridge``,
with one KV under both stores.  Covered: ``gang_echo``; a member failure
aborts the whole gang and the retry completes on the survivors; cancel;
a rendezvous timeout; a redelivered member republishes ``done``; a
serving gang end to end (rank 0 alone streams, the follower replays every
step, tokens equal the JAX oracle on ``params_from_jax`` weights given
through ``params_provider``, collectives over gloo); an SPMD ``train``
gang; and one serving gang over two worker processes (``WORKER_GANG=1``) reached over
the TCP statebus.

Every wait is bounded: jobs by ``wait_state``'s deadline, collectives by
the gang's peer timeout, processes by ``PROC_DEADLINE_S``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.protocol import subjects as rsubj
from cordum_tpu.protocol.types import (
    LABEL_GANG_KIND,
    LABEL_GANG_WORKERS,
    STATUS_HINT_STREAM,
    BusPacket,
    JobCancel,
    JobRequest,
)
from cordum_tpu_torch.infra.bus import LoopbackBus
from cordum_tpu_torch.infra.memstore import MemoryStore
from cordum_tpu_torch.infra.metrics import Metrics
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.protocol import types as tt
from cordum_tpu_torch.worker.gang import GangRunner
from cordum_tpu_torch.worker.runtime import Worker
from cordum_tpu_torch.worker.training import TrainRunner

from .test_gang import _beat, _hb, make_stack, submit_gang, teardown, wait_state
from .test_torch_serving import _jax_greedy
from .test_torch_worker import Bridge

REPO = Path(__file__).resolve().parents[1]
PROC_DEADLINE_S = 100.0
PROMPT = [7, 3, 11, 19, 2, 5, 23, 1, 13]


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny fp32 weights, as the port's tensors, and the
    JAX oracle on them."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return tree, _jax_greedy(jcfg, jparams)


async def port_stack(n_workers=2, *, tmp_path=None, params_tree=None, rendezvous_timeout_s=2.0,
                     peer_timeout_s=20.0):
    """The reference gang stack with ``n_workers`` port workers bridged in."""
    stack = await make_stack(0, rendezvous_timeout_s=rendezvous_timeout_s,
                             peer_timeout_s=peer_timeout_s)
    pbus = LoopbackBus()
    bridge = Bridge(stack.bus, pbus)
    await bridge.start()
    provider = None
    if params_tree is not None:
        provider = lambda cfg: tl.params_from_jax(params_tree, device="cpu", dtype=cfg.dtype)  # noqa: E731
    stack.pbus, stack.metrics = pbus, Metrics()
    for i in range(n_workers):
        w = Worker(bus=pbus, store=MemoryStore(stack.kv), worker_id=f"w{i}", pool="gangpool",
                   heartbeat_interval_s=0.3, device="cpu")
        w.attach_gang(GangRunner(
            w, trainer=TrainRunner(ckpt_root=str(tmp_path or REPO / "build"), device="cpu"),
            rendezvous_timeout_s=rendezvous_timeout_s, peer_timeout_s=peer_timeout_s,
            beacon_interval_s=0.05, params_provider=provider,
        ), metrics=stack.metrics)
        await w.start()
        stack.workers.append(w)
    await asyncio.sleep(0.1)
    return stack


async def close_stack(stack):
    await teardown(stack)
    await stack.pbus.close()


async def test_gang_echo():
    stack = await port_stack(2)
    try:
        await submit_gang(stack, "g-echo", {"op": "gang_echo"}, workers=2)
        assert await wait_state(stack.js, "g-echo") == "SUCCEEDED"
        res = await stack.store.get_result("g-echo")
        assert set(res["per_rank"]) == {"0", "1"}
        assert sorted(res["workers"]) == ["w0", "w1"]
        assert all(r["mode"] == "barrier" for r in res["per_rank"].values())
        assert stack.gangs.ledger.reserved_workers == {}
        assert "cordum_gang_rendezvous_seconds_count 2" in stack.metrics.render().splitlines()
    finally:
        await close_stack(stack)


async def test_member_failure_aborts_all_and_requeues():
    stack = await port_stack(3)
    try:
        await submit_gang(stack, "g-fail",
                          {"op": "gang_test", "spin_s": 0.2, "fail_workers": ["w0"]}, workers=2)
        assert await wait_state(stack.js, "g-fail") == "SUCCEEDED"
        res = await stack.store.get_result("g-fail")
        assert "w0" not in res["workers"]
        assert (await stack.js.get_meta("g-fail"))["attempts"] == "2"
        assert stack.eng.metrics.gang_aborts.value(reason="member_failed") == 1
        assert stack.gangs.ledger.reserved_workers == {}
    finally:
        await close_stack(stack)


async def test_cancel_aborts_without_requeue():
    stack = await port_stack(2)
    try:
        await submit_gang(stack, "g-can", {"op": "gang_test", "spin_s": 5.0}, workers=2)
        await asyncio.sleep(0.3)
        await stack.bus.publish(rsubj.CANCEL, BusPacket.wrap(
            JobCancel(job_id="g-can", reason="test"), sender_id="test"))
        assert await wait_state(stack.js, "g-can", timeout_s=10.0) == "CANCELLED"
        deadline = time.monotonic() + 5.0
        while any(w._active for w in stack.workers) or stack.gangs.ledger.reserved_workers:
            assert time.monotonic() < deadline, "members kept spinning after the cancel"
            await asyncio.sleep(0.05)
        assert "g-can" not in stack.gangs._by_job
    finally:
        await close_stack(stack)


async def test_rendezvous_timeout_excludes_the_silent_member():
    stack = await port_stack(2, rendezvous_timeout_s=0.5)
    try:
        stack.reg.update(_hb("ghost", pool="gangpool", chips=8))

        async def swallow(subject, pkt):
            return None

        await stack.bus.subscribe(rsubj.direct_subject("ghost"), swallow, queue="ghost")
        ghost = asyncio.ensure_future(_beat(stack, "ghost"))
        try:
            await submit_gang(stack, "g-rdv", {"op": "gang_echo"}, workers=2)
            assert await wait_state(stack.js, "g-rdv", timeout_s=20.0) == "SUCCEEDED"
        finally:
            ghost.cancel()
        assert "ghost" not in (await stack.store.get_result("g-rdv"))["workers"]
        assert stack.eng.metrics.gang_aborts.value(reason="rendezvous_timeout") >= 1
    finally:
        await close_stack(stack)


async def test_redelivered_member_republishes_done():
    stack = await port_stack(2)
    try:
        await submit_gang(stack, "g-redo", {"op": "gang_echo"}, workers=2)
        assert await wait_state(stack.js, "g-redo") == "SUCCEEDED"
        runner = stack.workers[0].gang
        gid = runner._done["g-redo"].gang_id
        rank = runner._done["g-redo"].rank
        done = []

        async def tap(subject, pkt):
            if pkt.gang_msg is not None and pkt.gang_msg.kind == "done":
                done.append(pkt.gang_msg)

        await stack.pbus.subscribe(rsubj.gang_subject(gid), tap)
        await runner.handle(tt.JobRequest(job_id="g-redo", topic="job.gang", labels={
            tt.LABEL_GANG_ID: gid, tt.LABEL_GANG_RANK: str(rank), tt.LABEL_GANG_SIZE: "2"}),
            {"op": "gang_echo"})
        await stack.pbus.drain()
        assert done and done[0].rank == rank
    finally:
        await close_stack(stack)


async def test_serving_gang_end_to_end(weights, tmp_path):
    """rank 0 alone streams; the follower replays every step over gloo;
    the tokens are the JAX oracle's on the injected weights."""
    tree, oracle = weights
    stack = await port_stack(2, tmp_path=tmp_path, params_tree=tree)
    senders = set()

    async def tap(subject, pkt):
        p = pkt.job_progress
        if p is not None and p.status_hint == STATUS_HINT_STREAM:
            senders.add(p.worker_id)

    await stack.bus.subscribe(rsubj.PROGRESS, tap)
    try:
        prompts = [PROMPT, [42, 9, 77, 5, 31]]
        payload = {"op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
                   "prompts": prompts, "max_new_tokens": 6, "page_size": 8,
                   "cache_pages": 32}
        ptr = await stack.store.put_context("g-serve", payload)
        await stack.bus.publish(rsubj.SUBMIT, BusPacket.wrap(JobRequest(
            job_id="g-serve", topic="job.gang", tenant_id="default", context_ptr=ptr,
            labels={LABEL_GANG_WORKERS: "2", LABEL_GANG_KIND: "serving"}), sender_id="test"))
        assert await wait_state(stack.js, "g-serve", timeout_s=90) == "SUCCEEDED"
        res = await stack.store.get_result("g-serve")
        lead, follow = res["per_rank"]["0"], res["per_rank"]["1"]
        assert res["kind"] == "serving" and res["sessions"] == 2 and res["tokens"] == 12
        for p, r in zip(prompts, lead["results"]):
            assert r["tokens"] == oracle(p, 6)
        assert follow["steps_replayed"] == lead["steps"] > 0
        assert lead["compiled"] == follow["compiled"] == 1
        assert lead["collective"] == follow["collective"] == "gloo"
        assert len(senders) == 1
        assert stack.metrics.serving_gang_steps.value(role="lead") == lead["steps"]
        assert stack.metrics.serving_gang_steps.value(role="replay") == lead["steps"]
        assert stack.gangs.ledger.reserved_workers == {}
        assert all(w.gang.serving_gang_doc() == {} for w in stack.workers)
    finally:
        await close_stack(stack)


async def _submit_serving(stack, job_id, payload):
    ptr = await stack.store.put_context(job_id, payload)
    await stack.bus.publish(rsubj.SUBMIT, BusPacket.wrap(JobRequest(
        job_id=job_id, topic="job.gang", tenant_id="default", context_ptr=ptr,
        labels={LABEL_GANG_WORKERS: "2", LABEL_GANG_KIND: "serving"}), sender_id="test"))


async def test_serving_gang_beacons_fold_into_one_capacity_row(weights, tmp_path):
    """While a serving gang lives each member's telemetry beacon carries its
    serving_gang block; the reference's CapacityView folds the two port
    workers' blocks into one row led by rank 0, and the block is gone once
    the gang ends."""
    from cordum_tpu.obs.capacity import CapacityView
    from cordum_tpu.protocol.types import TelemetrySnapshot

    tree, _ = weights
    stack = await port_stack(2, tmp_path=tmp_path, params_tree=tree)
    try:
        await _submit_serving(stack, "g-cap", {
            "op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
            "prompts": [PROMPT], "max_new_tokens": 4, "page_size": 8, "cache_pages": 32,
            "linger_s": 30.0})
        deadline = time.monotonic() + 60.0
        docs: dict = {}
        while len(docs) < 2:
            assert time.monotonic() < deadline, "no serving_gang block in the beacons"
            docs = {w.worker_id: w.telemetry_health()["capacity"]["serving_gang"]
                    for w in stack.workers
                    if "serving_gang" in w.telemetry_health()["capacity"]}
            docs = {k: v for k, v in docs.items() if v.get("rank") != 0 or "tokens_per_s" in v}
            await asyncio.sleep(0.05)
        view = CapacityView(clock=lambda: 0.0)
        for w in stack.workers:
            view.ingest(TelemetrySnapshot(service="worker", instance=w.worker_id, seq=1,
                                          started_at_us=1, interval_s=2.0,
                                          health=w.telemetry_health()))
        (row,) = view.serving_gangs().values()
        lead = next(w for w, d in docs.items() if d["rank"] == 0)
        assert row["leader"] == lead and row["size"] == 2
        assert set(row["members"]) == {"w0", "w1"} and row["pages_total_min"] == 32
        await stack.bus.publish(rsubj.CANCEL, BusPacket.wrap(
            JobCancel(job_id="g-cap", reason="test"), sender_id="test"))
        while any("serving_gang" in w.telemetry_health()["capacity"] for w in stack.workers):
            assert time.monotonic() < deadline, "the serving_gang block outlived the gang"
            await asyncio.sleep(0.05)
    finally:
        await close_stack(stack)


async def test_a_rank_failing_mid_step_aborts_the_gang_within_the_peer_timeout(weights, tmp_path):
    """Rank 1's weights fail to load inside its first step, while rank 0 is
    already waiting in that step's first all-reduce: rank 1 aborts and
    closes its group, rank 0's collective fails at once (not at the 20 s
    peer timeout).  The scheduler retries the gang until its attempts run
    out (every retry fails the same way), all inside one peer timeout, and
    both workers are then free for the next gang."""
    tree, _ = weights
    stack = await port_stack(2, tmp_path=tmp_path, params_tree=tree, peer_timeout_s=20.0)

    def broken(cfg):
        raise RuntimeError("weights unreadable")

    aborts = []

    async def tap(subject, pkt):
        m = pkt.gang_msg
        if m is not None and m.kind == "abort" and m.worker_id:
            aborts.append((m.worker_id, m.reason))

    await stack.bus.subscribe(rsubj.GANG_WILDCARD, tap)
    try:
        stack.workers[1].gang.params_provider = broken
        t0 = time.monotonic()
        await _submit_serving(stack, "g-die", {
            "op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
            "prompts": [PROMPT], "max_new_tokens": 4, "page_size": 8, "cache_pages": 32})
        while not aborts or any(w._active for w in stack.workers):
            assert time.monotonic() - t0 < 15.0, (aborts, [w._active for w in stack.workers])
            await asyncio.sleep(0.05)
        assert any(w == "w1" and r.startswith("member_failed") for w, r in aborts), aborts
        assert await wait_state(stack.js, "g-die", timeout_s=20.0) == "FAILED"
        assert time.monotonic() - t0 < 20.0
        stack.workers[1].gang.params_provider = stack.workers[0].gang.params_provider
        await submit_gang(stack, "g-after", {"op": "gang_echo"}, workers=2)
        assert await wait_state(stack.js, "g-after", timeout_s=20.0) == "SUCCEEDED"
    finally:
        await close_stack(stack)


async def test_spmd_train_gang(tmp_path):
    stack = await port_stack(2, tmp_path=tmp_path, rendezvous_timeout_s=10.0)
    try:
        await submit_gang(stack, "g-spmd", {
            "op": "train", "model": "llama-tiny", "steps": 2, "batch": 2, "seq": 16,
            "mesh": {"tp": 2}, "gang": {"workers": 2}}, workers=2)
        assert await wait_state(stack.js, "g-spmd", timeout_s=60.0) == "SUCCEEDED"
        res = await stack.store.get_result("g-spmd")
        assert res["mode"] == "spmd" and res["loss"] is not None
        r0, r1 = res["per_rank"]["0"], res["per_rank"]["1"]
        assert r0["steps_done"] == r1["steps_done"] == 2
        assert r0["final_loss"] == r1["final_loss"]  # the same program on the same seed
        assert r0["mesh"]["tp"] == 1  # one card a member
    finally:
        await close_stack(stack)


# ---------------------------------------------------------------------------
# two worker processes over the TCP statebus
# ---------------------------------------------------------------------------


async def _statebus_gang_stack():
    from cordum_tpu.controlplane.safetykernel.kernel import SafetyKernel
    from cordum_tpu.controlplane.scheduler.engine import Engine
    from cordum_tpu.controlplane.scheduler.gang import GangScheduler
    from cordum_tpu.controlplane.scheduler.safety_client import SafetyClient
    from cordum_tpu.controlplane.scheduler.strategy import LeastLoadedStrategy
    from cordum_tpu.infra.config import parse_pool_config
    from cordum_tpu.infra.jobstore import JobStore
    from cordum_tpu.infra.memstore import MemoryStore as RefStore
    from cordum_tpu.infra.registry import WorkerRegistry
    from cordum_tpu.infra.statebus import StateBusServer, connect

    srv = StateBusServer(port=0)
    await srv.start()
    url = f"statebus://127.0.0.1:{srv.port}"
    kv, bus, conn = await connect(url)
    js = JobStore(kv)
    reg = WorkerRegistry()
    pc = parse_pool_config({"topics": {"job.gang": "gangpool"}, "pools": {"gangpool": {}}})
    eng = Engine(bus=bus, job_store=js, safety=SafetyClient(SafetyKernel(policy_doc={
        "tenants": {"default": {"allow_topics": ["job.*", "job.>"]}}}).check),
        strategy=LeastLoadedStrategy(reg, pc), registry=reg)
    gangs = GangScheduler(eng, pc, rendezvous_timeout_s=20.0, watch_interval_s=0.1)
    await eng.start()
    await gangs.start()
    return srv, url, conn, bus, js, RefStore(kv), reg, eng, gangs


def _gang_worker(url, worker_id):
    env = {k: v for k, v in os.environ.items() if not k.startswith("WORKER_")}
    env.update({"CORDUM_STATEBUS_URL": url, "CORDUM_FORCE_CPU": "1", "WORKER_ID": worker_id,
                "WORKER_POOL": "gangpool", "WORKER_TOPICS": "job.gang", "WORKER_GANG": "1",
                "WORKER_GANG_RENDEZVOUS_TIMEOUT": "20", "WORKER_GANG_PEER_TIMEOUT": "30",
                "WORKER_HEARTBEAT_INTERVAL": "0.5", "CORDUM_LOG_FORMAT": "json",
                "PYTHONPATH": str(REPO)})
    return subprocess.Popen([sys.executable, "-m", "cordum_tpu_torch.cmd.worker"], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


async def test_serving_gang_over_two_worker_processes():
    """WORKER_GANG=1: two port worker processes serve one gang job (fp32,
    seed 3) under the reference gang scheduler over TCP; rank 0's tokens
    equal the port's single-rank greedy on the weights the seed draws."""
    deadline = time.monotonic() + PROC_DEADLINE_S
    srv, url, conn, bus, js, ms, reg, eng, gangs = await _statebus_gang_stack()
    procs = [_gang_worker(url, f"gp{i}") for i in range(2)]
    try:
        while not all(reg.get(f"gp{i}") is not None for i in range(2)):
            assert all(p.poll() is None for p in procs), procs[0].communicate()[0][-2000:]
            assert time.monotonic() < deadline, "the worker processes never beat"
            await asyncio.sleep(0.1)
        payload = {"op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
                   "prompts": [PROMPT], "max_new_tokens": 6, "dtype": "float32",
                   "seed": 3, "page_size": 8, "cache_pages": 32}
        ptr = await ms.put_context("g-proc", payload)
        await bus.publish(rsubj.SUBMIT, BusPacket.wrap(JobRequest(
            job_id="g-proc", topic="job.gang", tenant_id="default", context_ptr=ptr,
            labels={LABEL_GANG_WORKERS: "2", LABEL_GANG_KIND: "serving"}), sender_id="test"))
        state = await wait_state(js, "g-proc", timeout_s=max(5.0, deadline - time.monotonic()))
        assert state == "SUCCEEDED", state
        res = await ms.get_result("g-proc")
    finally:
        await gangs.stop()
        await eng.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [await asyncio.to_thread(p.communicate, None, 30) for p in procs]
        await conn.close()
        await srv.stop()
    lead, follow = res["per_rank"]["0"], res["per_rank"]["1"]
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    params = tl.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    toks = list(PROMPT)
    with torch.no_grad():
        for _ in range(6):
            toks.append(int(torch.argmax(tl.forward(params, torch.tensor([toks]), cfg)[0, -1])))
    assert lead["results"][0]["tokens"] == toks[len(PROMPT):], outs[0][-2000:]
    assert follow["steps_replayed"] == lead["steps"] > 0
    assert lead["collective"] == follow["collective"] == "gloo"


@pytest.mark.parametrize("env, want", [
    ({}, (True, 10.0, 30.0)),
    ({"WORKER_GANG": "1", "WORKER_GANG_RENDEZVOUS_TIMEOUT": "2.5",
      "WORKER_GANG_PEER_TIMEOUT": "7"}, (True, 2.5, 7.0)),
    ({"WORKER_GANG": "0"}, (False, 10.0, 30.0)),
], ids=["default", "timeouts", "off"])
def test_worker_gang_switch_attaches_the_gang_runner(monkeypatch, env, want):
    """The worker binary's WORKER_GANG switch and timeouts reach
    ``attach_default_gpu_worker``: a gang runner with those timeouts is
    attached, or none with ``WORKER_GANG=0``."""
    from cordum_tpu_torch.cmd.worker import _gang_options
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.worker.handlers import attach_default_gpu_worker

    for name in ("WORKER_GANG", "WORKER_GANG_RENDEZVOUS_TIMEOUT", "WORKER_GANG_PEER_TIMEOUT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    w = Worker(bus=LoopbackBus(), store=MemoryStore(MemoryKV()), worker_id="w-switch",
               pool="tpu", topics=["job.tpu.>"], capabilities=["tpu"],
               heartbeat_interval_s=999, device="cpu")
    attach_default_gpu_worker(w, batching=False, serving=False, **_gang_options(os.environ))
    on, rendezvous, peer = want
    assert (w.gang is not None) == on
    if on:
        assert isinstance(w.gang, GangRunner) and w.gang.worker is w
        assert (w.gang.rendezvous_timeout_s, w.gang.peer_timeout_s) == (rendezvous, peer)
