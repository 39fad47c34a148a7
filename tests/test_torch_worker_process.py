"""The port's worker as its own process (``python -m
cordum_tpu_torch.cmd.worker``), on the CPU (``CORDUM_FORCE_CPU=1``,
``WORKER_LLAMA_DTYPE=float32``).

* The JAX package's control plane drives it: a reference statebus server
  and the reference scheduler ``Engine`` run in this process, and the port
  worker subprocess reaches them over TCP with the port's statebus client.
  ``echo``, ``infer``, ``embed`` and ``llm.generate`` jobs submitted to
  the scheduler complete; ``infer`` and ``llm.generate`` tokens equal the
  port's in-process ``GPUCompute`` on the same seed (greedy ``forward``
  over the growing sequence for generate).
* SIGTERM drains the worker process: exit 0, no cancelled session, while a
  generation is in flight.
* The binary refuses what it cannot do: no card without
  ``CORDUM_FORCE_CPU=1``; ``WORKER_TP`` > 1 is accepted (the embedder's
  local mesh) and so is ``WORKER_GANG=1`` (gang members run on
  ``worker/gang.py``).

Each test that spawns a process bounds it (a deadline under 120 s) and
kills it on the way out.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 100.0
N_NEW = 8
PROMPTS = [[5, 9, 17, 3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]


def _worker_env(url, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("WORKER_")}
    env.update({"CORDUM_STATEBUS_URL": url, "CORDUM_FORCE_CPU": "1",
                "WORKER_LLAMA_DTYPE": "float32", "WORKER_ID": "w-port",
                "WORKER_HEARTBEAT_INTERVAL": "0.5", "CORDUM_LOG_FORMAT": "json",
                "PYTHONPATH": str(REPO), **extra})
    return env


@contextlib.contextmanager
def _spawned(env):
    proc = subprocess.Popen([sys.executable, "-m", "cordum_tpu_torch.cmd.worker"], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)


async def _exited(proc, deadline):
    """The process's output once it exits, waited for off the event loop
    (the statebus server this test runs must keep answering it)."""
    out, _ = await asyncio.to_thread(proc.communicate, None,
                                     max(5.0, deadline - time.monotonic()))
    return out


def _exit_record(output):
    recs = [json.loads(x) for x in output.splitlines() if x.startswith("{")]
    return next(r for r in reversed(recs) if r.get("msg") == "worker stopped")


async def _wait_for(pred, what, deadline):
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _port_greedy(compute, prompt, n_new):
    from cordum_tpu_torch.models import llama as tl

    toks = list(prompt)
    params = compute.llama_params()
    with torch.no_grad():
        for _ in range(n_new):
            logits = tl.forward(params, torch.tensor([toks]), compute.llama_cfg)[0, -1]
            toks.append(int(torch.argmax(logits)))
    return toks[len(prompt):]


async def _reference_control_plane():
    """A reference statebus server and the reference scheduler stack over
    it (pool ``tpu`` for ``job.tpu.>``, requiring ``tpu``)."""
    from cordum_tpu.controlplane.safetykernel.kernel import SafetyKernel
    from cordum_tpu.controlplane.scheduler.engine import Engine
    from cordum_tpu.controlplane.scheduler.safety_client import SafetyClient
    from cordum_tpu.controlplane.scheduler.strategy import LeastLoadedStrategy
    from cordum_tpu.infra.config import parse_pool_config
    from cordum_tpu.infra.jobstore import JobStore
    from cordum_tpu.infra.memstore import MemoryStore
    from cordum_tpu.infra.registry import WorkerRegistry
    from cordum_tpu.infra.statebus import StateBusServer, connect

    srv = StateBusServer(port=0)
    await srv.start()
    url = f"statebus://127.0.0.1:{srv.port}"
    kv, bus, conn = await connect(url)
    js = JobStore(kv)
    reg = WorkerRegistry()
    pc = parse_pool_config({"topics": {"job.tpu.>": "tpu"}, "pools": {"tpu": {"requires": ["tpu"]}}})
    eng = Engine(bus=bus, job_store=js, safety=SafetyClient(SafetyKernel(policy_doc={}).check),
                 strategy=LeastLoadedStrategy(reg, pc), registry=reg)
    await eng.start()
    return srv, url, conn, bus, js, MemoryStore(kv), reg, eng


async def test_reference_scheduler_drives_a_port_worker_process():
    from cordum_tpu.protocol import subjects as subj
    from cordum_tpu.protocol.types import BusPacket, JobRequest
    from cordum_tpu_torch.models import llama as tl
    from cordum_tpu_torch.worker.handlers import GPUCompute

    deadline = time.monotonic() + DEADLINE_S
    srv, url, conn, bus, js, ms, reg, eng = await _reference_control_plane()
    env = _worker_env(url, WORKER_POOL="tpu", WORKER_TOPICS="job.tpu.>",
                      WORKER_CAPABILITIES="tpu,echo")
    jobs = {"echo": {"op": "echo", "x": [1, 2]},
            "infer": {"op": "infer", "tokens": [[3, 1, 4, 1, 5], [9, 2, 6]]},
            "embed": {"op": "embed", "texts": ["alpha beta", "the agent recalls its context"]},
            **{f"gen{i}": {"op": "llm.generate", "tokens": p, "max_new_tokens": N_NEW}
               for i, p in enumerate(PROMPTS)}}
    try:
        with _spawned(env) as proc:
            await _wait_for(lambda: proc.poll() is not None or reg.get("w-port") is not None,
                            "the worker's heartbeat", deadline)
            assert proc.poll() is None, proc.communicate()[0][-3000:]
            for jid, payload in jobs.items():
                ptr = await ms.put_context(jid, payload)
                await bus.publish(subj.SUBMIT, BusPacket.wrap(JobRequest(
                    job_id=jid, topic=f"job.tpu.{payload['op']}", context_ptr=ptr)))
            states = {}

            async def all_done():
                for jid in jobs:
                    states[jid] = await js.get_state(jid)
                return all(s in ("SUCCEEDED", "FAILED", "DENIED", "CANCELLED")
                           for s in states.values())

            while not await all_done():
                assert time.monotonic() < deadline, states
                await asyncio.sleep(0.1)
            assert all(s == "SUCCEEDED" for s in states.values()), states
            got = {jid: await ms.get_result(jid) for jid in jobs}
            proc.send_signal(signal.SIGTERM)
            out = await _exited(proc, deadline)
        assert proc.returncode == 0, out[-3000:]
    finally:
        await eng.stop()
        await conn.close()
        await srv.stop()
    here = GPUCompute(device="cpu", seed=0,
                      llama_cfg=dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32))
    assert got["echo"]["echo"] == jobs["echo"] and got["echo"]["worker"] == "w-port"
    assert got["infer"]["next_tokens"] == here.infer(jobs["infer"]["tokens"])["next_tokens"]
    assert got["embed"]["dim"] == here.embedder.cfg.d_model
    assert len(got["embed"]["embeddings"]) == 2
    for i, prompt in enumerate(PROMPTS):
        assert got[f"gen{i}"]["tokens"] == _port_greedy(here, prompt, N_NEW)
    assert _exit_record(out)["cancelled_sessions"] == 0


async def test_sigterm_drains_the_worker_process_mid_generation():
    """SIGTERM while a generation streams: the session goes back to the
    scheduler (no peer to take it), nothing is cancelled, exit 0."""
    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.protocol import subjects as subj
    from cordum_tpu_torch.protocol.types import BusPacket, JobRequest

    deadline = time.monotonic() + DEADLINE_S
    srv = statebus.StateBusServer(port=0)
    await srv.start()
    url = f"statebus://127.0.0.1:{srv.port}"
    kv, bus, conn = await statebus.connect(url)
    beats, progress, results = [], [], []

    async def on(subject, pkt):
        (beats if pkt.heartbeat else progress if pkt.job_progress else results).append(pkt)

    try:
        for subject in (subj.HEARTBEAT, subj.PROGRESS, subj.RESULT):
            await bus.subscribe(subject, on)
        with _spawned(_worker_env(url, WORKER_SERVING_MAX_NEW_TOKENS="100")) as proc:
            await _wait_for(lambda: beats or proc.poll() is not None, "a heartbeat", deadline)
            ptr = await MemoryStore(kv).put_context(
                "long", {"op": "llm.generate", "tokens": [1, 2, 3], "max_new_tokens": 100})
            await bus.publish(subj.direct_subject("w-port"), BusPacket.wrap(
                JobRequest(job_id="long", topic="job.gpu.llm.generate", context_ptr=ptr)))
            await _wait_for(lambda: progress or results, "the first streamed token", deadline)
            proc.send_signal(signal.SIGTERM)
            out = await _exited(proc, deadline)
        assert proc.returncode == 0, out[-3000:]
        exit_rec = _exit_record(out)
        assert exit_rec["drained"] is True and exit_rec["cancelled_sessions"] == 0, exit_rec
        await _wait_for(lambda: results, "the job's result", deadline)
        assert all(r.job_result.status != "CANCELLED" for r in results)
    finally:
        await conn.close()
        await srv.stop()


@pytest.mark.parametrize("extra, message", [
    ({"CORDUM_FORCE_CPU": ""}, "no CUDA device"),
    # a local mesh and gang members are served now: WORKER_TP=2 and
    # WORKER_GANG=1 pass the boot checks and the worker stops only at the
    # unreachable statebus
    ({"WORKER_TP": "2"}, "Connect call failed"),
    ({"WORKER_GANG": "1"}, "Connect call failed"),
], ids=["no-card", "tp", "gang"])
def test_worker_process_refuses_what_it_cannot_do(extra, message):
    if "CORDUM_FORCE_CPU" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker would run on it")
    env = _worker_env("statebus://127.0.0.1:1", **extra)
    with _spawned(env) as proc:
        out, _ = proc.communicate(timeout=90)
    assert proc.returncode != 0 and message in out, out[-3000:]
