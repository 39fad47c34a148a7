"""The port's scheduler binary (``python -m cordum_tpu_torch.cmd.scheduler``)
with the port's statebus and worker binaries, all as processes over TCP on
the CPU (``CORDUM_FORCE_CPU=1``): phase 16.4 of ``chip_smoke.py``
rehearsed.

* ``echo``, ``infer``, ``embed`` (one text a job, one job at a time) and
  ``llm.generate`` jobs submitted on ``sys.job.submit`` as the gateway
  submits them complete through the scheduler, dispatched to the worker
  process; the results equal an in-process port worker's on the same jobs
  (the same config and seed, one CPU thread on both sides) and the tokens
  the dense greedy oracle's up to its first near-tie; SIGTERM stops the
  scheduler with exit 0 and the worker drains.
* ``SAFETY_KERNEL_ADDR`` selects the remote kernel and nothing replaces
  it: with no kernel listening there, a job is denied fail-closed.

Each process runs under a deadline below 120 s and is stopped on every
path.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs

DEADLINE_S = 100.0
N_NEW = 6


async def _record(cfg):
    """The jobs of 16.4 straight to an in-process port worker on the CPU:
    phase 8's record, as ``drive_worker_process`` returns it."""
    from cordum_tpu_torch.models import llama

    cpu = torch.device("cpu")
    w, compute, sched = cs.make_port_worker(torch, cpu, "w-rec", llama_cfg=cfg)
    await sched.start()
    await w.start()
    rng = np.random.default_rng(5)
    try:
        infer = [{"op": "infer", "tokens": [rng.integers(0, cfg.vocab_size, 9).tolist(),
                                            rng.integers(0, cfg.vocab_size, 4).tolist()]}]
        embeds = [{"op": "embed", "texts": t} for t in (["alpha beta"], ["the agent recalls"])]
        gens = [{"op": "llm.generate", "tokens": rng.integers(0, cfg.vocab_size, n).tolist(),
                 "max_new_tokens": N_NEW} for n in (4, 11)]
        done = {}
        for tag, jobs in (("infer", infer), ("embed1", embeds), ("gen", gens)):
            done[tag] = [(p, doc) for p in jobs for _, doc in await sched.run([p], tag)]
    finally:
        await w.stop()
    params = compute.llama_params()
    done["ties"] = [cs.dense_greedy(torch, llama, params, cfg, p["tokens"], N_NEW, cpu)[1]
                    for p in gens]
    for (p, doc), ties in zip(done["gen"], done["ties"]):
        want, _ = cs.dense_greedy(torch, llama, params, cfg, p["tokens"], N_NEW, cpu)
        cs.compare_near_tie(doc["tokens"], want, ties, "in-process worker")
    return done


def test_scheduler_process_runs_jobs_end_to_end(tmp_path, monkeypatch):
    from cordum_tpu_torch.models import llama

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
        record = asyncio.run(_record(cfg))
        rc, exit_doc = asyncio.run(cs.drive_scheduler_process(
            torch, torch.device("cpu"), "cpu", str(tmp_path), record, timeout_s=DEADLINE_S))
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert exit_doc["drained"] is True and exit_doc["cancelled_sessions"] == 0
    # the CPU counts no kernel launch: the card run checks them
    with pytest.raises(AssertionError, match="launches"):
        cs.check_sched_process_launches(exit_doc, cfg.n_layers, 2)


def test_scheduler_process_keeps_an_unreachable_remote_kernel(tmp_path):
    """A remote kernel that does not answer denies (fail-closed); the
    embedded kernel, which would allow the job, never stands in for it."""
    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.infra.jobstore import JobStore
    from cordum_tpu_torch.infra.memstore import MemoryStore

    async def body():
        port, dead = cs.free_port(), cs.free_port()
        url = f"statebus://127.0.0.1:{port}"
        env = {**os.environ, "STATEBUS_PORT": str(port), "CORDUM_STATEBUS_URL": url,
               "SAFETY_KERNEL_ADDR": f"http://127.0.0.1:{dead}", "CORDUM_LOG_FORMAT": "json",
               "POOL_CONFIG_PATH": str(tmp_path / "missing-pools.yaml")}
        logs = {n: str(tmp_path / f"{n}.log") for n in ("statebus", "scheduler")}
        procs = [cs.start_process(["cordum_tpu_torch.cmd.statebus"], env, logs["statebus"])]
        conn = None
        try:
            kv, bus, conn = await cs.connect_when_up(statebus, url, procs[0], timeout_s=30)
            procs.append(cs.start_process(["cordum_tpu_torch.cmd.scheduler"], env,
                                          logs["scheduler"]))
            await cs.wait_log(logs["scheduler"], '"scheduler running"', procs[1], timeout_s=60)
            stack = types_ns(bus, kv)
            await cs.gateway_submit(stack, "remote-1", "job.default", {"op": "echo"})
            states = await cs.sched_wait(stack.job_store, ["remote-1"], timeout_s=30)
            decision = await stack.job_store.get_safety_decision("remote-1")
            rc = cs.stop_process(procs[1], timeout_s=30)
        finally:
            if conn is not None:
                await conn.close()
            for proc in procs:
                cs.stop_process(proc, timeout_s=30)
        return states["remote-1"], decision, rc

    def types_ns(bus, kv):
        import types

        return types.SimpleNamespace(bus=bus, job_store=JobStore(kv), mem=MemoryStore(kv))

    t0 = time.monotonic()
    state, decision, rc = asyncio.run(body())
    assert time.monotonic() - t0 < DEADLINE_S
    assert state == "DENIED" and "fail-closed" in decision.reason, decision
    assert rc == 0
