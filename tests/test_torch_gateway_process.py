"""The port's gateway and workflow engine binaries (``python -m
cordum_tpu_torch.cmd.gateway``, ``...cmd.workflow_engine``) with the port's
statebus, scheduler and worker binaries, all as processes over TCP on the
CPU (``CORDUM_FORCE_CPU=1``): phase 17.4 of ``chip_smoke.py`` rehearsed.

* ``echo``, ``infer``, ``embed`` and ``llm.generate`` jobs submitted over
  HTTP complete through the scheduler process on the worker process, each
  dispatched once and SUCCEEDED once, with an in-process port worker's
  results on the same jobs (``tests/test_torch_scheduler_process.py``'s
  record); a context window's embeds leave the gateway process as ``embed``
  jobs and come back from the worker process equal to the same texts'
  ``embed`` job; a workflow with ``context.*`` steps and a generate step
  advances through the workflow engine process; SIGTERM stops every
  process with exit 0.
* The gateway process answers without the pools file (the reference's
  best-effort SLO config) and refuses a request without its API key.

Each process runs under a deadline below 120 s and is stopped on every
path.
"""
from __future__ import annotations

import asyncio
import dataclasses

import pytest
import torch

import chip_smoke as cs
from tests.test_torch_scheduler_process import DEADLINE_S, _record


def test_gateway_processes_run_jobs_end_to_end(tmp_path, monkeypatch):
    from cordum_tpu_torch.models import llama

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
        record = asyncio.run(_record(cfg))
        rcs, exit_doc = asyncio.run(cs.drive_gateway_process(
            torch, torch.device("cpu"), "cpu", str(tmp_path), record, timeout_s=DEADLINE_S))
    finally:
        torch.set_num_threads(threads)
    assert rcs == {"gateway": 0, "workflow_engine": 0, "scheduler": 0, "worker": 0,
                   "statebus": 0}
    assert exit_doc["drained"] is True and exit_doc["cancelled_sessions"] == 0
    # the CPU counts no kernel launch: the card run checks them
    with pytest.raises(AssertionError, match="launches"):
        cs.check_sched_process_launches(exit_doc, cfg.n_layers, 2)


def test_gateway_process_with_an_unreadable_pools_file(tmp_path):
    """``cmd/gateway.py`` reads the pools file for its SLO and admission
    stanzas and runs on without them when it cannot parse it (the
    reference's behaviour, logged); it still checks API keys and stops
    with exit 0."""
    from cordum_tpu_torch.infra import statebus

    async def body():
        port, http_port = cs.free_port(), cs.free_port()
        url = f"statebus://127.0.0.1:{port}"
        env = cs.gateway_process_env(str(tmp_path), port, url, http_port,
                                     torch.device("cpu"), torch)
        bad_pools = tmp_path / "bad-pools.yaml"
        bad_pools.write_text("pools:\n  gpu:\n    min_chips: many\n")
        env["POOL_CONFIG_PATH"] = str(bad_pools)
        logs = {n: str(tmp_path / f"{n}.log") for n in ("statebus", "gateway")}
        procs = [cs.start_process(["cordum_tpu_torch.cmd.statebus"], env, logs["statebus"])]
        conn = None
        try:
            _, _, conn = await cs.connect_when_up(statebus, url, procs[0], timeout_s=30)
            procs.append(cs.start_process(["cordum_tpu_torch.cmd.gateway"], env,
                                          logs["gateway"]))
            await cs.wait_log(logs["gateway"], '"gateway listening"', procs[1], timeout_s=60)
            base = f"http://127.0.0.1:{http_port}"
            async with cs.GatewayClient(base, key="wrong") as bad:
                await bad.call("GET", "/api/v1/jobs", 401)
            async with cs.GatewayClient(base) as client:
                status = await client.call("GET", "/api/v1/status")
                health = await client.call("GET", "/healthz")
            rc = cs.stop_process(procs[1], timeout_s=30)
        finally:
            if conn is not None:
                await conn.close()
            for proc in procs:
                cs.stop_process(proc, timeout_s=30)
        with open(logs["gateway"]) as f:
            log = f.read()
        return status, health, rc, log

    status, health, rc, log = asyncio.run(body())
    assert status["bus"] and status["kv"] and status["policy_snapshot"]
    assert health and rc == 0
    assert "pool config unreadable; fleet SLO tracking disabled" in log
