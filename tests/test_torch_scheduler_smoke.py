"""Phase 16 of ``chip_smoke.py`` rehearsed on the CPU, at a tiny model and
a small fleet and backlog: the port's scheduler in process over a port
worker (``LlamaConfig.tiny()`` in fp32 on the CPU, the kernels' wrappers
replaced by counting stand-ins over the plain versions, since the CPU
launches no kernel), then the planted faults the phase must refuse: a lost
job, a job dispatched twice, a wrong pick of the C scan and a failed native
build.
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from cordum_tpu_torch import native
from cordum_tpu_torch.controlplane.scheduler import native_scan
from cordum_tpu_torch.infra.bus import LoopbackBus
from cordum_tpu_torch.infra.kv import MemoryKV
from cordum_tpu_torch.models import embedder as em
from cordum_tpu_torch.models import llama
from cordum_tpu_torch.ops import dense_attention as da
from cordum_tpu_torch.ops import embed_attention as ea
from cordum_tpu_torch.ops import paged_attention as pa

FLEET = {"n_workers": 40, "n_jobs": 300, "burst": 64, "n_picks": 400, "timeout_s": 60.0}


@pytest.fixture(autouse=True)
def _compiler():
    if native.compiler() is None:
        pytest.skip("no C compiler on this host: phase 16 needs the native scan")


@pytest.fixture
def counting(monkeypatch):
    """Counting stand-ins for the three kernels of the worker's path: each
    adds to its wrapper's launch counter and calls the wrapper (the plain
    version on the CPU)."""
    def stand_in(counter, orig):
        def f(*a, **k):
            counter.launches += 1
            return orig(*a, **k)
        return f

    monkeypatch.setattr(llama, "paged_attention", stand_in(pa.paged_attention,
                                                           llama.paged_attention))
    monkeypatch.setattr(llama, "dense_attention", stand_in(da.dense_attention_fwd,
                                                           llama.dense_attention))
    kwd = dict(em.forward.__kwdefaults__)
    monkeypatch.setattr(em.forward, "__kwdefaults__",
                        {**kwd, "attention": stand_in(ea.embed_attention, kwd["attention"])})
    yield
    cs.zero_launches()


async def _phase(**cluster_kw):
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    w, _, sched = cs.make_port_worker(torch, cpu, "w-bf16", topics=["job.gpu.>"],
                                      llama_cfg=cfg)
    await sched.start()
    await w.start()
    rng = np.random.default_rng(0)
    try:
        infer = [{"op": "infer", "tokens": [rng.integers(0, cfg.vocab_size, 12).tolist()]}]
        single, texts, _ = await cs.embed_jobs(sched, cs.make_texts(rng, 2, 1, 20), 1,
                                               "embed1", one_at_a_time=True)
        gens = [{"op": "llm.generate", "tokens": rng.integers(0, cfg.vocab_size, n).tolist(),
                 "max_new_tokens": 5} for n in (5, 20)]
        record = {"infer": [(p, doc) for p in infer for _, doc in await sched.run([p], "i")],
                  "embed1": [({"op": "embed", "texts": texts[j]}, d) for j, d in single],
                  "gen": [(p, doc) for p, (_, doc) in zip(gens, await sched.run(gens, "g"))]}
        return await cs.phase_scheduler(torch, cpu, "cpu", w, sched, record, **cluster_kw)
    finally:
        await w.stop()


@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
def test_phase16_rehearsed(counting, busy, monkeypatch):
    """``busy``: the worker's heartbeat reads an overloaded host, so the
    scheduler sends its jobs on the topic the worker listens to."""
    if busy:
        from cordum_tpu_torch.worker import runtime

        monkeypatch.setattr(runtime, "_host_cpu_load", lambda: 95.0)
    launches, cluster = asyncio.run(_phase(**FLEET))
    assert launches["paged_attention"] > 0 and launches["embed_attention"] > 0
    assert launches["dense_attention_fwd"] > 0
    assert cluster["jobs"] == FLEET["n_jobs"] and cluster["workers"] == FLEET["n_workers"] + 1
    assert cluster["native picks checked"] == FLEET["n_picks"]
    assert cluster["C scan share of picks"] == 1.0


async def _fleet(**kw):
    stack = cs.SchedStack(LoopbackBus(), MemoryKV(), policy_doc=cs.sched_policy())
    await stack.start()
    try:
        return await cs.sched_cluster(stack, **{**FLEET, "n_jobs": 80, "timeout_s": 3.0, **kw})
    finally:
        await stack.stop()


def test_a_lost_job_is_refused():
    with pytest.raises(AssertionError, match="did not end SUCCEEDED"):
        asyncio.run(_fleet(drop={"fleet16-00007"}))


def test_a_job_dispatched_twice_is_refused(monkeypatch):
    from cordum_tpu_torch.protocol.types import LABEL_BUS_MSG_ID, BusPacket

    publish = LoopbackBus.publish

    async def twice(self, subject, pkt):
        await publish(self, subject, pkt)
        r = pkt.job_request
        if subject.startswith("worker.") and r is not None and r.job_id == "fleet16-00011":
            # a second dispatch under its own message id (the bus drops a copy)
            again = dataclasses.replace(r, labels={**r.labels, LABEL_BUS_MSG_ID: "again"})
            await publish(self, subject, BusPacket.wrap(again, sender_id="scheduler"))

    monkeypatch.setattr(LoopbackBus, "publish", twice)
    with pytest.raises(AssertionError, match="not dispatched exactly once"):
        asyncio.run(_fleet())


def test_a_wrong_pick_is_refused(monkeypatch):
    pick = native_scan.PackedWorkers.pick_prepared

    def off_by_one(self, prep):
        got = pick(self, prep)
        if got is None:
            return got
        return self.worker_ids[(self.worker_ids.index(got) + 1) % self.n]

    monkeypatch.setattr(native_scan.PackedWorkers, "pick_prepared", off_by_one)
    with pytest.raises(AssertionError, match="picks differ"):
        asyncio.run(_fleet(n_jobs=20))


def test_a_failed_native_build_is_refused(tmp_path, monkeypatch):
    bad = tmp_path / "strategy_scan.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError):
        cs.SchedStack(LoopbackBus(), MemoryKV(), policy_doc=cs.sched_policy())
