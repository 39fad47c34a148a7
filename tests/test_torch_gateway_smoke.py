"""Phase 17.1-17.3 of ``chip_smoke.py`` rehearsed on the CPU, at a tiny
model and a small fleet and backlog: phase 16's in-process scheduler, then
the port's gateway (built as ``cmd/gateway.py`` builds it, listening on
127.0.0.1) over a port worker (``LlamaConfig.tiny()`` in fp32 and a small
fp32 embedder on the CPU; the kernels' wrappers replaced by counting
stand-ins over the plain versions, since the CPU launches no kernel),
driven over HTTP; then the planted faults the phase must refuse: tokens
that differ from 16.1's, a chunk vector that differs from the direct embed
job's, and a backlog job that never ends.
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from cordum_tpu_torch import native
from cordum_tpu_torch.models import embedder as em
from cordum_tpu_torch.models import llama
from cordum_tpu_torch.ops import dense_attention as da
from cordum_tpu_torch.ops import embed_attention as ea
from cordum_tpu_torch.ops import paged_attention as pa

FLEET = {"n_workers": 40, "n_jobs": 300, "burst": 64, "n_picks": 200, "timeout_s": 60.0}
GATEWAY = {"n_workers": 40, "n_jobs": 300, "n_chunks": 6, "timeout_s": 60.0}


@pytest.fixture(autouse=True)
def _compiler():
    if native.compiler() is None:
        pytest.skip("no C compiler on this host: phases 16 and 17 need the native scan")


@pytest.fixture
def counting(monkeypatch):
    """Counting stand-ins for the three kernels of the worker's path (as
    ``tests/test_torch_scheduler_smoke.py`` sets them)."""
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
    monkeypatch.setattr(cs, "GATEWAY_EMBED_TEXTS", 24)
    yield
    cs.zero_launches()


async def _phase(fault=None):
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    ecfg = dataclasses.replace(em.EmbedderConfig(), n_layers=2, d_model=64, d_ff=128,
                               dtype=torch.float32)
    w, compute, sched = cs.make_port_worker(torch, cpu, "w-bf16",
                                            topics=["job.gpu.>", cs.GATEWAY_EMBED_TOPIC],
                                            llama_cfg=cfg, embedder_cfg=ecfg)
    await sched.start()
    await w.start()
    rng = np.random.default_rng(0)
    try:
        single, texts, _ = await cs.embed_jobs(sched, cs.make_texts(rng, 2, 1, 20), 1,
                                               "embed1", one_at_a_time=True)
        gens = [{"op": "llm.generate", "tokens": rng.integers(0, cfg.vocab_size, n).tolist(),
                 "max_new_tokens": 5} for n in (5, 20)]
        infer = [{"op": "infer", "tokens": [rng.integers(0, cfg.vocab_size, 12).tolist()]}]
        record = {"infer": [(p, doc) for p in infer for _, doc in await sched.run([p], "i")],
                  "embed1": [({"op": "embed", "texts": texts[j]}, d) for j, d in single],
                  "gen": [(p, doc) for p, (_, doc) in zip(gens, await sched.run(gens, "g"))]}
        seen = {}
        await cs.phase_scheduler(torch, cpu, "cpu", w, sched, record, out=seen, **FLEET)
        if fault == "tokens":
            key = next(iter(seen["tokens"]))
            seen["tokens"][key] = seen["tokens"][key][:-1] + [seen["tokens"][key][-1] + 1]
        return await cs.phase_gateway(torch, cpu, "cpu", w, sched, compute, record, seen,
                                      **GATEWAY)
    finally:
        await w.stop()


def test_phase17_rehearsed(counting):
    launches, numbers = asyncio.run(_phase())
    assert launches["paged_attention"] > 0 and launches["embed_attention"] > 0
    assert numbers["jobs"] == GATEWAY["n_jobs"] and numbers["workers"] == GATEWAY["n_workers"] + 1
    assert numbers["context embeds/s"] > 0 and numbers["context embed jobs"] == 24 // 16 + 1
    for k in ("accepted jobs/s", "scheduled jobs/s", "dispatch->result p50 ms",
              "dispatch->result p99 ms"):
        assert numbers[k] > 0, k


def test_tokens_unlike_16_1_are_refused(counting):
    with pytest.raises(AssertionError, match="over HTTP, 16.1"):
        asyncio.run(_phase("tokens"))


def test_a_changed_chunk_vector_is_refused(counting, monkeypatch):
    stored = cs.stored_vectors

    async def off(kv, memory_id, texts):
        v = (await stored(kv, memory_id, texts)).copy()
        v[0, 0] += 2.0 ** -20
        return v

    monkeypatch.setattr(cs, "stored_vectors", off)
    with pytest.raises(AssertionError, match="differ from the direct embed job"):
        asyncio.run(_phase())


def test_a_lost_backlog_job_is_refused(counting, monkeypatch):
    handler = cs.FleetResponder._handler

    def dropping(self, worker_id):
        inner = handler(self, worker_id)

        async def on_job(subject, pkt):
            jid = pkt.job_request.job_id if pkt.job_request is not None else ""
            if jid.startswith("fleet17-") and jid.endswith("7"):  # some reach the fleet
                return
            await inner(subject, pkt)
        return on_job

    monkeypatch.setattr(cs.FleetResponder, "_handler", dropping)
    monkeypatch.setitem(GATEWAY, "timeout_s", 3.0)
    with pytest.raises(AssertionError, match="did not end SUCCEEDED"):
        asyncio.run(_phase())
