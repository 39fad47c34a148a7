"""The port's context service against the JAX package's.

The same documents, chat events and queries go to each package's
``ContextService`` (``tests/test_context.py``'s set-up over a
``MemoryKV``); the windows, their RAG scores and the KV state must be
equal, with a deterministic embedder (``tests/test_torch_workflow.py``
``HashEmbedder``), without one (the lexical fallback) and under token
budgets.  ``BusEmbedder`` must send the same embed jobs from both packages.
Last, the port's ``BusEmbedder`` runs its jobs on a port worker through
the port's scheduler: the vectors it returns are the worker embedder's,
from the attention kernel's path, not an embedding made on the host.
"""
from __future__ import annotations

import asyncio
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_gateway import PACKAGES, Pkg, counted_ids
from tests.test_torch_workflow import HashEmbedder

DOCS = [{"file_path": "src/app.py", "content": "def route(req): return handler(req)"},
        {"file_path": "docs/ops.md", "content": "the gateway sheds batch jobs first"},
        {"file_path": "notes.txt", "content": "alpha beta gamma"},
        {"file_path": "src/auth.py", "content": "token bucket per key", "labels": {"k": "v"}},
        {"file_path": "empty", "content": ""}]
QUERIES = ["how does the gateway shed", "alpha", "src/app.py route", "", "token bucket"]


def service(root, kv, embedder=None, **kw):
    return importlib.import_module(f"{root}.context.service").ContextService(
        kv, embedder=embedder, **kw)


def run(root, body):
    """``body(root, kv)`` on one package with a fresh KV; returns its
    record and the KV's contents."""
    pkg = Pkg(root)

    async def go():
        kv = pkg.kv.MemoryKV()
        out = await body(root, kv)
        state = {k: (sorted(e.value) if isinstance(e.value, set) else e.value)
                 for k, e in sorted(kv._data.items())}
        return out, state

    return asyncio.run(go())


def both(body):
    ref, port = (run(root, body) for root in PACKAGES)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    return ref[0]


def messages(msgs):
    return [m.to_dict() for m in msgs]


@pytest.mark.parametrize("embed", [True, False], ids=["semantic", "lexical"])
@pytest.mark.parametrize("budget", [4000, 24, 3])
def test_windows_and_scores(embed, budget):
    async def body(root, kv):
        emb = HashEmbedder() if embed else None
        svc = service(root, kv, emb, max_chunks=3, embed_batch=2)
        for i in range(25):  # past the history window
            await svc.update_memory("m", user_payload={"turn": i} if i % 2 else f"q{i}",
                                    model_response=f"a{i}" if i % 3 else "")
        n = await svc.put_chunks("m", DOCS)
        again = await svc.put_chunks("m", DOCS[:3] + [{"file_path": "new", "content": "x y"}])
        out = {"embedded": [n, again]}
        for mode in ("RAW", "CHAT", "RAG"):
            for q in QUERIES:
                out[f"{mode}:{q}"] = messages(await svc.build_window(
                    "m", mode=mode, payload=q or None, max_input_tokens=budget))
        await svc.set_summary("fresh", "a summary of nothing")
        out["summary"] = messages(await svc.build_window("fresh", mode="RAG", payload="x"))
        out["calls"] = emb.calls if emb else None
        return out

    t = both(body)
    rag = t["RAG:how does the gateway shed"]
    if embed:
        assert t["embedded"] == [5, 1]
    if embed and budget == 4000:
        assert [m["source"][:4] for m in rag[:3]] == ["rag:"] * 3
    assert t["summary"][0]["source"] == "summary"


def test_estimate_and_trim():
    got = []
    for root in PACKAGES:
        m = importlib.import_module(f"{root}.context.service")
        msgs = [m.ModelMessage(role="system", content="x" * n, source=s)
                for n, s in ((40, "rag:0.9"), (400, "history"), (12, "history"),
                             (900, "payload"))]
        got.append([(m.estimate_tokens(t), [x.to_dict() for x in m.trim_to_budget(msgs, b)])
                    for t, b in (("", 1), ("abcd" * 9, 50), ("é" * 7, 300), ("z", 0))])
    assert got[1] == got[0]


class EmbedResponder:
    """Answers every embed job on ``sys.job.submit`` with
    ``HashEmbedder`` vectors, as a worker's result."""

    def __init__(self, pkg, bus, mem):
        self.pkg, self.bus, self.mem = pkg, bus, mem
        self.embedder = HashEmbedder()

    async def on_submit(self, subject, pkt):
        T = self.pkg.types
        req = pkt.job_request
        payload = await self.mem.get_context(req.context_ptr)
        vecs = self.embedder.embed(payload["texts"])
        ptr = await self.mem.put_result(req.job_id, {"embeddings": vecs.tolist()})
        await self.bus.publish(self.pkg.subj.RESULT, T.BusPacket.wrap(T.JobResult(
            job_id=req.job_id, status="SUCCEEDED", result_ptr=ptr, worker_id="w")))


def test_bus_embedder_sends_the_same_jobs():
    async def one(root):
        pkg = Pkg(root)
        with counted_ids(pkg):
            kv = pkg.kv.MemoryKV()
            bus = pkg.bus.LoopbackBus()
            mem = pkg.memstore.MemoryStore(kv)
            sent = []

            async def tap(subject, pkt):
                body = pkt.to_dict()
                for k in ("created_at_us", "trace_id", "span_id", "msg_id"):
                    body.pop(k, None)
                sent.append((subject, body, await mem.get_context(pkt.job_request.context_ptr)))

            responder = EmbedResponder(pkg, bus, mem)
            await bus.subscribe(pkg.subj.SUBMIT, tap)
            await bus.subscribe(pkg.subj.SUBMIT, responder.on_submit)
            emb = pkg.context.BusEmbedder(bus, mem, texts_per_job=3, tenant_id="t1")
            svc = service(root, kv, emb, embed_batch=5)
            n = await svc.put_chunks("m", DOCS + [{"file_path": f"f{i}", "content": f"c {i}"}
                                                  for i in range(4)])
            window = messages(await svc.build_window("m", mode="RAG", payload="gateway"))
            await emb.stop()
            await bus.close()
            return {"n": n, "sent": sent, "window": window, "jobs": emb.jobs_total,
                    "texts": emb.embeds_total}

    ref, port = (asyncio.run(one(root)) for root in PACKAGES)
    assert port == ref
    assert ref["n"] == 9 and ref["jobs"] == 2 + 2 + 1 and ref["texts"] == 10
    req = ref["sent"][0][1]["payload"]
    assert ref["sent"][0][0] == "sys.job.submit" and req["topic"] == "job.tpu.embed"
    assert req["labels"] == {"cordum.op": "embed", "cordum.batch_key": "embed"}


def test_bus_embedder_reports_a_failed_job():
    async def one(root):
        pkg = Pkg(root)
        kv = pkg.kv.MemoryKV()
        bus = pkg.bus.LoopbackBus()
        mem = pkg.memstore.MemoryStore(kv)

        async def refuse(subject, pkt):
            await bus.publish(pkg.subj.RESULT, pkg.types.BusPacket.wrap(pkg.types.JobResult(
                job_id=pkt.job_request.job_id, status="DENIED", error_message="no")))

        await bus.subscribe(pkg.subj.SUBMIT, refuse)
        emb = pkg.context.BusEmbedder(bus, mem)
        try:
            await emb.aembed(["a", "b"])
        except RuntimeError as e:
            return str(e).split(" reached ")[1]
        finally:
            await emb.stop()
        return None

    got = [asyncio.run(one(root)) for root in PACKAGES]
    assert got[1] == got[0] == "DENIED: no"


# ---------------------------------------------------------------- on a port worker

#: ``job.tpu.embed`` (``BusEmbedder``'s topic) and ``job.gpu.>`` both
#: route to the port's worker pool
POOLS = {"topics": {"job.tpu.>": "gpu", "job.gpu.>": "gpu"},
         "pools": {"gpu": {"requires": ["gpu"], "min_chips": 1}}}


def test_bus_embedder_runs_on_a_port_worker(monkeypatch):
    import chip_smoke as cs
    from cordum_tpu_torch.context.service import BusEmbedder, ContextService
    from cordum_tpu_torch.controlplane.safetykernel.kernel import SafetyKernel
    from cordum_tpu_torch.controlplane.scheduler.engine import Engine
    from cordum_tpu_torch.controlplane.scheduler.safety_client import SafetyClient
    from cordum_tpu_torch.controlplane.scheduler.strategy import LeastLoadedStrategy
    from cordum_tpu_torch.infra.config import parse_pool_config
    from cordum_tpu_torch.infra.jobstore import JobStore
    from cordum_tpu_torch.infra.registry import WorkerRegistry
    from cordum_tpu_torch.models import embedder as em
    from cordum_tpu_torch.models.embedder import EmbedderConfig
    from cordum_tpu_torch.ops import embed_attention as ea

    counted = []
    kwd = dict(em.forward.__kwdefaults__)

    def counting(*a, **k):
        counted.append(1)
        return kwd["attention"](*a, **k)

    monkeypatch.setattr(em.forward, "__kwdefaults__", {**kwd, "attention": counting})
    cfg = dataclasses.replace(EmbedderConfig(), n_layers=2, d_model=64, d_ff=128,
                              dtype=torch.float32)

    async def go():
        w, compute, _ = cs.make_port_worker(torch, torch.device("cpu"), "w-ctx",
                                            embedder_cfg=cfg)
        bus, mem = w.bus, w.store
        kernel = SafetyKernel(policy_doc={"tenants": {"default": {"allow_topics": ["job.>"]}}})
        await kernel.reload()
        reg = WorkerRegistry()
        sched = Engine(bus=bus, job_store=JobStore(mem.kv), safety=SafetyClient(kernel.check),
                       strategy=LeastLoadedStrategy(reg, parse_pool_config(POOLS)), registry=reg)
        await sched.start()
        await w.start()
        emb = BusEmbedder(bus, mem, texts_per_job=4, tenant_id="default")
        svc = ContextService(mem.kv, embedder=emb)
        try:
            for _ in range(200):
                if reg.get("w-ctx") is not None:
                    break
                await asyncio.sleep(0.01)
            texts = [f"{d['content']}|{d['file_path']}" for d in DOCS]
            n = await svc.put_chunks("m", DOCS)
            window = await svc.build_window("m", mode="RAG", payload="gateway sheds")
            got = np.stack([np.frombuffer(await mem.kv.get(f"mem:m:embed:{h}"), np.float32)
                            for h in (importlib.import_module(
                                "cordum_tpu_torch.context.service")._chunk_hash(d)
                                for d in DOCS)])
            return n, window, got, texts, compute, emb.jobs_total
        finally:
            await emb.stop()
            await w.stop()
            await sched.stop()

    n, window, got, texts, compute, jobs = asyncio.run(go())
    assert n == len(DOCS) and jobs == 2 + 1  # five chunks in jobs of four, then the query
    want = cs.plain_embeddings(torch, compute.embedder, [d["content"] for d in DOCS])
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= cs.EMBED_ATOL["float32"]
    assert counted, "the embeds never reached the worker's embedder"
    assert window[0].source.startswith("rag:") and window[-1].content == "gateway sheds"
    assert ea.embed_attention.launches == 0  # the CPU runs the plain version
