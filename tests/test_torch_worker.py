"""Parity of the port's worker (``cordum_tpu_torch/worker/``: the runtime,
the ``GPUCompute`` op table, the micro-batcher and the serving engine) with
the JAX package's, on the CPU.

* Every op of the op table against the reference ``TPUCompute`` on the
  same weights (``params_from_jax``): ``infer`` tokens identical in fp32,
  embeddings within 1e-5 (fp32 embedder; the packages sum in other
  orders), the ``matmul`` chain within 1e-5 on shared numpy inputs in fp32
  (the reference draws its inputs with ``jax.random``, which torch cannot
  reproduce, so the two ops' checksums differ by construction).
* Batched results equal single-job results (1e-5 for embeddings: trimming
  the sequence to a bucket changes the products' shapes, hence their sum
  order).
* A bridged end-to-end run: the reference scheduler stack over the
  reference ``LoopbackBus`` and the port ``Worker`` on the port's bus, with
  a bridge that forwards every packet both ways through
  ``to_dict()``/``from_dict()`` and one KV under both stores.  Its results
  equal a reference worker's on the same weights and the same jobs.
* The wire types: a reference packet reads back through the port's
  ``from_dict`` and ``from_wire`` unchanged.
"""
from __future__ import annotations

import asyncio
import collections
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import embedder as je
from cordum_tpu.models import llama as jl
from cordum_tpu_torch.models import embedder as te
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.protocol import types as tt
from cordum_tpu_torch.worker import handlers as th
from cordum_tpu_torch.worker import runtime as trt

EMBED_ATOL = 1e-5
LLAMA_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=128)
EMBED_KW = dict(n_layers=2, d_model=128, max_len=64)
TEXTS = ["alpha beta gamma", "delta", "the quick brown fox jumps over it"]
ROWS = [[1, 2, 3], [4, 5], [7, 8, 9, 10, 11]]


@pytest.fixture(scope="module")
def computes():
    """The reference TPUCompute and the port's GPUCompute on the same
    fp32 weights (the port's params bridged from the reference's)."""
    from cordum_tpu.worker.handlers import TPUCompute

    jc = TPUCompute(tp=1, embedder_cfg=je.EmbedderConfig(dtype=jnp.float32, **EMBED_KW),
                    llama_cfg=jl.LlamaConfig(dtype=jnp.float32, **LLAMA_KW))
    jc._ensure_llama()
    tc = th.GPUCompute(
        device="cpu",
        embedder_cfg=te.EmbedderConfig(dtype=torch.float32, **EMBED_KW),
        llama_cfg=tl.LlamaConfig(dtype=torch.float32, **LLAMA_KW),
        llama_params=tl.params_from_jax(jax.tree.map(np.asarray, jc._llama_params), device="cpu"),
        embedder_params=te.params_from_jax(
            jax.tree.map(np.asarray, jc.embedder.params), device="cpu"),
    )
    return jc, tc


class _StubWorker:
    """Just enough of a worker for a handler called outside the runtime."""

    worker_id = "w-stub"
    serving = None

    async def run_in_executor(self, fn, *args):
        return fn(*args)


async def _call(handler, job_context, job_request, payload):
    ctx = job_context(request=job_request(job_id="j"), payload=payload, worker=_StubWorker())
    return await handler(ctx)


# ---------------------------------------------------------------------------
# the op table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", [
    {"op": "echo", "x": [1, 2]},
    {"op": "embed", "texts": TEXTS},
    {"op": "infer", "tokens": ROWS},
    {"op": "infer", "tokens": ROWS, "max_len": 8},
    {"op": "matmul", "b": 2, "n": 8, "k": 16, "m": 4, "iters": 2, "dtype": "float32"},
], ids=["echo", "embed", "infer", "infer-max_len", "matmul"])
async def test_op_table_matches_reference(computes, payload):
    from cordum_tpu.protocol.types import JobRequest
    from cordum_tpu.worker.handlers import make_tpu_handlers
    from cordum_tpu.worker.runtime import JobContext

    jc, tc = computes
    want = await _call(make_tpu_handlers(jc), JobContext, JobRequest, payload)
    got = await _call(th.make_gpu_handlers(tc), trt.JobContext, tt.JobRequest, payload)
    assert set(got) == set(want)
    if payload["op"] == "embed":
        assert got["dim"] == want["dim"]
        np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=EMBED_ATOL)
    elif payload["op"] == "matmul":
        assert got["shape"] == want["shape"] and got["flops"] == want["flops"]
        assert np.isfinite(got["checksum"])
    else:
        assert got == want


@pytest.mark.parametrize("payload, match", [
    ({"op": "llm.generate", "tokens": [1, 2]}, "requires the serving engine"),
    ({"op": "nope"}, "unknown op"),
    ({"op": "embed", "texts": "not a list"}, "requires texts"),
    ({"op": "train", "model": "gpt"}, "unknown model family 'gpt'"),
])
async def test_op_table_errors(computes, payload, match):
    _, tc = computes
    with pytest.raises(th.HandlerError, match=match):
        await _call(th.make_gpu_handlers(tc), trt.JobContext, tt.JobRequest, payload)


@pytest.mark.parametrize("model", ["moe", "moe-tiny"])
async def test_train_op_runs_the_moe_families(computes, tmp_path, monkeypatch, model):
    """The ``train`` op trains both MoE families (``MoEConfig.tiny()``) on
    the worker's device, with progress after each step and checkpoints
    under the worker's ``ckpt_root``."""
    _, tc = computes
    monkeypatch.setattr(tc, "ckpt_root", str(tmp_path))
    progress = []

    class Ctx(trt.JobContext):
        async def progress(self, percent, message=""):
            progress.append((round(percent), message))

    class ThreadWorker(_StubWorker):
        async def run_in_executor(self, fn, *args):  # the loop stays free for progress
            return await asyncio.to_thread(fn, *args)

    payload = {"op": "train", "model": model, "steps": 2, "batch": 2, "seq": 8,
               "checkpoint_every": 1, "run_name": model}
    ctx = Ctx(request=tt.JobRequest(job_id="j"), payload=payload, worker=ThreadWorker())
    res = await th.make_gpu_handlers(tc)(ctx)
    for _ in range(100):
        if len(progress) == 2:
            break
        await asyncio.sleep(0.01)
    assert res["model"] == model and res["completed"] and res["steps_done"] == 2
    assert res["mesh"]["ep"] == 1 and res["checkpointed"]
    assert [p for p, _ in progress] == [50, 100]
    assert sorted(p.name for p in (tmp_path / model).iterdir()) == ["1", "2"]


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_matmul_chain_matches_reference_formula(iters):
    """The reference's chain (``TPUCompute.matmul``'s jitted ``run``) on
    shared numpy inputs, fp32."""
    rng = np.random.default_rng(iters)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32) / 4
    y_back = rng.standard_normal((4, 16)).astype(np.float32) / 2

    @jax.jit
    def run(x, y, y_back):
        acc = jax.lax.fori_loop(0, iters, lambda i, acc: jnp.tanh((acc @ y) @ y_back), x)
        return acc @ y

    want = np.asarray(run(x, y, y_back))
    got = th.matmul_chain(*map(torch.from_numpy, (x, y, y_back)), iters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_matmul_op_draws_the_same_inputs_every_call(computes):
    _, tc = computes
    a = tc.matmul(2, 8, 8, 8, 1)
    b = tc.matmul(2, 8, 8, 8, 1)
    assert a == b and a["shape"] == [2, 8, 8]


def test_batched_results_equal_single_job(computes):
    _, tc = computes
    solo = tc.embedder.embed(TEXTS)
    batched = tc.embed_batch(TEXTS, seq_len=16)
    assert batched.shape == solo.shape
    np.testing.assert_allclose(batched, solo, atol=EMBED_ATOL)
    assert tc.infer_batch(ROWS, seq_len=16) == (tc.infer(ROWS)["next_tokens"], 16)


def test_worker_and_compute_without_a_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from cordum_tpu_torch.infra.bus import LoopbackBus
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.infra.memstore import MemoryStore

    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.Worker(bus=LoopbackBus(), store=MemoryStore(MemoryKV()), worker_id="w")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.GPUCompute()


def test_cpu_worker_heartbeat_reports_the_cpu():
    from cordum_tpu_torch.infra.bus import LoopbackBus
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.infra.memstore import MemoryStore

    w = trt.Worker(bus=LoopbackBus(), store=MemoryStore(MemoryKV()), worker_id="w",
                   device="cpu")
    hb = w.build_heartbeat()
    assert (hb.type, hb.device_kind, hb.chip_count) == ("cpu", "cpu", 1)
    assert hb.devices_healthy and hb.hbm_total_gb == 0.0


async def test_gang_labelled_job_takes_the_per_job_path():
    """A worker with no gang runner attached: a job carrying the
    scheduler's gang labels runs through the op table and publishes an
    ordinary result, as a reference worker without a gang runner does."""
    from cordum_tpu_torch.infra.bus import LoopbackBus
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.protocol import subjects as subj

    bus, store = LoopbackBus(), MemoryStore(MemoryKV())
    w = trt.Worker(bus=bus, store=store, worker_id="w", heartbeat_interval_s=999,
                   device="cpu")
    w.register_default(th.make_gpu_handlers(th.GPUCompute(
        device="cpu", embedder_cfg=te.EmbedderConfig(dtype=torch.float32, **EMBED_KW))))
    results = []

    async def tap(subject, pkt):
        results.append(pkt.job_result)

    await bus.subscribe(subj.RESULT, tap)
    await w.start()
    ptr = await store.put_context("gj", {"op": "echo"})
    await bus.publish(subj.direct_subject("w"), tt.BusPacket.wrap(tt.JobRequest(
        job_id="gj", topic="job.tpu.echo", context_ptr=ptr,
        labels={tt.LABEL_GANG_ID: "g1", tt.LABEL_GANG_WORKERS: "2"})))
    for _ in range(200):
        await bus.drain()
        if results:
            break
        await asyncio.sleep(0.01)
    await w.stop()
    assert [r.status for r in results] == ["SUCCEEDED"]
    assert (await store.get_result("gj"))["echo"] == {"op": "echo"}


# ---------------------------------------------------------------------------
# the wire types
# ---------------------------------------------------------------------------


def test_reference_packets_read_back_through_the_port():
    from cordum_tpu.protocol import types as jt

    pkts = [
        jt.BusPacket.wrap(jt.JobRequest(job_id="j1", topic="job.tpu.x", context_ptr="kv://c",
                                        labels={"a": "b"}, priority="INTERACTIVE"),
                          trace_id="t", sender_id="s", span_id="sp"),
        jt.BusPacket.wrap(jt.JobResult(job_id="j1", status="SUCCEEDED", result_ptr="kv://r")),
        jt.BusPacket.wrap(jt.Heartbeat(worker_id="w", device_kind="NVIDIA H100", chip_count=1)),
        jt.BusPacket.wrap(jt.JobProgress(job_id="j1", tokens=[1, 2], offset=3,
                                         status_hint=jt.STATUS_HINT_STREAM)),
        jt.BusPacket.wrap(jt.JobCancel(job_id="j1", reason="r")),
    ]
    for p in pkts:
        back = tt.BusPacket.from_dict(p.to_dict())
        assert back.to_dict() == p.to_dict()
        assert tt.BusPacket.from_wire(p.to_wire()).to_dict() == p.to_dict()
        assert jt.BusPacket.from_dict(back.to_dict()).to_dict() == p.to_dict()


# ---------------------------------------------------------------------------
# bridged end to end
# ---------------------------------------------------------------------------


class Bridge:
    """Forwards every packet between the reference bus and the port's bus
    through ``to_dict()``/``from_dict()``.  Each bus hands its subscribers
    fresh copies, so a packet the bridge published is recognised by its
    subject and content when it comes back, and is not forwarded again."""

    def __init__(self, ref_bus, port_bus):
        from cordum_tpu.protocol.types import BusPacket as RefPacket

        self.ref_bus, self.port_bus = ref_bus, port_bus
        self._ref_packet = RefPacket
        self._echoes: collections.Counter = collections.Counter()

    async def start(self):
        await self.ref_bus.subscribe(">", functools.partial(
            self._forward, self.ref_bus, self.port_bus, tt.BusPacket))
        await self.port_bus.subscribe(">", functools.partial(
            self._forward, self.port_bus, self.ref_bus, self._ref_packet))

    @staticmethod
    def _key(bus, subject, pkt):
        return id(bus), subject, json.dumps(pkt.to_dict(), sort_keys=True, default=repr)

    async def _forward(self, src, dst, packet_type, subject, pkt):
        key = self._key(src, subject, pkt)
        if self._echoes[key]:
            self._echoes[key] -= 1  # our own forward, delivered back to us
            return
        out = packet_type.from_dict(pkt.to_dict())
        self._echoes[self._key(dst, subject, out)] += 1
        await dst.publish(subject, out)


def _port_worker(store, jc):
    """A port worker wired by ``attach_default_gpu_worker`` on weights
    bridged from the reference compute."""
    from cordum_tpu_torch.infra.bus import LoopbackBus

    w = trt.Worker(bus=LoopbackBus(), store=store, worker_id="w-port", pool="tpu",
                   topics=["job.tpu.>"], capabilities=["tpu"], heartbeat_interval_s=999,
                   device="cpu")
    th.attach_default_gpu_worker(
        w, max_batch_wait_ms=10, serving_max_sessions=4, serving_max_new_tokens=128,
        embedder_cfg=te.EmbedderConfig(dtype=torch.float32, **EMBED_KW),
        llama_cfg=tl.LlamaConfig(dtype=torch.float32, **LLAMA_KW),
        llama_params=tl.params_from_jax(jax.tree.map(np.asarray, jc._llama_params), device="cpu"),
        embedder_params=te.params_from_jax(jax.tree.map(np.asarray, jc.embedder.params),
                                           device="cpu"),
    )
    return w


def _ref_worker(bus, store, jc):
    from cordum_tpu.worker.handlers import (
        make_micro_batcher, make_serving_engine, make_tpu_handlers,
    )
    from cordum_tpu.worker.runtime import Worker

    w = Worker(bus=bus, store=store, worker_id="w-ref", pool="tpu", topics=["job.tpu.>"],
               capabilities=["tpu"], heartbeat_interval_s=999)
    w.register_default(make_tpu_handlers(jc))
    w.attach_batcher(make_micro_batcher(jc, w, max_wait_ms=10))
    w.attach_serving(make_serving_engine(jc, w, max_sessions=4, max_new_tokens=128))
    return w


JOBS = {
    "echo": {"op": "echo", "x": 7},
    "embed": {"op": "embed", "texts": TEXTS},
    "infer": {"op": "infer", "tokens": ROWS},
    "gen0": {"op": "llm.generate", "tokens": [5, 9, 17, 3], "max_new_tokens": 8,
             "session_id": "conv-0"},
    "gen1": {"op": "llm.generate", "tokens": [5, 9, 2, 9, 2, 9, 2, 9], "max_new_tokens": 10},
}


async def _run_jobs(port: bool, jc):
    """Submit ``JOBS`` through the reference scheduler to one worker (the
    port's over the bridge, or the reference's); returns the terminal
    states, results and streamed tokens, and the worker."""
    from cordum_tpu.protocol import subjects as subj
    from cordum_tpu.protocol.types import BusPacket, JobRequest, STATUS_HINT_STREAM

    from .test_batching import make_stack

    kv, bus, js, ms, eng = make_stack()
    await eng.start()
    if port:
        from cordum_tpu_torch.infra.memstore import MemoryStore

        w = _port_worker(MemoryStore(kv), jc)  # one KV under both stores
        bridge = Bridge(bus, w.bus)
        await bridge.start()
    else:
        w = _ref_worker(bus, ms, jc)
    streams: dict[str, list[int]] = {}

    async def ptap(subject, pkt):
        pr = pkt.job_progress
        if pr is not None and pr.status_hint == STATUS_HINT_STREAM:
            streams.setdefault(pr.job_id, []).extend(pr.tokens)

    await bus.subscribe(subj.PROGRESS, ptap)
    await w.start()
    await settle(bus)
    for jid, payload in JOBS.items():
        ptr = await ms.put_context(jid, payload)
        await bus.publish(subj.SUBMIT, BusPacket.wrap(
            JobRequest(job_id=jid, topic=f"job.tpu.{payload['op']}", context_ptr=ptr)))
    for _ in range(1500):
        await settle(bus, rounds=2)
        states = {j: await js.get_state(j) for j in JOBS}
        if all(s == "SUCCEEDED" for s in states.values()):
            break
    results = {j: await ms.get_result(j) for j in JOBS}
    return states, results, streams, w, (bus, js, ms, eng)


async def settle(bus, rounds=6):
    for _ in range(rounds):
        await bus.drain()
        await asyncio.sleep(0.02)


async def test_bridged_reference_scheduler_dispatches_to_port_worker(computes):
    jc, _ = computes
    states, got, streams, w, (bus, js, ms, eng) = await _run_jobs(True, jc)
    try:
        assert all(s == "SUCCEEDED" for s in states.values()), states
        assert got["echo"]["worker"] == "w-port"
        for jid in ("gen0", "gen1"):
            # the stream and the terminal result agree token for token
            assert streams[jid] == got[jid]["tokens"]
            assert len(got[jid]["tokens"]) == JOBS[jid]["max_new_tokens"]
        assert got["gen0"]["session_key"] == "conv-0"
        # retired sessions hold no pages beyond the prefix cache's
        w.serving.allocator.check_consistency()
        assert w.serving.allocator.used_pages == w.serving.prefix.warm_pages
    finally:
        await w.stop()
        await eng.stop()
    ref_states, want, _, rw, (_, _, _, reng) = await _run_jobs(False, jc)
    await rw.stop()
    await reng.stop()
    assert all(s == "SUCCEEDED" for s in ref_states.values()), ref_states
    assert got["echo"]["echo"] == want["echo"]["echo"]
    assert got["infer"] == want["infer"]
    for jid in ("gen0", "gen1"):
        assert got[jid] == want[jid]  # fp32: token-identical
    assert got["embed"]["dim"] == want["embed"]["dim"]
    np.testing.assert_allclose(got["embed"]["embeddings"], want["embed"]["embeddings"],
                               atol=EMBED_ATOL)


async def test_bridged_cancel_of_inflight_generate_frees_pages(computes):
    from cordum_tpu.protocol import subjects as subj
    from cordum_tpu.protocol.types import BusPacket, JobCancel, JobRequest

    from .test_batching import make_stack
    from cordum_tpu_torch.infra.memstore import MemoryStore

    jc, _ = computes
    kv, bus, js, ms, eng = make_stack()
    await eng.start()
    w = _port_worker(MemoryStore(kv), jc)
    bridge = Bridge(bus, w.bus)
    await bridge.start()
    await w.start()
    await settle(bus)
    ptr = await ms.put_context("gc", {"op": "llm.generate", "tokens": [1, 2, 3],
                                      "max_new_tokens": 120})
    await bus.publish(subj.SUBMIT, BusPacket.wrap(
        JobRequest(job_id="gc", topic="job.tpu.generate", context_ptr=ptr)))
    try:
        for _ in range(2000):
            await asyncio.sleep(0.005)
            if w.serving.active_sessions() == 1:
                break
        assert w.serving.active_sessions() == 1, "session never started decoding"
        assert w.serving.allocator.used_pages > 0
        await bus.publish(subj.CANCEL, BusPacket.wrap(JobCancel(job_id="gc", reason="test")))
        for _ in range(1500):
            await asyncio.sleep(0.02)
            if await js.get_state("gc") == "CANCELLED":
                break
        assert await js.get_state("gc") == "CANCELLED"
        for _ in range(500):
            await asyncio.sleep(0.01)
            if w.serving.allocator.used_pages == 0:
                break
        assert w.serving.allocator.used_pages == 0
        assert w.serving.active_sessions() == 0
    finally:
        await w.stop()
        await eng.stop()


async def test_bus_embedder_through_the_bridge(computes):
    """The context engine's ``BusEmbedder`` embeds on the port worker."""
    from cordum_tpu.context.service import BusEmbedder

    from .test_batching import make_stack
    from cordum_tpu_torch.infra.memstore import MemoryStore

    jc, tc = computes
    kv, bus, js, ms, eng = make_stack()
    await eng.start()
    w = _port_worker(MemoryStore(kv), jc)
    bridge = Bridge(bus, w.bus)
    await bridge.start()
    await w.start()
    await settle(bus)
    emb = BusEmbedder(bus, ms, texts_per_job=2, timeout_s=30)
    try:
        texts = TEXTS + ["context engine recall", "one more"]
        got = await emb.aembed(texts)
        assert got.shape == (len(texts), EMBED_KW["d_model"])
        np.testing.assert_allclose(got, tc.embedder.embed(texts), atol=EMBED_ATOL)
        assert emb.jobs_total == 3
    finally:
        await emb.stop()
        await w.stop()
        await eng.stop()
