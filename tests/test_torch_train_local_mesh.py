"""A worker's local mesh on the CPU (``cordum_tpu/worker/training.py``
``TrainRunner._build`` and ``cordum_tpu/worker/handlers.py`` ``TPUCompute``
resolve onto every local device; the port's ``TrainRunner`` and
``GPUCompute`` over a worker's cards).  ``chip_smoke.py``'s phase 15 and
its dryrun leg are rehearsed in ``tests/test_torch_dryrun_smoke.py``.

The CPU "cards" are gloo CPU rank processes (``TrainRunner(ranks=4)``)
and, for the embedder, the CPU named four times.  Tolerances:

* a ``train`` job over 4 ranks against the same job in one process, fp32,
  fixed batch: each loss within 1e-5 relative (tp, sp, ep and pp split the
  sums at other places; the CPU reads at most 2.5e-7);
* a checkpoint's resume across world sizes: the same bound against an
  uninterrupted one-process run;
* the embedder over four CPU "cards" at ``WORKER_TP`` 2: equal to one
  device, bit for bit (each row's embedding is computed as one device
  computes it; on the card a 12-row block may take another GEMM than a
  24-row batch, so ``chip_smoke`` holds that comparison to 1e-6).
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from cordum_tpu_torch import device as tdevice
from cordum_tpu_torch.infra.bus import LoopbackBus
from cordum_tpu_torch.infra.kv import MemoryKV
from cordum_tpu_torch.infra.memstore import MemoryStore
from cordum_tpu_torch.models import embedder as te
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.protocol import subjects as subj
from cordum_tpu_torch.protocol.types import BusPacket, JobCancel, JobRequest
from cordum_tpu_torch.worker import training
from cordum_tpu_torch.worker.handlers import GPUCompute, attach_default_gpu_worker
from cordum_tpu_torch.worker.runtime import Worker
from cordum_tpu_torch.worker.training import CheckpointDir, TrainRunner

CPU = torch.device("cpu")
REL = 1e-5
#: each family at 4 ranks: the mesh asked, and what it resolves to
FAMILIES = {
    "llama-tiny": ({"tp": 2, "sp": 2}, {"dp": 1, "tp": 2, "sp": 2, "ep": 1, "pp": 1}),
    "moe-tiny": ({"tp": 2, "ep": 2}, {"dp": 1, "tp": 2, "sp": 1, "ep": 2, "pp": 1}),
    "pipeline": ({}, {"dp": 2, "tp": 1, "sp": 1, "ep": 1, "pp": 2}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here on one torch thread: its ranks (threads or processes)
    and the other test workers share the host's cores, and tiny steps gain
    nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _payload(model, steps, **kw):
    return {"op": "train", "model": model, "steps": steps, "batch": 4, "seq": 16,
            "fixed_batch": True, "dtype": "float32", "mesh": FAMILIES[model][0],
            "run_name": "run", **kw}


def _close(got, want):
    return abs(got - want) / abs(want) <= REL


@pytest.mark.parametrize("model", list(FAMILIES))
def test_four_ranks_match_one_process_and_checkpoints_resume_across_world_sizes(tmp_path,
                                                                              model):
    """One process writes step 2; 4 ranks resume there, match one process's
    steps 3 and 4 and write step 4 (the whole tree, gathered); one process
    resumes there and matches steps 5 and 6."""
    one = [TrainRunner(ckpt_root=str(tmp_path / f"ref{k}"), device=CPU).train(
        _payload(model, k))["final_loss"] for k in range(1, 7)]
    root = str(tmp_path / "ckpt")
    first = TrainRunner(ckpt_root=root, device=CPU).train(
        _payload(model, 2, checkpoint_every=2))
    assert first["steps_done"] == 2 and first["mesh"]["dp"] * first["mesh"]["pp"] == 1
    four = TrainRunner(ckpt_root=root, device=CPU, ranks=4).train(
        _payload(model, 4, checkpoint_every=2))
    assert four["mesh"] == FAMILIES[model][1]
    assert four["resumed_from"] == 2 and four["steps_done"] == 4 and four["completed"]
    assert _close(four["loss_first"], one[2]) and _close(four["final_loss"], one[3])
    assert CheckpointDir(f"{root}/run").steps() == [2, 4]
    _assert_one_card_tree(CheckpointDir(f"{root}/run").restore(4, CPU), model)
    last = TrainRunner(ckpt_root=root, device=CPU).train(_payload(model, 6, checkpoint_every=2))
    assert last["resumed_from"] == 4 and last["steps_done"] == 6
    assert _close(last["loss_first"], one[4]) and _close(last["final_loss"], one[5])


def _assert_one_card_tree(state, model):
    """Step 4, written by the ranks, holds the whole tree in the one-card
    layout, the moments too: every layer's whole leaves (the pipeline's
    stacked as one stage of every layer), ``lm_head`` whole."""
    base = tl.LlamaConfig.tiny()
    d, f = base.d_model, base.d_ff
    for tree in (state["params"], state["opt_state"]["mu"], state["opt_state"]["nu"]):
        assert tree["lm_head"].shape == (d, base.vocab_size)
        assert tree["embed"].dtype == torch.float32
        if model == "pipeline":
            assert tree["stages"]["wq"].shape == (1, base.n_layers, d, d)
            assert tree["stages"]["w_down"].shape == (1, base.n_layers, f, d)
        elif model == "moe-tiny":
            layer = tree["layers"][0]
            assert layer["wq"].shape == (d, d) and layer["moe"]["w_gate"].shape == (4, d, f)
            assert layer["moe"]["w_down"].shape == (4, f, d)
        else:
            assert tree["layers"][0]["wk"].shape == (d, d // 2)
            assert tree["layers"][0]["w_down"].shape == (f, d)
    assert int(state["opt_state"]["count"]) == 4


async def _run_train_job(worker_id, payload, *, chips, cancel_at):
    """A ``train`` job through a port worker owning ``chips`` CPU "cards";
    the job is cancelled once step ``cancel_at`` reports."""
    bus, store = LoopbackBus(), MemoryStore(MemoryKV())
    w = Worker(bus=bus, store=store, worker_id=worker_id, device=CPU, chips=chips)
    attach_default_gpu_worker(w, batching=False, serving=False, gang=False,
                              ckpt_root=payload.pop("ckpt_root"))
    done, progress = asyncio.get_running_loop().create_future(), []

    async def on_result(subject, pkt):
        if pkt.job_result is not None and not done.done() \
                and pkt.job_result.status != "RUNNING":
            done.set_result(pkt.job_result)

    async def on_progress(subject, pkt):
        pr = pkt.job_progress
        if pr is not None:
            progress.append(pr.message)
            if pr.message.startswith(f"step {cancel_at}/"):
                await bus.publish(subj.CANCEL, BusPacket.wrap(JobCancel(job_id="job-1")))

    await bus.subscribe(subj.RESULT, on_result)
    await bus.subscribe(subj.PROGRESS, on_progress)
    await w.start()
    try:
        ptr = await store.put_context("job-1", payload)
        await bus.publish(subj.direct_subject(worker_id), BusPacket.wrap(JobRequest(
            job_id="job-1", topic="job.gpu.train", context_ptr=ptr)))
        result = await asyncio.wait_for(done, 120)
        return result, await store.get_result("job-1"), progress, w.build_heartbeat()
    finally:
        await w.stop()


def test_a_train_job_on_a_two_card_worker_reports_its_mesh_and_cancels_at_one_step(
        tmp_path):
    """The ``train`` op on a worker that owns 2 CPU "cards": the ranks run
    it over the family's mesh (tp 2), rank 0's progress reaches the bus,
    and a cancel sent when step 2 reports stops every rank at one step (the
    runner checks that every rank ended alike); the job succeeds with
    ``completed: false`` and the resolved mesh, as the reference's."""
    payload = {**_payload("llama-tiny", 10_000), "mesh": {"tp": 2},
               "ckpt_root": str(tmp_path)}
    result, doc, progress, hb = asyncio.run(_run_train_job("w-mesh", payload, chips=2,
                                                           cancel_at=2))
    assert result.status == "SUCCEEDED", result
    assert doc["mesh"] == {"dp": 1, "tp": 2, "sp": 1, "ep": 1, "pp": 1}
    assert not doc["completed"] and 2 <= doc["steps_done"] < 10_000
    assert [m.split(" loss=")[0] for m in progress] == [
        f"step {i}/10000" for i in range(1, doc["steps_done"] + 1)]
    assert hb.chip_count == 2 and hb.device_kind == "cpu"


@pytest.mark.parametrize("tp, replicas", [(1, 4), (2, 2), (4, 1), (3, 4)])
def test_the_embedder_over_four_cpu_cards_equals_one_device(tp, replicas):
    """``GPUCompute`` over 4 CPU "cards" at ``WORKER_TP`` ``tp`` (3 does
    not divide 4: tp 1, as the reference's): ``cards / tp`` replicas, the
    batch padded to a multiple of 4 and split over them; the embeddings
    of one device, bit for bit, through the job path and the
    micro-batcher's."""
    cfg = dataclasses.replace(te.EmbedderConfig(), dtype=torch.float32, n_layers=2)
    one = GPUCompute(device=CPU, embedder_cfg=cfg, seed=3)
    mesh = GPUCompute(device=CPU, embedder_cfg=cfg, seed=3, tp=tp, chips=4)
    assert mesh.tp == (1 if tp == 3 else tp) and len(mesh.embedder.replicas) == replicas
    texts = chip_smoke.make_texts(np.random.default_rng(5), 11, 1, 30)
    want = one.embedder.embed(texts)
    assert want.shape == (11, cfg.d_model)
    assert np.array_equal(mesh.embedder.embed(texts), want)
    assert np.array_equal(mesh.embed_batch(texts, seq_len=64), one.embed_batch(texts, seq_len=64))


def test_the_heartbeat_reports_the_cards_the_worker_owns(monkeypatch):
    def hb(**kw):
        return Worker(bus=LoopbackBus(), store=MemoryStore(MemoryKV()), worker_id="w",
                      device=CPU, **kw).build_heartbeat()

    assert hb().chip_count == 1
    assert hb(chips=4).chip_count == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.local_world(torch.device("cuda", 0)) == 4
    assert tdevice.local_world(torch.device("cuda", 0), 2) == 2
    with pytest.raises(ValueError, match="8 cards asked, this host has 4"):
        tdevice.local_world(torch.device("cuda", 0), 8)
    with pytest.raises(ValueError, match="at least one card"):
        tdevice.local_world(CPU, 0)
    assert tdevice.local_devices(torch.device("cuda", 0), 2) == [torch.device("cuda", 0),
                                                                 torch.device("cuda", 1)]


def test_a_runner_asked_for_more_cards_than_the_host_has_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 cards asked, this host has 2"):
        TrainRunner(device=torch.device("cuda", 0), ranks=4)


def test_the_mesh_resolves_as_the_reference_over_the_world():
    """The reference's ``_build`` over n devices: asked sizes kept where
    they divide n (``safe``), dp the rest, the pipeline's pp 2 on an even
    n unless asked."""
    def mesh(world, payload):
        runner = TrainRunner(device=CPU, ranks=world)
        _, _, spec = runner._family(payload)
        return spec.resolve(world)

    assert mesh(4, {"model": "llama", "mesh": {"tp": 2}})["dp"] == 2
    assert mesh(4, {"model": "llama", "mesh": {"tp": 3}})["tp"] == 1
    assert mesh(8, {"model": "moe", "mesh": {"ep": 4}})["ep"] == 4
    assert mesh(4, {"model": "pipeline"})["pp"] == 2
    assert mesh(3, {"model": "pipeline"})["pp"] == 1
    assert mesh(4, {"model": "pipeline", "mesh": {"pp": 4}})["pp"] == 4
    assert mesh(1, {"model": "pipeline", "mesh": {"pp": 2}})["pp"] == 1


def test_an_unknown_dtype_is_refused():
    with pytest.raises(ValueError, match="unknown dtype 'float16'"):
        training.model_config("llama-tiny", dtype="float16")
    assert training.model_config("moe", dtype="float32").base.dtype == torch.float32
