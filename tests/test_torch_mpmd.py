"""MPMD pipeline gangs (``cordum_tpu_torch/worker/gang.py``: the stage math,
the tag-addressed mailbox, ``_run_mpmd``) and serving gangs whose store is
advertised on a routable address (``WORKER_GANG_ADDR``), on the CPU.

The stage chain is held, through the float32 wire encoding, to the JAX
package's monolithic model and to its own stage programs
(``cordum_tpu/worker/gang.py`` ``_mpmd_build``, ``_mpmd_forward``,
``_mpmd_backward``, as ``tests/test_gang.py`` holds them) on the weights the
reference draws, carried across by ``pipeline.params_from_jax``.  Gang jobs
run on the port's workers under the reference's gang scheduler
(``tests/test_torch_gang.py`` ``port_stack``).  Tolerances, fp32: losses
within 1e-5 relative; activations, cotangents and gradients within 1e-5 of
their largest ``|value|`` (the frameworks sum in other orders).
"""
from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.models import pipeline as jp
from cordum_tpu.protocol import subjects as rsubj
from cordum_tpu_torch import optim
from cordum_tpu_torch.infra.bus import LoopbackBus
from cordum_tpu_torch.infra.kv import MemoryKV
from cordum_tpu_torch.infra.memstore import MemoryStore
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import pipeline as tp
from cordum_tpu_torch.parallel.mesh import STORE_HOST, open_store
from cordum_tpu_torch.protocol.types import GangMsg
from cordum_tpu_torch.worker import gang as tg
from cordum_tpu_torch.worker.runtime import Worker

from .test_gang import make_stack, submit_gang, teardown, wait_state
from .test_torch_gang import REPO, close_stack, port_stack

CPU = "cpu"
REL = 1e-5
#: the per-rank keys of the reference's ``_run_mpmd`` result
MPMD_KEYS = {"mode", "rank", "steps_done", "mesh", "microbatches", "loss", "loss_first"}
#: lr 0.5: a step large enough that the second loss tells the gang's SGD
#: (the microbatches' summed gradients times lr / M) from a wrong scale
PAYLOAD = {"op": "train", "model": "pipeline", "steps": 2, "batch": 4, "seq": 12,
           "microbatches": 2, "mesh": {"dp": -1, "pp": 2}, "gang": {"workers": 2}, "seed": 5,
           "lr": 0.5}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _wire(arr):
    """Through the wire and back: raw little-endian float32 bytes."""
    arr = np.asarray(arr, np.float32)
    return tg.from_wire(arr.astype("<f4").tobytes(), list(arr.shape))


def _chain(states, tokens):
    """The port's stage programs, rank 0 to the last and back, each tensor
    crossing the wire: ``(loss, per-rank grads, activations, cotangents)``."""
    size = len(states)
    acts, graphs, cots = [], [], [None] * size
    x = None
    for r in range(size - 1):
        y, graph = tg.mpmd_forward(states[r], tokens, x)
        acts.append(y)
        graphs.append(graph)
        x = _wire(y)
    loss, g_last, g_x = tg.mpmd_forward(states[-1], tokens, x)
    grads = [None] * size
    grads[-1] = g_last
    for r in range(size - 2, -1, -1):
        cots[r + 1] = g_x
        grads[r], g_x = tg.mpmd_backward(graphs[r], _wire(g_x))
    assert g_x is None  # rank 0's forward took no input
    return loss, grads, acts, cots


def _named(state, grads):
    """Per-rank gradients by name: ``stage/<leaf>`` and the whole leaves."""
    names = []
    for key in sorted(state["params"]):
        sub = state["params"][key]
        names += [f"stage/{k}" for k in sorted(sub)] if isinstance(sub, dict) else [key]
    return dict(zip(names, grads))


def _jax_monolithic(full, tokens, base):
    """The JAX model in one piece: every stage in order, mean next-token
    loss (``tests/test_gang.py``'s reference), with its gradients."""
    tok = jnp.asarray(tokens)
    mb, t = tok.shape
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (mb, t))
    n_stages = full["stages"]["wq"].shape[0]

    def loss_fn(p):
        x = p["embed"][tok].astype(jnp.float32)
        for s in range(n_stages):
            x = jp._stage_apply(jax.tree.map(lambda a: a[s], p["stages"]), x, pos, base)
        h = jl.rms_norm(x, p["final_norm"], base.norm_eps)
        logp = jax.nn.log_softmax((h @ p["lm_head"]).astype(jnp.float32)[:, :-1], axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, tok[:, 1:][..., None], axis=-1)[..., 0])

    return jax.jit(jax.value_and_grad(loss_fn))(full)


@pytest.fixture(scope="module")
def two_stage():
    """The reference's two stage programs on its seed-0 weights, one
    microbatch through them, the JAX monolithic loss and gradients, and the
    port's states on the same weights."""
    from cordum_tpu.worker.gang import _mpmd_backward, _mpmd_build, _mpmd_forward

    s0, s1 = _mpmd_build({"seed": 0}, 0, 2), _mpmd_build({"seed": 0}, 1, 2)
    base = s0["base"]
    tokens = np.random.default_rng(7).integers(0, base.vocab_size, (2, 12)).astype(np.int32)
    y0, vjp0 = _mpmd_forward(s0, tokens, None)
    loss, g1, gx = _mpmd_forward(s1, tokens, _wire(y0))
    g0, _ = _mpmd_backward(vjp0, _wire(gx))
    full = jp.init_params(jax.random.PRNGKey(0),
                          jp.PipelineConfig(base=base, n_stages=2, n_microbatches=1))
    ref, gref = _jax_monolithic(full, tokens, base)
    tfull = tp.params_from_jax(jax.tree.map(np.asarray, full), device=CPU)
    states = [tg.mpmd_state(tfull, r, 2, tg.mpmd_base(), CPU) for r in range(2)]
    return {"tokens": tokens, "states": states, "ref_stage": (y0, loss, gx, g0, g1),
            "monolithic": (float(ref), gref)}


def test_stage_chain_matches_the_monolithic_jax_model(two_stage):
    loss, grads, _, _ = _chain(two_stage["states"], torch.from_numpy(two_stage["tokens"]))
    ref, gref = two_stage["monolithic"]
    assert abs(loss - ref) / ref <= REL
    g0 = _named(two_stage["states"][0], grads[0])
    g1 = _named(two_stage["states"][1], grads[1])
    assert set(g0) == {"embed"} | {f"stage/{k}" for k in tp.STAGE_LEAVES}
    assert set(g1) == {"final_norm", "lm_head"} | {f"stage/{k}" for k in tp.STAGE_LEAVES}
    assert _rel(g0["embed"].numpy(), gref["embed"]) <= REL
    for name in ("final_norm", "lm_head"):
        assert _rel(g1[name].numpy(), gref[name]) <= REL, name
    for rank, g in ((0, g0), (1, g1)):
        for k in tp.STAGE_LEAVES:
            assert _rel(g[f"stage/{k}"].numpy(), gref["stages"][k][rank]) <= REL, (rank, k)


def test_stage_chain_matches_the_reference_stage_programs(two_stage):
    """Activation, loss, cotangent and each rank's gradients against the
    reference's own ``_mpmd_forward`` / ``_mpmd_backward`` on the same
    weights and tokens."""
    y0, ref_loss, ref_gx, ref_g0, ref_g1 = two_stage["ref_stage"]
    loss, grads, acts, cots = _chain(two_stage["states"], torch.from_numpy(two_stage["tokens"]))
    assert acts[0].dtype == np.dtype("<f4") and acts[0].shape == y0.shape
    assert _rel(acts[0], y0) <= REL
    assert abs(loss - ref_loss) / ref_loss <= REL
    assert cots[1].dtype == np.dtype("<f4") and _rel(cots[1], ref_gx) <= REL
    for rank, ref_g in ((0, ref_g0), (1, ref_g1)):
        want = optim.tree_leaves(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_g))
        assert len(want) == len(grads[rank])
        for g, w in zip(grads[rank], want):
            assert g.shape == w.shape and _rel(g.numpy(), w.numpy()) <= REL


def test_four_stage_chain_with_middle_ranks_matches_the_jax_model():
    """Middle ranks take grads for their params and their input: four
    stages of one layer each, against the JAX model in one piece."""
    shape = {"vocab_size": 128, "d_model": 32, "n_layers": 4, "n_heads": 2, "n_kv_heads": 2,
             "d_ff": 64}
    jbase = jl.LlamaConfig(dtype=jnp.float32, **shape)
    full = jp.init_params(jax.random.PRNGKey(3),
                          jp.PipelineConfig(base=jbase, n_stages=4, n_microbatches=1))
    tokens = np.random.default_rng(4).integers(0, 128, (2, 10)).astype(np.int32)
    ref, gref = _jax_monolithic(full, tokens, jbase)
    tbase = tl.LlamaConfig(dtype=torch.float32, **shape)
    tfull = tp.params_from_jax(jax.tree.map(np.asarray, full), device=CPU)
    states = [tg.mpmd_state(tfull, r, 4, tbase, CPU) for r in range(4)]
    loss, grads, _, cots = _chain(states, torch.from_numpy(tokens))
    assert abs(loss - float(ref)) / float(ref) <= REL
    assert all(c.dtype == np.dtype("<f4") for c in cots[1:])
    for rank in range(4):
        named = _named(states[rank], grads[rank])
        for k in tp.STAGE_LEAVES:
            assert _rel(named[f"stage/{k}"].numpy(), gref["stages"][k][rank]) <= REL, (rank, k)
    assert _rel(_named(states[0], grads[0])["embed"].numpy(), gref["embed"]) <= REL


def test_every_rank_draws_the_same_weights_and_tokens():
    """The draws come from CPU generators, whatever the rank's device: the
    same full params and the same batch on every rank; a rank keeps only
    its stage (the embedding on rank 0, the head on the last)."""
    a, b = tg.mpmd_draw({"seed": 9}, 2), tg.mpmd_draw({"seed": 9}, 2)
    assert all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)))
    assert torch.equal(tg.mpmd_tokens(3, 4, 8, 256), tg.mpmd_tokens(3, 4, 8, 256))
    assert not torch.equal(tg.mpmd_tokens(3, 4, 8, 256), tg.mpmd_tokens(4, 4, 8, 256))
    s0 = tg.mpmd_state(a, 0, 2, tg.mpmd_base(), CPU)
    s1 = tg.mpmd_state(a, 1, 2, tg.mpmd_base(), CPU)
    assert set(s0["params"]) == {"stage", "embed"}
    assert set(s1["params"]) == {"stage", "final_norm", "lm_head"}
    assert torch.equal(s1["params"]["stage"]["wq"], a["stages"]["wq"][1])
    assert all(p.is_leaf and p.requires_grad for p in optim.tree_leaves(s0["params"]))
    with pytest.raises(ValueError, match="divisible by pp=3"):
        tg.mpmd_draw({}, 3)


# ---------------------------------------------------------------------------
# the mailbox
# ---------------------------------------------------------------------------


def _stage(tag, to_rank, arr):
    return GangMsg(gang_id="g", job_id="j", kind="stage", rank=0, to_rank=to_rank, tag=tag,
                   data=np.asarray(arr, "<f4").tobytes(), shape=list(np.shape(arr)))


async def test_a_stage_message_is_kept_until_its_recv():
    """A message that arrives before its ``recv`` is delivered; one
    addressed to another rank is not this rank's."""
    session = tg._GangSession("g", "j", 1, 2)
    session.on_msg(_stage("fwd:0:0:1", 1, [[1.0, 2.0]]))
    session.on_msg(_stage("fwd:0:1:0", 0, [3.0]))
    data, shape = await session.recv("fwd:0:0:1", 1.0)
    assert shape == [1, 2] and tg.from_wire(data, shape).tolist() == [[1.0, 2.0]]
    with pytest.raises(tg.GangAborted, match="peer_timeout:fwd:0:1:0"):
        await session.recv("fwd:0:1:0", 0.05)


async def test_a_peer_abort_fails_a_pending_recv_at_once():
    session = tg._GangSession("g", "j", 0, 2)
    waiter = asyncio.ensure_future(session.recv("bwd:0:0:0", 30.0))
    await asyncio.sleep(0.02)
    t0 = time.monotonic()
    session.on_msg(GangMsg(gang_id="g", kind="abort", rank=1, reason="member_failed:X"))
    with pytest.raises(tg.GangAborted, match="member_failed:X"):
        await waiter
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(tg.GangAborted, match="member_failed:X"):
        await session.recv("bwd:0:1:0", 30.0)  # the latch stays set


async def test_a_silent_peer_times_out_naming_the_tag():
    session = tg._GangSession("g", "j", 1, 2)
    t0 = time.monotonic()
    with pytest.raises(tg.GangAborted) as err:
        await session.recv("fwd:3:1:1", 0.2)
    assert str(err.value) == "peer_timeout:fwd:3:1:1"
    assert 0.15 < time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# MPMD gang jobs on port workers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_mpmd_keys():
    """The per-rank keys of the reference's MPMD gang (its own workers)."""

    async def run():
        stack = await make_stack(2, trainer=True, rendezvous_timeout_s=10.0, peer_timeout_s=30.0)
        try:
            await submit_gang(stack, "g-ref", {**PAYLOAD, "steps": 1}, workers=2)
            assert await wait_state(stack.js, "g-ref", timeout_s=120.0) == "SUCCEEDED"
            res = await stack.store.get_result("g-ref")
        finally:
            await teardown(stack)
        return {r: set(doc) for r, doc in res["per_rank"].items()}

    return asyncio.run(run())


def _one_process_losses(payload):
    """Rank 1's two losses computed in one process: the pipeline loss of
    the seed's weights on step 0's batch, then one SGD step of the
    payload's ``lr`` on its gradient (the gang's sum over microbatches of
    ``lr / M``) and the loss on step 1's batch."""
    cfg = tp.PipelineConfig(base=tg.mpmd_base(), n_stages=2,
                            n_microbatches=payload["microbatches"])
    params = tg.mpmd_draw(payload, 2)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = tp.make_loss_fn(cfg)
    losses = []
    for step in range(2):
        toks = tg.mpmd_tokens(step, payload["batch"], payload["seq"], cfg.base.vocab_size)
        loss = loss_fn(params, tp.microbatch(toks, cfg.n_microbatches))
        losses.append(loss.item())
        with torch.no_grad():
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                p.sub_(payload["lr"] * g)
    return losses


def test_chip_smoke_mpmd_oracle_matches_the_one_process_run():
    """11.4's oracle of rank 1's two losses equals the one-process run
    above on the same payload (1e-6 relative), and its payload steps at
    lr 0.5, so that a wrong cotangent or SGD scale moves the second loss."""
    import chip_smoke

    assert chip_smoke.MPMD_PAYLOAD["lr"] == PAYLOAD["lr"]
    got = chip_smoke.mpmd_one_process_losses(torch, torch.device(CPU), PAYLOAD)
    want = _one_process_losses(PAYLOAD)
    assert got[1] < got[0]
    for g, w in zip(got, want):
        assert abs(g - w) / w <= 1e-6


async def test_mpmd_gang_on_two_port_workers_matches_one_process(tmp_path, reference_mpmd_keys):
    """pp 2 over two port workers: each rank's result has the reference's
    keys, rank 0 sees no loss, and rank 1's first and last losses equal the
    pipeline run in one process on the weights and tokens the seed draws."""
    stack = await port_stack(2, tmp_path=tmp_path, rendezvous_timeout_s=10.0)
    stages = []

    async def tap(subject, pkt):
        m = pkt.gang_msg
        if m is not None and m.kind == "stage":
            stages.append((m.tag, m.to_rank, len(m.data), tuple(m.shape)))

    await stack.bus.subscribe(rsubj.GANG_WILDCARD, tap)
    try:
        await submit_gang(stack, "g-mpmd", PAYLOAD, workers=2)
        assert await wait_state(stack.js, "g-mpmd", timeout_s=120.0) == "SUCCEEDED"
        res = await stack.store.get_result("g-mpmd")
    finally:
        await close_stack(stack)
    assert res["mode"] == "mpmd" and res["steps_done"] == 2 and res["mesh"]["pp"] == 2
    per_rank = res["per_rank"]
    assert {r: set(doc) for r, doc in per_rank.items()} == reference_mpmd_keys
    assert reference_mpmd_keys["0"] == MPMD_KEYS
    assert per_rank["0"]["loss"] is None and per_rank["0"]["loss_first"] is None
    assert per_rank["1"]["microbatches"] == 2 and per_rank["1"]["mesh"] == {"pp": 2, "dp": 1}
    first, last = _one_process_losses(PAYLOAD)
    assert abs(per_rank["1"]["loss_first"] - first) / first <= REL
    assert abs(per_rank["1"]["loss"] - last) / last <= REL
    # 2 steps x 2 microbatches, an activation forward and a cotangent back
    # each, as [mb 2, T 12, D 64] float32
    assert sorted(t for t, *_ in stages) == sorted(
        f"{d}:{s}:{m}:{r}" for s in range(2) for m in range(2)
        for d, r in (("fwd", 1), ("bwd", 0)))
    assert {(n, shape) for _, _, n, shape in stages} == {(2 * 12 * 64 * 4, (2, 12, 64))}


async def test_a_pipeline_gang_of_another_size_runs_spmd(tmp_path):
    """``mesh.pp`` unequal to the gang's size: every member trains the
    one-card pipeline through its ``TrainRunner``."""
    stack = await port_stack(2, tmp_path=tmp_path, rendezvous_timeout_s=10.0)
    try:
        await submit_gang(stack, "g-pspmd", {**PAYLOAD, "mesh": {"pp": 4}}, workers=2)
        assert await wait_state(stack.js, "g-pspmd", timeout_s=60.0) == "SUCCEEDED"
        res = await stack.store.get_result("g-pspmd")
    finally:
        await close_stack(stack)
    r0, r1 = res["per_rank"]["0"], res["per_rank"]["1"]
    assert res["mode"] == r0["mode"] == "spmd" and r0["model"] == "pipeline"
    assert r0["final_loss"] == r1["final_loss"] and r0["mesh"]["pp"] == 1


# ---------------------------------------------------------------------------
# C4: a serving gang's store on a routable address
# ---------------------------------------------------------------------------


def test_default_store_address_is_unchanged():
    store, addr = open_store(2, timeout_s=5.0)
    try:
        assert addr == f"{STORE_HOST}:{store.port}" and STORE_HOST == "127.0.0.1"
    finally:
        del store


def test_a_peer_process_joins_a_store_through_its_advertised_address():
    """The store listens on every interface and advertises ``127.0.0.2``,
    a loopback alias that needs no network: a peer process dials that
    address and writes a key rank 0 reads."""
    store, addr = open_store(2, timeout_s=30.0, advertise_host="127.0.0.2")
    assert addr == f"127.0.0.2:{store.port}"
    code = ("import sys; from cordum_tpu_torch.parallel.mesh import connect_store; "
            "connect_store(sys.argv[1], 2, timeout_s=30.0).set('peer', 'joined ' + sys.argv[1])")
    proc = subprocess.run([sys.executable, "-c", code, addr], cwd=REPO, timeout=60,
                          env={**os.environ, "PYTHONPATH": str(REPO)},
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert store.get("peer") == f"joined {addr}".encode()


@pytest.mark.parametrize("configured, advertised", [("", "127.0.0.1"),
                                                    ("127.0.0.2", "127.0.0.2")],
                         ids=["unset", "alias"])
async def test_ready_beacon_carries_the_configured_store_address(configured, advertised):
    """Rank 0 of a serving gang beacons ``<address>:<port>`` and the
    follower joins the rank group through it; unset, ``127.0.0.1``."""
    stack = await port_stack(2)
    for w in stack.workers:
        w.gang.store_host = configured
    stores = []

    async def tap(subject, pkt):
        m = pkt.gang_msg
        if m is not None and m.kind == "ready" and (m.stats or {}).get("store"):
            stores.append(m.stats["store"])

    await stack.bus.subscribe(rsubj.GANG_WILDCARD, tap)
    try:
        from cordum_tpu.protocol.types import LABEL_GANG_KIND, LABEL_GANG_WORKERS
        from cordum_tpu.protocol.types import BusPacket, JobRequest

        payload = {"op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
                   "prompts": [[5, 9, 2, 7]], "max_new_tokens": 3, "dtype": "float32",
                   "page_size": 8, "cache_pages": 16}
        ptr = await stack.store.put_context("g-addr", payload)
        await stack.bus.publish(rsubj.SUBMIT, BusPacket.wrap(JobRequest(
            job_id="g-addr", topic="job.gang", tenant_id="default", context_ptr=ptr,
            labels={LABEL_GANG_WORKERS: "2", LABEL_GANG_KIND: "serving"}), sender_id="test"))
        assert await wait_state(stack.js, "g-addr", timeout_s=60.0) == "SUCCEEDED"
        res = await stack.store.get_result("g-addr")
    finally:
        await close_stack(stack)
    assert stores and all(s.startswith(f"{advertised}:") for s in stores), stores
    assert res["per_rank"]["1"]["steps_replayed"] == res["per_rank"]["0"]["steps"] > 0


@pytest.mark.parametrize("env, want", [({}, ""), ({"WORKER_GANG_ADDR": " 10.1.2.3 "}, "10.1.2.3")],
                         ids=["unset", "set"])
def test_worker_gang_addr_reaches_the_gang_runner(monkeypatch, env, want):
    from cordum_tpu_torch.cmd.worker import _gang_options
    from cordum_tpu_torch.worker.handlers import attach_default_gpu_worker

    monkeypatch.delenv("WORKER_GANG_ADDR", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    w = Worker(bus=LoopbackBus(), store=MemoryStore(MemoryKV()), worker_id="w-addr",
               pool="gpu", topics=["job.gpu.>"], capabilities=["gpu"],
               heartbeat_interval_s=999, device=CPU)
    attach_default_gpu_worker(w, batching=False, serving=False, **_gang_options(os.environ))
    assert isinstance(w.gang, tg.GangRunner) and w.gang.store_host == want


def test_mpmd_state_keeps_only_the_rank_slice_on_its_device():
    full = tg.mpmd_draw({"seed": 1}, 2)
    state = tg.mpmd_state(full, 0, 2, tg.mpmd_base(), CPU)
    assert state["device"] == torch.device(CPU) and state["vocab"] == 256
    assert tuple(state["params"]["stage"]["wq"].shape) == (1, 64, 64)
    before = [p.detach().clone() for p in optim.tree_leaves(state["params"])]
    tg.mpmd_sgd(state, [torch.ones_like(p) for p in before], 0.5)
    for b, p in zip(before, optim.tree_leaves(state["params"])):
        assert torch.equal(p.detach(), b - 0.5)
