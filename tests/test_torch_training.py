"""Parity of the port's training slice with the JAX package's, on the CPU:
``loss_fn`` and its gradients, AdamW against optax, the whole train step,
``TrainRunner`` (run, cancel and resume, checkpoints) and the worker's
``train`` op.

The port runs with ``device="cpu"``, so the dense attention is its plain
version (``tests/test_torch_dense_attention.py`` holds it, and on the card
the kernels, to JAX's ``_attention``).  Weights are JAX's ``init_params``
carried across by ``params_from_jax``; tokens come from numpy with a seed.
Tolerances:

* ``loss_fn``: the loss within 1e-5 relative, every gradient within 1e-5
  of its largest ``|value|`` (fp32; the frameworks sum in other orders);
* AdamW on shared gradients (JAX's, carried across), 3 steps: ``mu``,
  ``nu``, the params within 1e-6 of each leaf's largest ``|value|``,
  ``count`` equal.  Shared gradients, not two end-to-end runs: Adam's first
  update is about ``lr * sign(g)``, so a gradient near 0 that differs in
  its last bits between the frameworks would flip an update by ``2 lr``;
* the whole step (JAX's jitted SPMD step over its 8 CPU devices, batch 8,
  against the port's), fp32, 3 steps on the same batches: losses within
  1e-4 relative; one bf16 step's loss within 2e-2 relative (XLA and
  PyTorch round bf16 at other places through two layers).
"""
from __future__ import annotations

import asyncio
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.parallel.mesh import MeshSpec
from cordum_tpu_torch.worker.training import CheckpointDir, TrainRunner, profile_trace

CPU = "cpu"
LOSS_REL = GRAD_REL = 1e-5
ADAM_REL = 1e-6
STEP_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _cfgs(dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kw = {k: getattr(tl.LlamaConfig.tiny(), k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq_len")}
    return jl.LlamaConfig(dtype=jdt, **kw), tl.LlamaConfig(dtype=dtype, **kw)


def _port_params(jparams, *, grad=True):
    params = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    for p in optim.tree_leaves(params):
        p.requires_grad_(grad)
    return params


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _jax_leaves(tree):
    """A JAX param tree's leaves in the port's ``tree_leaves`` order."""
    return optim.tree_leaves(jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, jl.init_params(jax.random.PRNGKey(0), jcfg)


# ---------------------------------------------------------------------------
# loss, gradients, optimizer, step
# ---------------------------------------------------------------------------


def test_loss_and_gradients_match_jax(tiny):
    jcfg, tcfg, jparams = tiny
    toks = _tokens(4, 16, tcfg.vocab_size, 1)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jparams, jnp.asarray(toks), jcfg)
    params = _port_params(jparams)
    loss = tl.loss_fn(params, torch.from_numpy(toks), tcfg)
    leaves = optim.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(loss.item(), float(jloss)) <= LOSS_REL
    want = _jax_leaves(jgrads)
    assert len(want) == len(grads) == 3 + 9 * tcfg.n_layers
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) <= GRAD_REL


def test_adamw_matches_optax_on_shared_gradients(tiny):
    jcfg, tcfg, jparams = tiny
    opt = optax.adamw(3e-4, weight_decay=0.01)
    jstate = opt.init(jparams)
    params = _port_params(jparams, grad=False)
    state = optim.adamw_init(params)
    grad_fn = jax.jit(jax.grad(jl.loss_fn), static_argnums=2)
    for i in range(3):
        toks = jnp.asarray(_tokens(4, 16, tcfg.vocab_size, 10 + i))
        jgrads = grad_fn(jparams, toks, jcfg)
        updates, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optim.adamw_update(_jax_leaves(jgrads), state, params)
    adam = jstate[0]
    assert int(state["count"]) == int(adam.count) == 3
    assert state["count"].dtype == torch.int32
    for name, got, want in (("params", params, jparams), ("mu", state["mu"], adam.mu),
                            ("nu", state["nu"], adam.nu)):
        for g, w in zip(optim.tree_leaves(got), _jax_leaves(want)):
            assert g.dtype == torch.float32
            assert _rel(g.numpy(), w.numpy()) <= ADAM_REL, name


def test_adamw_decays_every_leaf():
    """Weight decay applies to norms and the embedding too (optax's mask
    is None): a zero gradient still shrinks every param."""
    params = {"embed": torch.ones(3, 2), "layers": [{"attn_norm": torch.ones(2)}]}
    state = optim.adamw_init(params)
    optim.adamw_update([torch.zeros(3, 2), torch.zeros(2)], state, params)
    for p in optim.tree_leaves(params):
        torch.testing.assert_close(p, torch.full_like(p, 1 - 3e-4 * 0.01), rtol=0, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_train_step_matches_jax(dtype):
    from cordum_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from cordum_tpu.parallel.mesh import build_mesh

    jcfg, tcfg = _cfgs(dtype)
    mesh = build_mesh(JMeshSpec(dp=-1))
    assert mesh.shape["dp"] == 8
    jinit, jstep = jl.make_train_step(jcfg, mesh)
    jparams, jstate = jinit(jax.random.PRNGKey(0))
    params = _port_params(jparams)
    _, step = tl.make_train_step(tcfg, device=CPU)
    state = optim.adamw_init(params)
    n_steps = 3 if dtype == torch.float32 else 1
    for i in range(n_steps):
        toks = _tokens(8, 16, tcfg.vocab_size, 20 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        params, state, loss = step(params, state, torch.from_numpy(toks))
        assert _rel(loss.float().item(), float(jloss)) <= STEP_REL[dtype], i
    assert int(state["count"]) == n_steps
    assert all(p.requires_grad and p.is_leaf for p in optim.tree_leaves(params))


def test_make_train_step_init_draws_leaf_params():
    _, tcfg = _cfgs()
    init, step = tl.make_train_step(tcfg, device=CPU)
    params, state = init(0)
    again, _ = init(0)
    leaves = optim.tree_leaves(params)
    assert all(p.is_leaf and p.requires_grad and p.device.type == "cpu" for p in leaves)
    assert all(torch.equal(a, b) for a, b in zip(leaves, optim.tree_leaves(again)))
    before = [p.detach().clone() for p in leaves]
    out, state2, loss = step(params, state, torch.from_numpy(_tokens(2, 8, tcfg.vocab_size, 0)))
    assert out is params and state2 is state  # updated in place
    assert torch.isfinite(loss) and not loss.requires_grad
    assert all(not torch.equal(a, b) for a, b in zip(before, optim.tree_leaves(params)))


def test_mesh_spec_resolves_like_the_reference():
    from cordum_tpu.parallel.mesh import MeshSpec as JMeshSpec

    for kw, n in (({}, 1), ({}, 8), ({"tp": 2}, 8), ({"dp": 2, "tp": 2, "sp": 2}, 8),
                  ({"pp": 4}, 8)):
        assert MeshSpec(**kw).resolve(n) == JMeshSpec(**kw).resolve(n)
    for kw, n in (({"tp": 0}, 1), ({"dp": -1, "tp": -1}, 4), ({"tp": 3}, 4),
                  ({"dp": 2}, 4)):
        with pytest.raises(ValueError):
            MeshSpec(**kw).resolve(n)


# ---------------------------------------------------------------------------
# TrainRunner: the cases of tests/test_training.py, ported
# ---------------------------------------------------------------------------


def test_train_runs_and_loss_drops(tmp_path):
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    out = runner.train({"model": "llama-tiny", "steps": 4, "batch": 4, "seq": 16,
                        "fixed_batch": True})
    assert out["completed"] and out["steps_done"] == 4
    assert out["final_loss"] < out["loss_first"]
    assert not out["checkpointed"]
    assert out["mesh"] == {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}


def test_train_checkpoint_resume(tmp_path):
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    payload = {"model": "llama-tiny", "steps": 6, "batch": 4, "seq": 16,
               "checkpoint_every": 2, "run_name": "resume-test"}
    # first attempt is cancelled after 3 steps (simulated preemption)
    calls = {"n": 0}

    def cancel_after_3():
        calls["n"] += 1
        return calls["n"] > 3

    out1 = runner.train(payload, cancelled=cancel_after_3)
    assert not out1["completed"]
    assert out1["steps_done"] == 3
    # re-dispatch resumes from the last checkpoint (step 2), not from zero
    out2 = runner.train(payload)
    assert out2["resumed_from"] == 2
    assert out2["completed"] and out2["steps_done"] == 6


def test_resume_restores_the_saved_state(tmp_path):
    """A run resumed from step 2 ends where an uncut run ends: the restored
    params and moments are the saved ones, and the batches follow the step."""
    payload = {"model": "llama-tiny", "steps": 4, "batch": 2, "seq": 8,
               "checkpoint_every": 2}
    whole = TrainRunner(ckpt_root=str(tmp_path / "a"), device=CPU).train(payload)
    runner = TrainRunner(ckpt_root=str(tmp_path / "b"), device=CPU)
    calls = {"n": 0}

    def cancel_after_2():
        calls["n"] += 1
        return calls["n"] > 2

    runner.train(payload, cancelled=cancel_after_2)
    resumed = runner.train(payload)
    assert resumed["resumed_from"] == 2
    assert resumed["final_loss"] == whole["final_loss"]
    a = CheckpointDir(str(tmp_path / "a" / "default")).restore(4, torch.device(CPU))
    b = CheckpointDir(str(tmp_path / "b" / "default")).restore(4, torch.device(CPU))
    for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)):
        assert torch.equal(x, y)


def test_checkpoints_keep_the_newest_three(tmp_path):
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    out = runner.train({"model": "llama-tiny", "steps": 10, "batch": 2, "seq": 8,
                        "checkpoint_every": 2, "run_name": "keep"})
    assert out["checkpointed"] and out["completed"]
    assert CheckpointDir(str(tmp_path / "keep")).steps() == [6, 8, 10]
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == ["10", "6", "8"]


@pytest.mark.parametrize("corruption", ["garbage", "other_model"])
def test_corrupt_checkpoint_starts_fresh_with_a_warning(tmp_path, caplog, corruption):
    ckpt = CheckpointDir(str(tmp_path / "bad"))
    if corruption == "garbage":
        (tmp_path / "bad" / "4").mkdir()
        (tmp_path / "bad" / "4" / "state.pt").write_bytes(b"not a checkpoint")
    else:
        ckpt.save(4, {"params": {"embed": torch.zeros(3)}, "opt_state": {}})
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    with caplog.at_level(logging.WARNING, logger="cordum"):
        out = runner.train({"model": "llama-tiny", "steps": 2, "batch": 2, "seq": 8,
                            "checkpoint_every": 2, "run_name": "bad"})
    assert out["resumed_from"] == 0 and out["completed"] and out["steps_done"] == 2
    assert any("checkpoint restore failed" in r.getMessage() for r in caplog.records)
    assert ckpt.latest_step() == 4  # step 2 saved beside it; 4 is still the newest


@pytest.mark.parametrize("model, roadmap", [("gpt", "unknown")])
def test_unported_families_raise(tmp_path, model, roadmap):
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    with pytest.raises(ValueError, match=roadmap):
        runner.train({"model": model, "steps": 1})


@pytest.fixture(scope="module")
def moe_reference_result(tmp_path_factory):
    """The reference ``TrainRunner``'s result for a one-step ``moe-tiny``
    job (its 8 CPU devices: dp 8)."""
    from cordum_tpu.worker.training import TrainRunner as JTrainRunner

    return JTrainRunner(ckpt_root=str(tmp_path_factory.mktemp("jmoe"))).train(
        {"model": "moe-tiny", "steps": 1, "batch": 8, "seq": 8})


@pytest.mark.parametrize("model", ["moe", "moe-tiny"])
def test_moe_families_train_with_the_reference_keys(tmp_path, model, moe_reference_result):
    """Both families are ``MoEConfig.tiny()``, as the reference builds them;
    the loss falls on a fixed batch, the result and mesh keys are the
    reference's, and ``ep`` resolves to 1 on one device."""
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    out = runner.train({"model": model, "steps": 4, "batch": 4, "seq": 16,
                        "fixed_batch": True, "mesh": {"ep": 2}})
    assert out["completed"] and out["steps_done"] == 4 and out["model"] == model
    assert out["final_loss"] < out["loss_first"]
    assert set(out) == set(moe_reference_result)
    assert set(out["mesh"]) == set(moe_reference_result["mesh"])
    assert out["mesh"] == {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}
    assert moe_reference_result["mesh"]["ep"] == 1


@pytest.mark.parametrize("model", ["moe", "moe-tiny"])
def test_moe_checkpoint_resume_restores_the_nested_tree(tmp_path, model):
    """A MoE run cut after step 2 and resumed ends where an uncut run ends:
    the nested ``"moe"`` params and their moments come back as saved."""
    payload = {"model": model, "steps": 4, "batch": 2, "seq": 8, "checkpoint_every": 2}
    whole = TrainRunner(ckpt_root=str(tmp_path / "a"), device=CPU).train(payload)
    runner = TrainRunner(ckpt_root=str(tmp_path / "b"), device=CPU)
    calls = {"n": 0}

    def cancel_after_2():
        calls["n"] += 1
        return calls["n"] > 2

    cut = runner.train(payload, cancelled=cancel_after_2)
    assert cut["steps_done"] == 2 and not cut["completed"]
    resumed = runner.train(payload)
    assert resumed["resumed_from"] == 2 and resumed["completed"]
    assert resumed["final_loss"] == whole["final_loss"]
    a = CheckpointDir(str(tmp_path / "a" / "default")).restore(4, torch.device(CPU))
    b = CheckpointDir(str(tmp_path / "b" / "default")).restore(4, torch.device(CPU))
    assert set(a["params"]["layers"][0]["moe"]) == {"router", "w_gate", "w_up", "w_down"}
    assert a["params"]["layers"][0]["moe"]["router"].dtype == torch.float32
    assert set(a["opt_state"]["mu"]["layers"][1]["moe"]) == {"router", "w_gate", "w_up",
                                                              "w_down"}
    leaves_a, leaves_b = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) == 1 + 3 * (3 + 10 * 2)
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)


def test_result_keys_equal_the_reference(tmp_path):
    from cordum_tpu.worker.training import TrainRunner as JTrainRunner

    want = JTrainRunner(ckpt_root=str(tmp_path / "j")).train(
        {"model": "llama-tiny", "steps": 1, "batch": 8, "seq": 8})
    got = TrainRunner(ckpt_root=str(tmp_path / "t"), device=CPU).train(
        {"model": "llama-tiny", "steps": 1, "batch": 2, "seq": 8})
    assert set(got) == set(want)
    assert set(got["mesh"]) == set(want["mesh"])
    import chip_smoke

    assert set(want) == chip_smoke.TRAIN_RESULT_KEYS  # what phase 7 holds the worker to
    for key in ("model", "resumed_from", "steps_done", "completed", "checkpointed"):
        assert got[key] == want[key], key
    assert isinstance(got["final_loss"], float) and isinstance(got["seconds"], float)


def test_batch_defaults_and_rounding(tmp_path):
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    seen = []
    _, step = tl.make_train_step(tl.LlamaConfig.tiny(), device=CPU)

    def spy(params, state, tokens):
        seen.append(tuple(tokens.shape))
        return step(params, state, tokens)

    build = runner._build

    def with_spy(payload):
        init, _, *rest = build(payload)
        return (init, spy, *rest)

    runner._build = with_spy
    runner.train({"model": "llama-tiny", "steps": 1, "seq": 8})
    runner.train({"model": "llama-tiny", "steps": 1, "batch": 3, "seq": 8})
    assert seen == [(2, 8), (3, 8)]  # dp 1: default max(2, 2 dp), no rounding


def test_profile_trace(tmp_path):
    x = torch.ones((64, 64))
    out, trace_dir = profile_trace(lambda a: (a @ a.T).sum(), x,
                                   trace_dir=str(tmp_path / "trace"))
    assert float(out) == 64 * 64 * 64
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(trace_dir) for f in fs]
    assert files and all(f.endswith(".json") and os.path.getsize(f) > 0 for f in files)


def test_import_scan_covers_the_training_slice():
    """``tests/test_torch_serving.py`` imports every module of the package
    with JAX, the JAX package and msgpack blocked; this slice's modules are
    among them."""
    import pkgutil

    import cordum_tpu_torch

    mods = {m.name for m in pkgutil.walk_packages(cordum_tpu_torch.__path__,
                                                   "cordum_tpu_torch.")}
    assert {"cordum_tpu_torch.parallel.mesh", "cordum_tpu_torch.optim",
            "cordum_tpu_torch.worker.training", "cordum_tpu_torch.models.pipeline",
            "cordum_tpu_torch.worker.gang",
            "cordum_tpu_torch.ops.dense_attention"} <= mods


def test_chip_smoke_counts_each_kernel_once_in_a_profile():
    """``chip_smoke.py``'s profiled windows sum device time over the
    kernels' own events: a host op's row (``aten::mm``) repeats the device
    time of the kernel it launched and is left out."""
    import types

    from torch.autograd import DeviceType

    import chip_smoke

    events = [
        types.SimpleNamespace(key="aten::mm", device_type=DeviceType.CPU,
                              self_device_time_total=90.0, count=1),
        types.SimpleNamespace(key="nvjet_gemm", device_type=DeviceType.CUDA,
                              self_device_time_total=90.0, count=1),
        types.SimpleNamespace(key="aten::empty", device_type=DeviceType.CPU,
                              self_device_time_total=0.0, count=2),
    ]
    prof = types.SimpleNamespace(key_averages=lambda: events)
    assert chip_smoke.kernel_rows(prof) == [("nvjet_gemm", 90.0, 1)]


def test_chip_smoke_dense_bounds_count_the_live_pairs():
    """Phase 7's bound: 4 hd operations a live (query, key) pair forward,
    10 hd backward; causal rows at positions 0..T-1 make T(T+1)/2 pairs a
    head, a row at a negative position T (uniform over every key)."""
    import chip_smoke

    b, t, h, kvh, hd = 2, 5, 4, 2, 16
    pos = torch.arange(t, dtype=torch.int32).expand(b, t).clone()
    (fb, fo), (bb, bo) = chip_smoke.dense_work_of(b, t, h, kvh, hd, 2, pos)
    pairs = b * t * (t + 1) // 2
    assert fo == 4 * hd * h * pairs and bo == 10 * hd * h * pairs
    q, kv, small = b * t * h * hd, b * t * kvh * hd, 4 * b * t + 4 * b * h * t
    assert fb == 2 * (2 * q + 2 * kv) + small and bb == 2 * (4 * q + 4 * kv) + small
    pos[0, 0] = -1  # one row more reaches all t keys instead of 1
    assert chip_smoke.dense_work_of(b, t, h, kvh, hd, 2, pos)[0][1] == fo + 4 * hd * h * (t - 1)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainRunner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.make_train_step(tl.LlamaConfig.tiny())


# ---------------------------------------------------------------------------
# the train op end to end (tests/test_training.py's case, on a port worker)
# ---------------------------------------------------------------------------


async def test_train_op_end_to_end(tmp_path):
    from cordum_tpu_torch.infra.bus import LoopbackBus
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.models.embedder import EmbedderConfig
    from cordum_tpu_torch.protocol import subjects as subj
    from cordum_tpu_torch.protocol.types import BusPacket, JobRequest
    from cordum_tpu_torch.worker.handlers import attach_default_gpu_worker
    from cordum_tpu_torch.worker.runtime import Worker

    bus, store = LoopbackBus(), MemoryStore(MemoryKV())
    w = Worker(bus=bus, store=store, worker_id="w-train", pool="gpu", capabilities=["gpu"],
               heartbeat_interval_s=999, device=CPU)
    attach_default_gpu_worker(
        w, batching=False, serving=False, ckpt_root=str(tmp_path),
        embedder_cfg=EmbedderConfig(n_layers=1, d_model=64, max_len=16))
    results, progress = [], []

    async def on_result(subject, pkt):
        if pkt.job_result is not None and pkt.job_result.status != "RUNNING":
            results.append(pkt.job_result)

    async def on_progress(subject, pkt):
        if pkt.job_progress is not None:
            progress.append(pkt.job_progress)

    await bus.subscribe(subj.RESULT, on_result)
    await bus.subscribe(subj.PROGRESS, on_progress)
    await w.start()
    payload = {"op": "train", "model": "llama-tiny", "steps": 3, "batch": 4, "seq": 16,
               "checkpoint_every": 1, "run_name": "e2e"}
    ptr = await store.put_context("j-train", payload)
    await bus.publish(subj.direct_subject("w-train"), BusPacket.wrap(
        JobRequest(job_id="j-train", topic="job.gpu.train", context_ptr=ptr)))
    for _ in range(1000):
        await bus.drain()
        if results:
            break
        await asyncio.sleep(0.01)
    await bus.drain()
    await w.stop()
    assert [r.status for r in results] == ["SUCCEEDED"]
    res = await store.get_result("j-train")
    assert res["completed"] and res["steps_done"] == 3 and res["checkpointed"]
    # progress events flowed, one a step, and the checkpoints went to ckpt_root
    assert [round(p.percent) for p in progress if p.job_id == "j-train"] == [33, 67, 100]
    assert CheckpointDir(str(tmp_path / "e2e")).steps() == [1, 2, 3]
