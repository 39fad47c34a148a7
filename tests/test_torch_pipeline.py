"""Parity of the port's pipeline family (``cordum_tpu_torch/models/pipeline.py``
and the ``pipeline`` jobs of ``worker/training.py``) with the JAX package's
``cordum_tpu/models/pipeline.py`` and ``worker/training.py``, on the CPU.

The JAX side runs its ``shard_map`` pipeline over the 8 virtual CPU devices
(``tests/conftest.py``) at pp 2 (dp 4) and pp 4 (dp 2); the port runs the
same ``M + S - 1``-tick schedule on one process, its attention the plain
version.  Weights are JAX's ``init_params`` carried across by
``params_from_jax``; tokens come from numpy with a seed.  The config is the
reference test's (``tests/test_moe_pipeline.py``): vocab 128, d 32, 4
layers, 2 heads over 2 KV heads, d_ff 64; M 2.  Tolerances:

* the loss within 1e-5 relative and every gradient within 1e-5 of its
  largest ``|value|`` against JAX (fp32; the frameworks sum in other
  orders; measured 9e-8 and 2e-6);
* the one-process schedule against the port's own ``llama.loss_fn`` on the
  unstacked weights: the loss within 1e-6 relative, every gradient within
  1e-6 of its largest ``|value|`` (the same operations; only the sum over
  microbatches is split; measured 0 and 4e-7);
* the train step against JAX's jitted ``make_train_step`` (optax's
  ``adamw(3e-4)``): fp32, 3 steps, each loss within 1e-4 relative and every
  param within 6 lr = 1.8e-3 (an Adam update is about ``lr * sign(g)``, so
  a gradient within fp32 noise of 0 may flip an update by 2 lr a step;
  measured 2e-6); bf16, 1 step, the loss within 2e-2 relative (XLA and
  PyTorch round bf16 at other places) and every param within ``2 lr (1 +
  2^-5)`` (an update whose sign flips; at step 1 ``|u|`` is 1 up to a few
  bf16 roundings of its terms) plus one bf16 ulp, ``2^-7`` of the larger
  of the two values (each side rounds half an ulp);
* a zero-gradient step shrinks every leaf by ``1 - 3e-4 * 1e-4`` within
  1e-7: the pipeline's optimizer is optax's default ``adamw(3e-4)``, weight
  decay 1e-4, not the Llama family's 0.01.
"""
from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.models import pipeline as jp
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import pipeline as tp
from cordum_tpu_torch.worker.training import CheckpointDir, TrainRunner, model_config

CPU = "cpu"
REL = 1e-5
SCHEDULE_REL = 1e-6
LR = 3e-4
STEP_LOSS_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PARAM_ATOL_FP32 = 6 * LR
BF16_ULP = 2.0**-7
BF16_FLIP = 2 * LR * (1 + 2.0**-5)
SHAPE = {"vocab_size": 128, "d_model": 32, "n_layers": 4, "n_heads": 2, "n_kv_heads": 2,
         "d_ff": 64}
M = 2


def _cfgs(pp, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jp.PipelineConfig(base=jl.LlamaConfig(dtype=jdt, **SHAPE), n_stages=pp,
                             n_microbatches=M)
    tcfg = tp.PipelineConfig(base=tl.LlamaConfig(dtype=dtype, **SHAPE), n_stages=pp,
                             n_microbatches=M)
    return jcfg, tcfg


def _tokens(b, t, seed, vocab=SHAPE["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _port_params(jparams, *, grad=True):
    params = tp.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    for p in optim.tree_leaves(params):
        p.requires_grad_(grad)
    return params


def _jax_leaves(tree):
    """A JAX param tree's leaves (as fp32) in the port's ``tree_leaves``
    order."""
    return optim.tree_leaves(jax.tree.map(
        lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))), tree))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def mesh_loss(request):
    """The JAX pipeline's loss and gradients on the 8-device mesh at pp
    ``request.param`` (dp the rest), built once, with its weights."""
    pp = request.param
    jcfg, tcfg = _cfgs(pp)
    jparams = jp.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(dp=8 // pp, pp=pp))
    value_and_grad = jax.jit(jax.value_and_grad(jp.make_loss_fn(jcfg, mesh)))
    return tcfg, jparams, value_and_grad


# ---------------------------------------------------------------------------
# the loss, the schedule, the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_loss_and_gradients_match_the_jax_mesh(mesh_loss, seed):
    tcfg, jparams, value_and_grad = mesh_loss
    toks = _tokens(8, 12, seed).reshape(M, 4, 12)
    jloss, jgrads = value_and_grad(jparams, jnp.asarray(toks))
    params = _port_params(jparams)
    loss = tp.make_loss_fn(tcfg)(params, torch.from_numpy(toks))
    leaves = optim.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want) == 3 + len(tp.STAGE_LEAVES)
    assert abs(loss.item() - float(jloss)) / float(jloss) <= REL
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) <= REL


@pytest.mark.parametrize("pp, m", [(1, 1), (2, 2), (2, 4), (4, 2), (4, 3)])
def test_schedule_equals_llama_loss_on_the_unstacked_weights(pp, m):
    """Every tick count and bubble shape: the one-process schedule is the
    port's Llama loss over the same layers, loss and gradients."""
    _, tcfg = _cfgs(pp)
    tcfg = tp.PipelineConfig(base=tcfg.base, n_stages=pp, n_microbatches=m)
    params = tp.init_params(tcfg, generator=torch.Generator().manual_seed(pp), device=CPU)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(_tokens(2 * m, 10, 30 + m))
    loss = tp.make_loss_fn(tcfg)(params, tp.microbatch(toks, m))
    grads = torch.autograd.grad(loss, leaves)
    ref = tl.loss_fn(tp.unstacked(params), toks, tcfg.base)
    ref_grads = torch.autograd.grad(ref, leaves)
    assert abs(loss.item() - ref.item()) / ref.item() <= SCHEDULE_REL
    for g, w in zip(grads, ref_grads):
        assert _rel(g.numpy(), w.numpy()) <= SCHEDULE_REL


def test_each_stage_runs_its_layers_once_a_microbatch(monkeypatch):
    """Bubble ticks are skipped: a step calls the attention ``layers × M``
    times, not ``layers × (M + S - 1)``."""
    calls = []

    def counting(q, k, v, cfg, *, q_offset=None):
        calls.append(q.shape[0])
        return tl._attention(q, k, v, cfg, q_offset=q_offset)

    _, tcfg = _cfgs(4)
    params = tp.init_params(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)
    toks = tp.microbatch(torch.from_numpy(_tokens(6, 8, 3)), 3)
    tp.make_loss_fn(tcfg, attention=counting)(params, toks)
    assert calls == [2] * (SHAPE["n_layers"] * 3)


def test_init_params_has_the_reference_layout():
    jcfg, tcfg = _cfgs(2, torch.bfloat16)
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jp.init_params(jax.random.PRNGKey(0), jcfg))
    got = tp.init_params(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert set(got) == set(want) and set(got["stages"]) == set(want["stages"])
    for name in ("embed", "final_norm", "lm_head"):
        assert (tuple(got[name].shape), "bfloat16") == want[name]
    for name, leaf in got["stages"].items():
        assert (tuple(leaf.shape), "bfloat16") == want["stages"][name], name
    assert torch.equal(got["stages"]["attn_norm"], torch.ones(2, 2, 32, dtype=torch.bfloat16))
    again = tp.init_params(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(got),
                                                  optim.tree_leaves(again)))


@pytest.mark.parametrize("b, m", [(4, 2), (6, 3), (5, 1)])
def test_microbatch_matches_the_reference(b, m):
    toks = _tokens(b, 7, b)
    got = tp.microbatch(torch.from_numpy(toks), m)
    want = np.asarray(jp.microbatch(jnp.asarray(toks), m))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_microbatch_refuses_a_batch_it_cannot_split():
    toks = _tokens(5, 4, 0)
    with pytest.raises(AssertionError):
        jp.microbatch(jnp.asarray(toks), 2)
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        tp.microbatch(torch.from_numpy(toks), 2)


def test_layers_must_split_into_the_stages():
    with pytest.raises(ValueError, match="must divide"):
        tp.PipelineConfig(base=tl.LlamaConfig.tiny(), n_stages=3).layers_per_stage


# ---------------------------------------------------------------------------
# the train step and its optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_train_step_matches_jax(dtype):
    jcfg, tcfg = _cfgs(2, dtype)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(dp=4, pp=2))
    jinit, jstep = jp.make_train_step(jcfg, mesh)
    jparams, jstate = jinit(jax.random.PRNGKey(0))
    params = _port_params(jparams)  # copied before the donating JAX step
    _, step = tp.make_train_step(tcfg, device=CPU)
    state = optim.adamw_init(params)
    n_steps = 3 if dtype == torch.float32 else 1
    for i in range(n_steps):
        toks = _tokens(8, 12, 20 + i).reshape(M, 4, 12)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        params, state, loss = step(params, state, torch.from_numpy(toks))
        assert abs(loss.float().item() - float(jloss)) / float(jloss) <= STEP_LOSS_REL[dtype], i
    assert int(state["count"]) == n_steps
    for got, want in zip(optim.tree_leaves(params), _jax_leaves(jparams)):
        got = got.detach().float()
        diff = (got - want).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= PARAM_ATOL_FP32
        else:
            bound = BF16_FLIP + BF16_ULP * torch.maximum(got.abs(), want.abs())
            assert bool((diff <= bound).all()), (diff / bound).max().item()


def test_zero_gradient_step_decays_by_optax_default(monkeypatch):
    """The weight-decay trap: the pipeline step's default optimizer decays
    by 1e-4, as ``optax.adamw(3e-4)`` does, every leaf at once."""
    _, tcfg = _cfgs(2)

    def zero_loss_fn(cfg, *, attention=None):
        return lambda params, toks: sum(p.sum() for p in optim.tree_leaves(params)) * 0.0

    monkeypatch.setattr(tp, "make_loss_fn", zero_loss_fn)
    init, step = tp.make_train_step(tcfg, device=CPU)
    params, state = init(0)
    with torch.no_grad():
        for p in optim.tree_leaves(params):
            p.fill_(1.0)
    step(params, state, torch.zeros((M, 2, 4), dtype=torch.int32))
    want = 1 - LR * optim.OPTAX_WEIGHT_DECAY
    for p in optim.tree_leaves(params):
        torch.testing.assert_close(p.detach(), torch.full_like(p, want), rtol=0, atol=1e-7)
    # optax's own default on the same zero gradient
    ones = jnp.ones((3,))
    opt = optax.adamw(LR)
    updates, _ = opt.update(jnp.zeros((3,)), opt.init(ones), ones)
    assert np.allclose(np.asarray(optax.apply_updates(ones, updates)), want, rtol=0, atol=1e-7)


def test_the_llama_family_keeps_its_weight_decay():
    """``optim.adamw`` binds its numbers; the default pair stays 0.01."""
    for (opt_init, opt_update), decay in (((optim.adamw_init, optim.adamw_update), 0.01),
                                          (optim.adamw(), 0.01),
                                          (optim.adamw(weight_decay=1e-4), 1e-4)):
        p = {"w": torch.ones(4)}
        opt_update([torch.zeros(4)], opt_init(p), p)
        torch.testing.assert_close(p["w"], torch.full((4,), 1 - LR * decay), rtol=0, atol=1e-7)
    assert optim.WEIGHT_DECAY == 0.01


# ---------------------------------------------------------------------------
# the pipeline family in TrainRunner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_pipeline_job(tmp_path_factory):
    """The reference ``TrainRunner``'s one-step ``pipeline`` job (8 CPU
    devices: pp 2, dp 4) and the shape of the tokens its step took."""
    from cordum_tpu.worker.training import TrainRunner as JTrainRunner

    runner = JTrainRunner(ckpt_root=str(tmp_path_factory.mktemp("jpipe")))
    seen = []
    build = runner._build

    def with_spy(payload):
        init, step, mesh, vocab, model = build(payload)

        def spy(params, state, tokens):
            seen.append(tuple(tokens.shape))
            return step(params, state, tokens)

        return init, spy, mesh, vocab, model

    runner._build = with_spy
    out = runner.train({"model": "pipeline", "steps": 1, "batch": 5, "seq": 8,
                        "microbatches": 2})
    return out, seen


def test_pipeline_job_has_the_reference_keys_and_batch_quantum(tmp_path,
                                                               reference_pipeline_job):
    """Both runners round the batch up to ``dp × microbatches`` and
    microbatch it before the step; each reports its own mesh (the
    reference's 8 devices give dp 4, pp 2; one card dp 1, pp 1)."""
    want, want_shapes = reference_pipeline_job
    runner = TrainRunner(ckpt_root=str(tmp_path), device=CPU)
    seen = []
    build = runner._build

    def with_spy(payload):
        init, step, *rest = build(payload)

        def spy(params, state, tokens):
            seen.append(tuple(tokens.shape))
            return step(params, state, tokens)

        return (init, spy, *rest)

    runner._build = with_spy
    got = runner.train({"model": "pipeline", "steps": 1, "batch": 5, "seq": 8,
                        "microbatches": 2})
    assert set(got) == set(want) and set(got["mesh"]) == set(want["mesh"])
    assert got["model"] == want["model"] == "pipeline" and got["completed"]
    for doc, shapes in ((want, want_shapes), (got, seen)):
        quantum = doc["mesh"]["dp"] * 2
        batch = max(quantum, -(-5 // quantum) * quantum)
        assert shapes == [(2, batch // 2, 8)], (doc["mesh"], shapes)
    assert want["mesh"]["pp"] == 2 and got["mesh"] == {"dp": 1, "tp": 1, "sp": 1, "ep": 1,
                                                       "pp": 1}
    for payload, shape in (({"microbatches": 4, "batch": 5}, (4, 2, 8)),
                           ({"microbatches": 2}, (2, 1, 8)),
                           ({"microbatches": 3, "batch": 6, "mesh": {"pp": 2}}, (3, 2, 8))):
        seen.clear()
        runner.train({"model": "pipeline", "steps": 1, "seq": 8, **payload})
        assert seen == [shape], payload


def test_model_config_builds_the_pipeline_as_the_reference():
    cfg = model_config("pipeline", pp=1, microbatches=3)
    assert cfg == tp.PipelineConfig(base=tl.LlamaConfig.tiny(), n_stages=1, n_microbatches=3)
    assert model_config("pipeline-tiny").n_microbatches == 2
    with pytest.raises(ValueError, match="unknown model family"):
        model_config("gpt")


def test_pipeline_job_learns_on_a_fixed_batch(tmp_path):
    out = TrainRunner(ckpt_root=str(tmp_path), device=CPU).train(
        {"model": "pipeline", "steps": 4, "batch": 4, "seq": 16, "fixed_batch": True,
         "microbatches": 2})
    assert out["completed"] and out["steps_done"] == 4
    assert out["final_loss"] < out["loss_first"]


def test_pipeline_checkpoint_resume_restores_the_stacked_tree(tmp_path):
    """A pipeline run cut after step 2 and resumed ends where an uncut run
    ends: the stacked ``stages`` leaves and their moments come back as
    saved."""
    payload = {"model": "pipeline", "steps": 4, "batch": 4, "seq": 8, "checkpoint_every": 2}
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
    assert set(a["params"]["stages"]) == set(tp.STAGE_LEAVES)
    assert tuple(a["params"]["stages"]["wq"].shape) == (1, 2, 64, 64)  # [S, L/S, D, D]
    assert set(a["opt_state"]["nu"]["stages"]) == set(tp.STAGE_LEAVES)
    leaves_a, leaves_b = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) == 1 + 3 * (3 + len(tp.STAGE_LEAVES))
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)


def test_a_llama_checkpoint_does_not_restore_into_a_pipeline(tmp_path, caplog):
    """Another family's checkpoint under the run's name is refused and the
    pipeline starts fresh."""
    import logging

    TrainRunner(ckpt_root=str(tmp_path), device=CPU).train(
        {"model": "llama-tiny", "steps": 2, "batch": 2, "seq": 8, "checkpoint_every": 2,
         "run_name": "mixed"})
    with caplog.at_level(logging.WARNING, logger="cordum"):
        out = TrainRunner(ckpt_root=str(tmp_path), device=CPU).train(
            {"model": "pipeline", "steps": 1, "batch": 2, "seq": 8, "checkpoint_every": 2,
             "run_name": "mixed"})
    assert out["resumed_from"] == 0 and out["completed"]
    assert any("checkpoint restore failed" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 11.1 on the CPU
# ---------------------------------------------------------------------------


def _counting_dense(attention):
    """A stand-in for the B9 wrapper on the CPU: ``attention`` (the plain
    version, or a faulty one), counted as the kernels count their
    launches, forward and backward."""
    from cordum_tpu_torch.ops import dense_attention as da

    def counting(q, k, v, positions):
        da.dense_attention_fwd.launches += 1
        out = attention(q, k, v, positions)
        if out.requires_grad:
            out.register_hook(lambda g: setattr(da.dense_attention_bwd, "launches",
                                                da.dense_attention_bwd.launches + 1))
        return out

    return counting


def _oracle_cfg():
    import dataclasses

    base = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    return tp.PipelineConfig(base=base, n_stages=2, n_microbatches=2)


def test_chip_smoke_pipeline_oracle_rehearses_on_the_cpu(monkeypatch):
    """Phase 11.1 at a tiny size: the stand-in's path against the plain
    pipeline and the unstacked Llama loss; B9 counted layers x M."""
    import chip_smoke
    from cordum_tpu_torch.ops import dense_attention as da

    monkeypatch.setattr(tl, "dense_attention", _counting_dense(da.dense_attention_reference))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    launches = chip_smoke.phase_pipeline_oracle(torch, torch.device(CPU), "cpu", _oracle_cfg(),
                                                batch=2, seq=16)
    assert launches == {"dense_attention_fwd": 4, "dense_attention_bwd": 4}


def test_chip_smoke_pipeline_oracle_refuses_a_key_past_the_mask(monkeypatch):
    """A kernel that lets each query see one key past its position fails
    11.1's gate."""
    import chip_smoke
    from cordum_tpu_torch.ops import dense_attention as da

    def leaky(q, k, v, positions):
        return da.dense_attention_reference(q, k, v, positions + 1)

    monkeypatch.setattr(tl, "dense_attention", _counting_dense(leaky))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(AssertionError, match="fp32 pipeline oracle"):
        chip_smoke.phase_pipeline_oracle(torch, torch.device(CPU), "cpu", _oracle_cfg(),
                                         batch=2, seq=16)


def test_chip_smoke_pipeline_oracle_refuses_a_nan_gradient(monkeypatch):
    """A backward that writes one NaN into dq, with the forward (and so
    every loss) left finite, fails 11.1's gradient gate."""
    import chip_smoke
    from cordum_tpu_torch.ops import dense_attention as da

    def nan_dq(g):
        return g.flatten().index_fill(0, torch.tensor([0]), float("nan")).view_as(g)

    def faulty(q, k, v, positions):
        if q.requires_grad:
            q.register_hook(nan_dq)
        return da.dense_attention_reference(q, k, v, positions)

    monkeypatch.setattr(tl, "dense_attention", _counting_dense(faulty))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(AssertionError, match=r"fp32 pipeline oracle.*\(inf, "):
        chip_smoke.phase_pipeline_oracle(torch, torch.device(CPU), "cpu", _oracle_cfg(),
                                         batch=2, seq=16)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("side", ["got", "want"])
def test_chip_smoke_worst_grad_puts_a_non_finite_error_first(bad, side):
    """``worst_grad`` (the gradient gate of 9.2 and 11.1) returns inf and
    the leaf for a NaN or inf in either gradient, after a finite larger
    error too."""
    import chip_smoke

    want = [torch.ones(3), torch.ones(3), torch.ones(3)]
    got = [w.clone() for w in want]
    got[0][1] = 1.5
    assert chip_smoke.worst_grad(got, want, "abc") == (0.5, "a")
    (got if side == "got" else want)[2][0] = bad
    assert chip_smoke.worst_grad(got, want, "abc") == (float("inf"), "c")


def test_chip_smoke_finds_a_routable_address_or_none():
    import chip_smoke

    found = chip_smoke.routable_address()
    assert found is None or (found[0] and not found[1].startswith("127."))


def test_chip_smoke_pipeline_jobs_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """Phase 11.3 on the CPU: ``pipeline`` train jobs through a port
    worker's ``train`` op, cut after step 2 and resumed, then one at M 4;
    the stand-in counts layers x microbatches x steps."""
    import chip_smoke
    from cordum_tpu_torch.ops import dense_attention as da

    monkeypatch.setattr(tl, "dense_attention", _counting_dense(da.dense_attention_reference))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    launches = asyncio.run(chip_smoke.drive_pipeline_worker(
        torch, torch.device(CPU), "cpu", str(tmp_path), batch=4, seq=16))
    assert launches == {"dense_attention_fwd": 48, "dense_attention_bwd": 48}
