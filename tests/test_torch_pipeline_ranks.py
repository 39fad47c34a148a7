"""The multi-rank pipeline (``cordum_tpu_torch/models/pipeline.py``
``make_rank_grad`` and ``make_train_step(..., mesh=)`` over a
``parallel/mesh.py`` ``TrainMesh``) against the JAX package's ``shard_map``
pipeline on a mesh of the same shape and against the port's one-process
schedule, on the CPU.

Each rank is a thread over in-process gloo groups (``in_process_meshes``);
the JAX side runs ``make_loss_fn`` / ``make_train_step`` on
``build_mesh(MeshSpec(dp=, pp=), devices=jax.devices()[:dp * pp])`` over
the virtual CPU devices of ``tests/conftest.py``.  Weights are JAX's
``init_params`` carried across by ``params_from_jax`` and cut to each
rank's stage (``stage_slice``); tokens come from numpy with a seed; every
rank is given the whole batch and takes its dp rows.  The config is
``tests/test_torch_pipeline.py``'s (vocab 128, d 32, 4 layers, 2 heads
over 2 KV heads, d_ff 64).  Tolerances, fp32 unless said:

* against JAX: the loss within 1e-5 relative and every gathered gradient
  within 1e-5 of its largest ``|value|`` (the frameworks sum in other
  orders; ``tests/test_torch_pipeline.py``'s ``REL``);
* against the one-process port: the loss within 1e-6 relative and every
  gathered gradient within 1e-6 of its largest ``|value|`` (the same
  operations; the nll sum and, with dp, the token sums are split over
  ranks and summed again);
* the train step against JAX's: 3 fp32 steps, every param within
  ``PARAM_ATOL_FP32`` (6 lr: an Adam update is about lr sign(g), so a
  gradient within noise of zero flips it by 2 lr a step); 1 bf16 step,
  within ``BF16_FLIP + BF16_ULP |x|`` (``test_train_step_matches_jax``'s
  derivation); each loss within 1e-4 (fp32) and 2e-2 (bf16) relative.

The last part rehearses ``chip_smoke.py``'s phase 12 on the CPU: its rank
body in threads, held to its one-process oracle by its own gates, and the
faults those gates must refuse.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.models import pipeline as jp
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import pipeline as tp
from cordum_tpu_torch.parallel.mesh import MeshSpec, in_process_meshes

CPU = torch.device("cpu")
REL = 1e-5
ONE_PROCESS_REL = 1e-6
LR = 3e-4
STEP_LOSS_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PARAM_ATOL_FP32 = 6 * LR
BF16_ULP = 2.0**-7
BF16_FLIP = 2 * LR * (1 + 2.0**-5)
SHAPE = {"vocab_size": 128, "d_model": 32, "n_layers": 4, "n_heads": 2, "n_kv_heads": 2,
         "d_ff": 64}
TIMEOUT_S = 60.0


def _cfgs(pp, m, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jp.PipelineConfig(base=jl.LlamaConfig(dtype=jdt, **SHAPE), n_stages=pp,
                             n_microbatches=m)
    tcfg = tp.PipelineConfig(base=tl.LlamaConfig(dtype=dtype, **SHAPE), n_stages=pp,
                             n_microbatches=m)
    return jcfg, tcfg


def _tokens(m, mb, t, seed):
    toks = np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (m * mb, t))
    return toks.astype(np.int32).reshape(m, mb, t)


def _jax_mesh(dp, pp):
    return jmesh.build_mesh(jmesh.MeshSpec(dp=dp, pp=pp), devices=jax.devices()[:dp * pp])


def _full_params(jparams):
    return tp.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def run_ranks(dp, pp, body):
    """``body(mesh)`` on every rank of a dp x pp mesh, one thread a rank;
    returns the results in rank order, re-raising the first rank's error."""
    meshes = in_process_meshes(MeshSpec(dp=dp, pp=pp), dp * pp, CPU, timeout_s=TIMEOUT_S)
    out: list = [None] * len(meshes)
    errors: list = []

    def run(mesh):
        try:
            out[mesh.rank] = body(mesh)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(e)
            for other in meshes:  # peers blocked on this rank fail at once
                other.close()

    threads = [threading.Thread(target=run, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * TIMEOUT_S)
    for m in meshes:
        m.close()
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    return out


def _named(tree, values=None):
    """``{name: tensor}`` over ``optim.tree_leaves(tree)`` (or ``values``
    in that order)."""
    import chip_smoke

    names = chip_smoke.leaf_names(tree)
    return dict(zip(names, optim.tree_leaves(tree) if values is None else values))


def _gather(results, dp, pp, key):
    """The full tree of ``key`` (params or grads) from dp index 0's
    stages, as ``tree_leaves`` of the stacked layout; every dp replica of
    a stage must hold the same values."""
    slices = []
    for s in range(pp):
        mine = [r for r in results if r["coords"]["pp"] == s]
        assert len(mine) == dp
        for other in mine[1:]:
            for name, v in other[key].items():
                assert torch.equal(v, mine[0][key][name]), (key, name)
        tree = {"stages": {}}
        for name, v in mine[0][key].items():
            if name.startswith("stages/"):
                tree["stages"][name.split("/", 1)[1]] = v
            else:
                tree[name] = v
        slices.append(tree)
    return optim.tree_leaves(tp.gather_params(slices))


def _rank_grads(tcfg, jparams, toks_mb, dp, pp):
    """Every rank's loss and gradients (``make_rank_grad``) on its slice of
    JAX's weights."""
    full = _full_params(jparams)

    def body(mesh):
        params = tp.stage_slice(full, tcfg, mesh.pp_rank)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, grads = tp.make_rank_grad(tcfg, mesh)(params, torch.from_numpy(toks_mb))
        return {"loss": loss.item(), "coords": mesh.coords, "grads": _named(params, grads),
                "held": set(params)}

    return run_ranks(dp, pp, body)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(1, 2), (1, 4), (2, 2)], ids=["pp2", "pp4", "dp2xpp2"])
def jax_mesh_grads(request):
    """The JAX pipeline's jitted loss and gradients on a mesh of the shape,
    with its weights (one compile a shape for the module)."""
    dp, pp = request.param
    jcfg, tcfg = _cfgs(pp, 2)
    jparams = jp.init_params(jax.random.PRNGKey(pp + 10 * dp), jcfg)
    value_and_grad = jax.jit(jax.value_and_grad(jp.make_loss_fn(jcfg, _jax_mesh(dp, pp))))
    return dp, pp, jparams, value_and_grad


def test_rank_loss_and_gradients_match_the_jax_mesh(jax_mesh_grads):
    dp, pp, jparams, value_and_grad = jax_mesh_grads
    _, tcfg = _cfgs(pp, 2)
    toks = _tokens(2, 2 * dp, 12, 7 + pp)
    jloss, jgrads = value_and_grad(jparams, jnp.asarray(toks))
    results = _rank_grads(tcfg, jparams, toks, dp, pp)
    assert all(r["loss"] == results[0]["loss"] for r in results)
    assert abs(results[0]["loss"] - float(jloss)) / float(jloss) <= REL
    got = _gather(results, dp, pp, "grads")
    want = optim.tree_leaves(jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jgrads))
    assert len(got) == len(want) == 3 + len(tp.STAGE_LEAVES)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) <= REL


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("dp, pp", [(1, 2), (1, 4), (2, 2)], ids=["pp2", "pp4", "dp2xpp2"])
def test_rank_loss_and_gradients_match_one_process(dp, pp, m):
    jcfg, tcfg = _cfgs(pp, m)
    jparams = jp.init_params(jax.random.PRNGKey(m), jcfg)
    toks = _tokens(m, 2 * dp, 10, 40 + m)
    results = _rank_grads(tcfg, jparams, toks, dp, pp)
    full = _full_params(jparams)
    leaves = optim.tree_leaves(full)
    for p in leaves:
        p.requires_grad_(True)
    loss = tp.make_loss_fn(tcfg)(full, torch.from_numpy(toks))
    want = torch.autograd.grad(loss, leaves)
    assert abs(results[0]["loss"] - loss.item()) / loss.item() <= ONE_PROCESS_REL
    for g, w in zip(_gather(results, dp, pp, "grads"), want):
        assert _rel(g.numpy(), w.numpy()) <= ONE_PROCESS_REL
    # embed on the first stage's ranks, final_norm and lm_head on the last's
    for r in results:
        s = r["coords"]["pp"]
        assert ("embed" in r["held"]) == (s == 0)
        assert ("lm_head" in r["held"]) == ("final_norm" in r["held"]) == (s == pp - 1)


def test_each_rank_runs_its_stage_once_a_microbatch():
    """A rank calls the attention ``L/S × M`` times a step (bubbles
    skipped), on its ``mb / dp`` rows."""
    calls = []
    lock = threading.Lock()

    def counting(q, k, v, cfg, *, q_offset=None):
        with lock:
            calls.append(q.shape[0])
        return tl._attention(q, k, v, cfg, q_offset=q_offset)

    jcfg, tcfg = _cfgs(2, 3)
    full = _full_params(jp.init_params(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(_tokens(3, 4, 8, 3))

    def body(mesh):
        params = optim.tree_map(lambda t: t.clone().requires_grad_(),
                                tp.stage_slice(full, tcfg, mesh.pp_rank))
        tp.make_rank_grad(tcfg, mesh, attention=counting)(params, toks)

    run_ranks(2, 2, body)
    assert calls == [2] * (4 * 2 * 3)  # 4 ranks x 2 layers x 3 microbatches, 2 rows each


# ---------------------------------------------------------------------------
# params: the stage slices, their draw and their gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp, pp", [(1, 2), (2, 2), (1, 4)])
def test_init_params_mesh_draws_the_slices_of_the_full_draw(dp, pp):
    _, tcfg = _cfgs(pp, 2, torch.bfloat16)
    full = tp.init_params(tcfg, generator=torch.Generator().manual_seed(5), device=CPU)

    def body(mesh):
        return mesh.coords, tp.init_params(tcfg, generator=torch.Generator().manual_seed(5),
                                           device=CPU, mesh=mesh)

    got = run_ranks(dp, pp, body)
    for coords, params in got:
        want = tp.stage_slice(full, tcfg, coords["pp"])
        assert set(params) == set(want) and set(params["stages"]) == set(tp.STAGE_LEAVES)
        for a, b in zip(optim.tree_leaves(params), optim.tree_leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
            assert torch.equal(a, b)
    slices = [p for c, p in got if c["dp"] == 0]
    for a, b in zip(optim.tree_leaves(tp.gather_params(slices)), optim.tree_leaves(full)):
        assert torch.equal(a, b)


def test_stage_slice_is_the_reference_param_spec():
    """``stage_slice`` cuts every stage leaf on its leading axis, as
    ``param_specs``' ``P('pp', ...)`` shards it over the JAX mesh."""
    jcfg, tcfg = _cfgs(4, 2)
    jparams = jp.init_params(jax.random.PRNGKey(1), jcfg)
    specs = jp.param_specs(jcfg)
    full = _full_params(jparams)
    for stage in range(4):
        part = tp.stage_slice(full, tcfg, stage)
        for name in tp.STAGE_LEAVES:
            assert specs["stages"][name][0] == "pp"
            want = np.asarray(jparams["stages"][name])[stage:stage + 1]
            assert np.array_equal(part["stages"][name].numpy(), want)
    assert all(specs[k] == jax.sharding.PartitionSpec() for k in ("embed", "final_norm",
                                                                  "lm_head"))


def test_a_mesh_of_other_stages_is_refused():
    _, tcfg = _cfgs(4, 2)

    def body(mesh):
        with pytest.raises(ValueError, match="mesh pp 2 != the pipeline's 4 stages"):
            tp.make_train_step(tcfg, device=CPU, mesh=mesh)[0](0)
        with pytest.raises(ValueError, match="do not split over dp 2"):
            mesh.dp_rows(torch.zeros(2, 3, 4), 1)
        return True

    assert run_ranks(2, 2, body) == [True] * 4


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_rank_train_step_matches_jax(dtype):
    dp, pp, m = 2, 2, 2
    jcfg, tcfg = _cfgs(pp, m, dtype)
    jinit, jstep = jp.make_train_step(jcfg, _jax_mesh(dp, pp))
    jparams, jstate = jinit(jax.random.PRNGKey(0))
    full = _full_params(jparams)  # copied before the donating JAX step
    n_steps = 3 if dtype == torch.float32 else 1
    batches = [_tokens(m, 2 * dp, 12, 20 + i) for i in range(n_steps)]
    jlosses = []
    for toks in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        jlosses.append(float(jloss))

    def body(mesh):
        _, step = tp.make_train_step(tcfg, device=CPU, mesh=mesh)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(),
                                tp.stage_slice(full, tcfg, mesh.pp_rank))
        state = optim.adamw_init(params)
        losses = [step(params, state, torch.from_numpy(toks))[2].float().item()
                  for toks in batches]
        assert int(state["count"]) == n_steps
        return {"coords": mesh.coords, "losses": losses,
                "params": _named(optim.tree_map(torch.Tensor.detach, params))}

    results = run_ranks(dp, pp, body)
    for got, want in zip(results[0]["losses"], jlosses):
        assert abs(got - want) / want <= STEP_LOSS_REL[dtype]
    want_leaves = optim.tree_leaves(jax.tree.map(
        lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))), jparams))
    for got, want in zip(_gather(results, dp, pp, "params"), want_leaves):
        got = got.float()
        diff = (got - want).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= PARAM_ATOL_FP32
        else:
            bound = BF16_FLIP + BF16_ULP * torch.maximum(got.abs(), want.abs())
            assert bool((diff <= bound).all()), (diff / bound).max().item()


def test_one_rank_mesh_is_the_one_process_step():
    """A mesh of one rank (or none) gives the one-process step, bit for
    bit."""
    _, tcfg = _cfgs(1, 2)
    toks = torch.from_numpy(_tokens(2, 2, 8, 1))

    def body(mesh):
        out = []
        for mesh_arg in (None, mesh):
            init, step = tp.make_train_step(tcfg, device=CPU, mesh=mesh_arg)
            params, state = init(3)
            out.append((step(params, state, toks)[2], optim.tree_leaves(params)))
        return out

    (a, pa), (b, pb) = run_ranks(1, 1, body)[0]
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(pa, pb))
