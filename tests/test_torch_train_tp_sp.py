"""Tensor- and sequence-parallel Llama training on the CPU: the rank mesh's
tp and sp lines (``cordum_tpu_torch/parallel/mesh.py`` ``TrainMesh``), the
autograd collectives (``parallel/collectives.py``) and the rank program of
``models/llama.py`` (``forward``/``loss_fn``/``make_train_step`` with a
mesh), against the JAX package's ``build_mesh`` and ``make_train_step``
over a dp × tp × sp mesh and against the port's one-process step; then
``chip_smoke.py``'s phase 12.7 rehearsed, with the faults its gates
refuse.

Ranks are threads over in-process gloo groups (``in_process_meshes``); the
Llama config is ``LlamaConfig.tiny()``'s widths, tokens come from numpy with
a seed, JAX weights cross by ``params_from_jax``.  Tolerances, fp32 unless
said:

* against JAX's mesh step at dp 2 × tp 2 × sp 2 (the reference's own
  multi-chip dry run, B 4, T 16): ``test_dp_train_step_matches_jax``'s
  gates, each loss within 1e-4 (fp32) and 2e-2 (bf16) relative, every
  param after 3 fp32 steps within 6 lr and after 1 bf16 step within ``2 lr
  (1 + 2^-5) + 2^-7 |x|``;
* against the port's one-process step: the loss within 1e-6 relative and
  every gradient within 1e-5 of its largest ``|value|`` — tp sums each
  layer's products over ranks (partial sums, then the all-reduce), and sp
  sums every key's gradient over the chunks' queries, in other orders than
  one process (1.2e-6 at most, measured);
* the collectives against one rank's ``autograd.grad``: 1e-6 of the
  largest ``|value|`` (the same sums, in another order).
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cordum_tpu.models import llama as jl
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.parallel import collectives as coll
from cordum_tpu_torch.parallel import mesh as tm
from cordum_tpu_torch.parallel.mesh import MeshSpec, in_process_meshes

from .test_torch_train_mesh import (BF16_FLIP, BF16_ULP, PARAM_ATOL_FP32, STEP_LOSS_REL,
                                    _cfgs, _rebuild, _rel, _tokens)

CPU = torch.device("cpu")
TIMEOUT_S = 60.0
ONE_PROCESS_LOSS_REL = 1e-6
ONE_PROCESS_GRAD_REL = 1e-5
COLLECTIVE_REL = 1e-6


def run_mesh(dp, tp, sp, body):
    """``body(mesh)`` on every rank of a dp × tp × sp mesh, one thread a
    rank; the results in rank order, the first rank's error re-raised."""
    world = dp * tp * sp
    meshes = in_process_meshes(MeshSpec(dp=dp, tp=tp, sp=sp), world, CPU, timeout_s=TIMEOUT_S)
    out: list = [None] * world
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


# ---------------------------------------------------------------------------
# the mesh's tp and sp lines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp, tp, sp", [(1, 2, 1), (1, 1, 2), (1, 2, 2), (2, 1, 2),
                                        (2, 2, 2)])
def test_mesh_with_tp_and_sp_is_the_reference_grid(dp, tp, sp):
    """Rank r sits where device r sits in ``build_mesh``'s grid; its tp and
    sp lines are the grid's lines through it, and the groups sum over
    exactly those ranks (the meshes ``LATER_AXES`` refused before)."""
    n = dp * tp * sp
    grid = np.vectorize(lambda d: d.id)(
        jmesh.build_mesh(jmesh.MeshSpec(dp=dp, tp=tp, sp=sp), devices=jax.devices()[:n]).devices)
    assert grid.shape == (dp, tp, sp, 1, 1)
    sizes = MeshSpec(dp=dp, tp=tp, sp=sp).resolve(n)

    def body(mesh):
        sums = {}
        for over in ("dp", "tp", "sp"):
            sums[over] = int(mesh.all_reduce(torch.tensor([2.0 ** mesh.rank]), over).item())
        return mesh.coords, sums

    for r, (coords, sums) in enumerate(run_mesh(dp, tp, sp, body)):
        d, t, s = (int(i) for i in np.argwhere(grid == r)[0][:3])
        assert (coords["dp"], coords["tp"], coords["sp"]) == (d, t, s)
        assert tm.line_ranks(sizes, r, "tp") == grid[d, :, s, 0, 0].tolist()
        assert tm.line_ranks(sizes, r, "sp") == grid[d, t, :, 0, 0].tolist()
        assert sums["tp"] == sum(2 ** int(x) for x in grid[d, :, s, 0, 0])
        assert sums["sp"] == sum(2 ** int(x) for x in grid[d, t, :, 0, 0])
        assert sums["dp"] == sum(2 ** int(x) for x in grid[:, t, s, 0, 0])


def test_all_gather_and_reduce_scatter_along_a_line():
    """Over tp 2 × sp 2: an all-gather joins the line's tensors in the
    order of their coordinates; a reduce-scatter sums the line and keeps
    the rank's block; both counted."""
    def body(mesh):
        x = torch.full((2, 3), float(mesh.rank))
        gathered = mesh.all_gather(x, "sp", 1)
        y = torch.arange(8.0).reshape(2, 4) * (mesh.rank + 1)
        scattered = mesh.reduce_scatter(y, "tp", 1)
        return gathered, scattered, dict(mesh.calls)

    sizes = MeshSpec(tp=2, sp=2).resolve(4)
    for r, (gathered, scattered, calls) in enumerate(run_mesh(1, 2, 2, body)):
        sp_line = tm.line_ranks(sizes, r, "sp")
        assert torch.equal(gathered, torch.cat([torch.full((2, 3), float(x)) for x in sp_line], 1))
        tp_line = tm.line_ranks(sizes, r, "tp")
        total = sum(torch.arange(8.0).reshape(2, 4) * (x + 1) for x in tp_line)
        i = tm.mesh_coords(sizes, r)["tp"]
        assert torch.equal(scattered, total[:, 2 * i:2 * i + 2])
        assert calls["all_gather"] == 1 and calls["reduce_scatter"] == 1


def test_reduce_scatter_refuses_a_dimension_the_line_does_not_split():
    def body(mesh):
        with pytest.raises(ValueError, match="does not split over sp 2"):
            mesh.reduce_scatter(torch.ones(3, 3), "sp", 0)
        return True

    assert run_mesh(1, 1, 2, body) == [True, True]


# ---------------------------------------------------------------------------
# the autograd collectives
# ---------------------------------------------------------------------------


def test_gather_seq_gradient_matches_one_rank():
    """Each sp rank's chunk gathered to the whole sequence and weighted by
    the rank's own weights: the chunk's gradient is its block of the
    one-rank gradient of the summed losses (the reduce-scatter)."""
    sp = 4
    rng = np.random.default_rng(0)
    chunks = [torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))
              for _ in range(sp)]
    weights = [torch.from_numpy(rng.standard_normal((2, 3 * sp, 5)).astype(np.float32))
               for _ in range(sp)]
    whole = torch.cat(chunks, 1).requires_grad_()
    want = torch.autograd.grad(sum((w * whole).sum() for w in weights), whole)[0]

    def body(mesh):
        x = chunks[mesh.sp_rank].clone().requires_grad_()
        y = coll.gather_seq(x, mesh)
        assert torch.equal(y.detach(), whole.detach())
        return mesh.sp_rank, torch.autograd.grad((weights[mesh.sp_rank] * y).sum(), x)[0]

    for r, g in run_mesh(1, 1, sp, body):
        assert _rel(g.numpy(), want[:, 3 * r:3 * r + 3].numpy()) <= COLLECTIVE_REL


def test_tp_collectives_gradients_match_one_rank():
    """A column-parallel product then a row-parallel one over tp 2
    (``copy_to_tp`` before, ``reduce_from_tp`` after): the output equals
    one rank's, the input's gradient is whole and equal on both ranks, and
    each weight slice's gradient is the slice of one rank's."""
    tp = 2
    rng = np.random.default_rng(1)
    x0, w1, w2, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((4, 6), (6, 8), (8, 6), (4, 6)))
    leaves = [t.clone().requires_grad_() for t in (x0, w1, w2)]
    out = torch.relu(leaves[0] @ leaves[1]) @ leaves[2]
    want = torch.autograd.grad((out * c).sum(), leaves)

    def body(mesh):
        i = mesh.tp_rank
        x = x0.clone().requires_grad_()
        a = w1[:, 4 * i:4 * i + 4].clone().requires_grad_()
        b = w2[4 * i:4 * i + 4].clone().requires_grad_()
        y = coll.reduce_from_tp(torch.relu(coll.copy_to_tp(x, mesh) @ a) @ b, mesh)
        return i, y.detach(), torch.autograd.grad((y * c).sum(), (x, a, b))

    for i, y, (gx, ga, gb) in run_mesh(1, tp, 1, body):
        assert _rel(y.numpy(), out.detach().numpy()) <= COLLECTIVE_REL
        assert _rel(gx.numpy(), want[0].numpy()) <= COLLECTIVE_REL
        assert _rel(ga.numpy(), want[1][:, 4 * i:4 * i + 4].numpy()) <= COLLECTIVE_REL
        assert _rel(gb.numpy(), want[2][4 * i:4 * i + 4].numpy()) <= COLLECTIVE_REL


def test_collectives_are_the_identity_without_a_line():
    x = torch.ones(2, 3, requires_grad=True)
    for fn in (coll.copy_to_tp, coll.reduce_from_tp, coll.gather_seq):
        assert fn(x, None) is x

    def body(mesh):  # a dp mesh: no tp or sp line
        return all(fn(x, mesh) is x for fn in (coll.copy_to_tp, coll.reduce_from_tp,
                                               coll.gather_seq))

    assert run_mesh(2, 1, 1, body) == [True, True]


# ---------------------------------------------------------------------------
# the rank program against one process
# ---------------------------------------------------------------------------


def _one_process(tcfg, params, toks):
    leaves = [p.clone().requires_grad_() for p in optim.tree_leaves(params)]
    loss = tl.loss_fn(_rebuild(params, iter(leaves)), torch.from_numpy(toks), tcfg)
    return loss.item(), _rebuild(params, iter(torch.autograd.grad(loss, leaves)))


def _mesh_grads(tcfg, params, toks, dp, tp, sp):
    def body(mesh):
        mine = optim.tree_map(lambda t: t.clone().requires_grad_(),
                              tl.shard_params(params, tcfg, mesh.tp_rank, mesh.tp))
        loss, grads = tl.make_mesh_grad(tcfg, mesh)(mine, torch.from_numpy(toks))
        return mesh.tp_rank, loss.item(), grads

    return run_mesh(dp, tp, sp, body)


@pytest.mark.parametrize("dp, tp, sp", [(1, 2, 1), (1, 1, 2), (1, 1, 4), (1, 2, 2),
                                        (2, 2, 2)])
def test_tp_sp_loss_and_gradients_match_one_process(dp, tp, sp):
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, generator=torch.Generator().manual_seed(tp + sp), device=CPU)
    toks = _tokens(4, 16, 10 * tp + sp)
    want_loss, want = _one_process(tcfg, params, toks)
    results = _mesh_grads(tcfg, params, toks, dp, tp, sp)
    for tp_rank, loss, grads in results:
        assert loss == results[0][1]  # every rank returns the global loss
        assert abs(loss - want_loss) / want_loss <= ONE_PROCESS_LOSS_REL
        mine = optim.tree_leaves(tl.shard_params(want, tcfg, tp_rank, tp))
        for g, w in zip(grads, mine):
            assert g.shape == w.shape
            assert _rel(g.numpy(), w.numpy()) <= ONE_PROCESS_GRAD_REL


def test_loss_is_the_global_mean_not_a_mean_of_chunk_means():
    """sp 2 over T 16: the first chunk has 8 targets, the last 7 (its last
    position has none).  The rank shares (each chunk's nll sum over B ×
    (T - 1)) sum to the one-process mean; the mean of the two chunks'
    means does not, by far more than the tolerance."""
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, generator=torch.Generator().manual_seed(3), device=CPU)
    toks = _tokens(4, 16, 3)
    with torch.no_grad():
        logits = tl.forward(params, torch.from_numpy(toks), tcfg)[:, :-1].float()
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), torch.from_numpy(toks[:, 1:]).reshape(-1).long(),
            reduction="none").reshape(4, 15)
    want = nll.mean().item()
    chunk_means = (nll[:, :8].mean().item() + nll[:, 8:].mean().item()) / 2

    def body(mesh):
        with torch.no_grad():
            return tl.loss_fn(params, torch.from_numpy(toks), tcfg, mesh=mesh).item()

    shares = run_mesh(1, 1, 2, body)
    assert abs(sum(shares) - want) / want <= ONE_PROCESS_LOSS_REL
    assert abs(shares[1] - nll[:, 8:].sum().item() / 60) <= 1e-6 * want
    assert abs(chunk_means - want) / want > 100 * ONE_PROCESS_LOSS_REL


def test_forward_chunk_logits_are_the_rows_of_the_whole():
    """A tp 2 × sp 2 rank's ``forward`` on its chunk (global positions by
    default) gives the rows of the one-process logits at those positions."""
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, generator=torch.Generator().manual_seed(4), device=CPU)
    toks = torch.from_numpy(_tokens(2, 16, 4))
    with torch.no_grad():
        want = tl.forward(params, toks, tcfg)

    def body(mesh):
        start, n = mesh.sp_span(16)
        mine = tl.shard_params(params, tcfg, mesh.tp_rank, mesh.tp)
        with torch.no_grad():
            return start, n, tl.forward(mine, toks[:, start:start + n], tcfg, mesh=mesh)

    for start, n, got in run_mesh(1, 2, 2, body):
        assert _rel(got.numpy(), want[:, start:start + n].numpy()) <= ONE_PROCESS_GRAD_REL


def test_ring_attention_over_sp_is_refused_naming_a10():
    """The refusal this test once held (ring attention not ported, ROADMAP
    A10) is gone: a ring mesh at tp 2 × sp 2 builds its step and takes
    one, every rank with the same finite loss, which equals the all-gather
    flavour's (``tests/test_torch_ring_attention.py`` holds the ring to
    the JAX package's)."""
    _, tcfg = _cfgs()
    ring = tl.LlamaConfig(**{**tcfg.__dict__, "use_ring_attention": True})
    toks = torch.from_numpy(_tokens(4, 16, 8))

    def body(cfg):
        def run(mesh):
            init, step = tl.make_train_step(cfg, device=CPU, mesh=mesh)
            params, state = init(3)
            return step(params, state, toks)[2].item()
        return run

    losses = run_mesh(1, 2, 2, body(ring))
    assert len(set(losses)) == 1 and np.isfinite(losses[0])
    gather = run_mesh(1, 2, 2, body(tcfg))
    assert abs(losses[0] - gather[0]) / gather[0] <= ONE_PROCESS_LOSS_REL


def test_tp_that_does_not_split_the_heads_is_refused():
    _, tcfg = _cfgs()  # 2 KV heads

    def body(mesh):
        with pytest.raises(ValueError, match="tp=4 does not divide"):
            tl.make_train_step(tcfg, device=CPU, mesh=mesh)
        return True

    assert run_mesh(1, 4, 1, body) == [True] * 4


def test_every_causal_call_with_positions_reaches_dense_attention(monkeypatch):
    """The sp rank's attention (queries a chunk, keys the gathered whole)
    goes through ``dense_attention`` like the one-process call: on the card
    it is B9 or a raise, never the plain einsum."""
    calls = []
    real = tl.dense_attention

    def counting(q, k, v, positions):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, positions)

    monkeypatch.setattr(tl, "dense_attention", counting)
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, generator=torch.Generator().manual_seed(5), device=CPU)
    toks = torch.from_numpy(_tokens(2, 16, 5))

    def body(mesh):
        start, n = mesh.sp_span(16)
        with torch.no_grad():
            tl.forward(params, toks[:, start:start + n], tcfg, mesh=mesh)
        return True

    run_mesh(1, 1, 2, body)
    assert sorted(calls) == [(8, 16)] * (2 * tcfg.n_layers)


# ---------------------------------------------------------------------------
# against the JAX package's mesh step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dp_tp_sp_train_step_matches_jax(dtype):
    """8 gloo ranks at dp 2 × tp 2 × sp 2 against ``make_train_step`` on
    ``build_mesh(MeshSpec(dp=2, tp=2, sp=2))`` over 8 CPU devices, the
    reference's multi-chip dry run, at B 4, T 16."""
    jcfg, tcfg = _cfgs(dtype)
    jinit, jstep = jl.make_train_step(
        jcfg, jmesh.build_mesh(jmesh.MeshSpec(dp=2, tp=2, sp=2), devices=jax.devices()[:8]))
    jparams, jstate = jinit(jax.random.PRNGKey(7))
    full = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    n_steps = 3 if dtype == torch.float32 else 1
    batches = [_tokens(4, 16, 30 + i) for i in range(n_steps)]
    jlosses = []
    for toks in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        jlosses.append(float(jloss))
    want = tl.params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
                              device=CPU)

    def body(mesh):
        _, step = tl.make_train_step(tcfg, device=CPU, mesh=mesh)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(),
                                tl.shard_params(full, tcfg, mesh.tp_rank, mesh.tp))
        state = optim.adamw_init(params)
        losses = [step(params, state, torch.from_numpy(t))[2].float().item() for t in batches]
        return mesh.tp_rank, losses, [p.detach() for p in optim.tree_leaves(params)]

    results = run_mesh(2, 2, 2, body)
    for tp_rank, losses, leaves in results:
        assert losses == results[0][1]
        for got, w in zip(losses, jlosses):
            assert abs(got - w) / w <= STEP_LOSS_REL[dtype]
        for got, w in zip(leaves, optim.tree_leaves(tl.shard_params(want, tcfg, tp_rank, 2))):
            diff = (got.float() - w).abs()
            if dtype == torch.float32:
                assert diff.max().item() <= PARAM_ATOL_FP32
            else:
                bound = BF16_FLIP + BF16_ULP * torch.maximum(got.float().abs(), w.abs())
                assert bool((diff <= bound).all()), (diff / bound).max().item()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12.7 on the CPU, and the faults its gates refuse
# ---------------------------------------------------------------------------


def _rehearse(tmp_path, monkeypatch, *, tp=2, sp=2):
    """12.7's leg with the ranks as threads (tiny widths, 2 layers, B 4, T
    16, 2 steps): the one-process oracle, every rank's
    :func:`chip_smoke.train_rank`, then its gates; the CPU counts no kernel
    launch, so each rank's launches (all of them a chunk's where sp > 1)
    are set to what its layers and steps give."""
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    job = chip_smoke.mesh_job("llama", 1, 1, tp=tp, sp=sp, widths="tiny", layers=2,
                              dtype="float32", batch=4, seq=16, steps=2, device="cpu")
    chip_smoke.mesh_oracle(torch, CPU, "cpu", job, str(tmp_path))
    docs = run_mesh(1, tp, sp, lambda mesh: chip_smoke.train_rank(job, mesh.rank, mesh=mesh))
    for d in docs:
        d["launches"] = [2 * 2] * 2
        d["chunk_launches"] = [2 * 2 if sp > 1 else 0] * 2
    return chip_smoke.check_mesh_ranks("cpu", job, docs, collective="gloo", falling=True)


def test_chip_smoke_tp_sp_gates_pass_on_the_cpu(tmp_path, monkeypatch):
    assert _rehearse(tmp_path, monkeypatch) == [4 * 4] * 2


def test_chip_smoke_gate_refuses_sp_gradients_meaned(tmp_path, monkeypatch):
    """The gradients averaged over sp where each chunk's share must be
    summed: half the gradient."""
    real = tl._mesh_sum

    def meaned(value, grads, mesh):
        value, grads = real(value, grads, mesh)
        for g in grads:
            g.div_(mesh.sp)
        return value, grads

    monkeypatch.setattr(tl, "_mesh_sum", meaned)
    with pytest.raises(AssertionError, match=r"worst gradient \[0\.[4-9]"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_a_missing_reduce_scatter(tmp_path, monkeypatch):
    """K and V's gradients cut to the rank's chunk without the sum over sp:
    a key loses what every later chunk's queries send it."""
    def cut(ctx, g):
        n = g.shape[ctx.dim] // ctx.mesh.sp
        return g.narrow(ctx.dim, ctx.mesh.sp_rank * n, n).contiguous(), None, None

    monkeypatch.setattr(coll._GatherSeq, "backward", staticmethod(cut))
    with pytest.raises(AssertionError, match=r"worst gradient \[(0\.[1-9]|[1-9])"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_gradients_reduced_over_tp(tmp_path, monkeypatch):
    """The gradients also summed over tp: the replicated leaves' doubled,
    each slice's added to another rank's."""
    real = tl._mesh_sum

    def over_tp(value, grads, mesh):
        value, grads = real(value, grads, mesh)
        for g in grads:
            mesh.all_reduce(g, "tp")
        return value, grads

    monkeypatch.setattr(tl, "_mesh_sum", over_tp)
    with pytest.raises(AssertionError, match=r"worst gradient \[([1-9]|0\.[5-9])"):
        _rehearse(tmp_path, monkeypatch)
