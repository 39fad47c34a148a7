"""Expert-parallel MoE training on the CPU: the rank mesh's ep line and tp ×
ep plane (``cordum_tpu_torch/parallel/mesh.py``), the expert plane's
operators and the dp line's exchange of counts
(``parallel/collectives.py``), B7's route with a room
(``ops/moe_dispatch.py``: its plain version, and the kernels' algorithm
emulated in numpy) and the MoE family over dp × tp × ep
(``models/moe.py`` with a mesh), against the JAX package's
``build_mesh`` and ``moe.make_train_step`` over ``MeshSpec(dp=2, tp=2,
ep=2)`` and against the port's one-process layer and step.

Ranks are threads over in-process gloo groups (``in_process_meshes``).
The config is ``MoEConfig.tiny()``'s widths in fp32 (E 4, top 2) at
capacity factor 0.5, and the inputs are pushed toward expert 0, so every
parity case drops tokens (checked): with no drops, routing each dp rank's
rows alone would agree with the reference's global routing.  Tolerances:

* against the one-process layer and step: the loss (and the layer's
  output and aux loss) within 1e-6 relative, each gradient within 1e-4
  of its largest ``|value|`` (``chip_smoke.MESH_LOSS_REL`` and
  ``MESH_GRAD_REL``: the tokens' sums split over dp and the experts'
  partial outputs summed over the plane run in other orders);
* against JAX's mesh step: ``tests/test_torch_moe.py``'s, each loss within
  1e-5 relative and every param within 6 lr after three AdamW steps;
* the routes: equal (integers).
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
from cordum_tpu.models import moe as jm
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import moe as tm
from cordum_tpu_torch.ops import moe_dispatch as md
from cordum_tpu_torch.parallel import collectives as coll
from cordum_tpu_torch.parallel import mesh as tmesh
from cordum_tpu_torch.parallel.mesh import MeshSpec, in_process_meshes

from .test_torch_moe import (BASE_KW, PARAM_ATOL, REL, _assert_route_equal, _emulate_route,
                             _jax_leaves, _probs)
from .test_torch_train_mesh import _rebuild

CPU = torch.device("cpu")
TIMEOUT_S = 60.0
LOSS_REL = chip_smoke.MESH_LOSS_REL
GRAD_REL = chip_smoke.MESH_GRAD_REL
CF = 0.5
MESHES = [(2, 1, 2), (1, 2, 2), (1, 1, 4), (2, 2, 2)]


def run_mesh(dp, tp, ep, body, *, sp=1):
    """``body(mesh)`` on every rank of a dp × tp × sp × ep mesh, one thread a
    rank; the results in rank order, the first rank's error re-raised."""
    world = dp * tp * sp * ep
    meshes = in_process_meshes(MeshSpec(dp=dp, tp=tp, sp=sp, ep=ep), world, CPU,
                               timeout_s=TIMEOUT_S)
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


def _cfg(n_experts=4, cf=CF, d_expert=0):
    base = tl.LlamaConfig(dtype=torch.float32, **BASE_KW)
    return tm.MoEConfig(base=base, n_experts=n_experts, top_k=2, capacity_factor=cf,
                        d_expert=d_expert)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-30)).item()


def _shard(mesh):
    return mesh.coords, mesh.sizes


# ---------------------------------------------------------------------------
# the mesh's ep line and tp × ep plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp, tp, ep", [(1, 1, 2), (2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4)])
def test_mesh_with_ep_is_the_reference_grid(dp, tp, ep):
    """Rank r sits where device r sits in ``build_mesh``'s grid; its ep
    line and its tp × ep plane are the grid's through it, and the groups
    sum over exactly those ranks (the plane is the ep line's own group
    where tp is 1)."""
    n = dp * tp * ep
    grid = np.vectorize(lambda d: d.id)(
        jmesh.build_mesh(jmesh.MeshSpec(dp=dp, tp=tp, ep=ep), devices=jax.devices()[:n]).devices)
    assert grid.shape == (dp, tp, 1, ep, 1)
    sizes = MeshSpec(dp=dp, tp=tp, ep=ep).resolve(n)

    def body(mesh):
        sums = {over: int(mesh.all_reduce(torch.tensor([2.0 ** mesh.rank]), over).item())
                for over in ("dp", "ep", tmesh.EXPERT_PLANE)}
        same = mesh.groups[tmesh.EXPERT_PLANE] is mesh.groups["ep"]
        return mesh.coords, sums, same

    for r, (coords, sums, same) in enumerate(run_mesh(dp, tp, ep, body)):
        d, t, _, e, _ = (int(i) for i in np.argwhere(grid == r)[0])
        assert (coords["dp"], coords["tp"], coords["ep"]) == (d, t, e)
        assert tmesh.line_ranks(sizes, r, "ep") == grid[d, t, 0, :, 0].tolist()
        plane = sorted(grid[d, :, 0, :, 0].flatten().tolist())
        assert tmesh.plane_ranks(sizes, r, ("tp", "ep")) == plane
        assert sums["ep"] == sum(2 ** int(x) for x in grid[d, t, 0, :, 0])
        assert sums[tmesh.EXPERT_PLANE] == sum(2 ** int(x) for x in plane)
        assert sums["dp"] == sum(2 ** int(x) for x in grid[:, t, 0, e, 0])
        assert same == (tp == 1)


def test_exchange_counts_gives_the_lower_ranks_prefix_and_the_total():
    """dp 3: rank r's counts ``[r + 1, 10 r, 7]``; the prefix is the sum of
    the lower ranks', the total every rank's, both int32; one all-gather a
    call; without a dp line, zeros and the counts."""
    def body(mesh):
        counts = torch.tensor([mesh.dp_rank + 1, 10 * mesh.dp_rank, 7], dtype=torch.int32)
        prefix, total = coll.exchange_counts(counts, mesh)
        return mesh.dp_rank, prefix, total, mesh.calls["all_gather"]

    for r, prefix, total, calls in run_mesh(3, 1, 1, body):
        assert prefix.dtype == total.dtype == torch.int32 and calls == 1
        assert prefix.tolist() == [sum(i + 1 for i in range(r)), sum(10 * i for i in range(r)),
                                   7 * r]
        assert total.tolist() == [6, 30, 21]
    counts = torch.tensor([3, 4], dtype=torch.int32)
    prefix, total = coll.exchange_counts(counts, None)
    assert prefix.tolist() == [0, 0] and total is counts


def test_expert_plane_operators_match_one_rank():
    """Over tp 2 × ep 2: ``copy_to_expert_plane`` is the identity forward
    and sums its gradient over the four ranks; ``reduce_from_expert_plane``
    sums forward (a new tensor) and passes the gradient through; both the
    identity (no autograd node) without a plane."""
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    c = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(4)]

    def body(mesh):
        x = x0.clone().requires_grad_()
        y = coll.copy_to_expert_plane(x, mesh)
        (g,) = torch.autograd.grad((y * c[mesh.rank]).sum(), x)
        z = x0.clone().requires_grad_()
        s = coll.reduce_from_expert_plane(z * (mesh.rank + 1), mesh)
        (gz,) = torch.autograd.grad(s.sum(), z)
        return mesh.rank, g, s.detach(), gz

    for r, g, s, gz in run_mesh(1, 2, 2, body):
        assert torch.allclose(g, sum(c), atol=1e-6)
        assert torch.allclose(s, x0 * 10, atol=1e-6)
        assert torch.equal(gz, torch.full_like(x0, float(r + 1)))
    x = torch.ones(2, requires_grad=True)
    assert coll.copy_to_expert_plane(x, None) is x and coll.reduce_from_expert_plane(x, None) is x


# ---------------------------------------------------------------------------
# B7's route with a room
# ---------------------------------------------------------------------------


def _skewed_probs(n, e, seed, kind):
    """``kind`` "random" and "ties": :func:`_probs` (ties planted); "drop":
    three quarters of the tokens pushed to expert 0."""
    probs = _probs(n, e, seed)
    if kind == "drop":
        logits = np.log(np.maximum(probs, 1e-30))
        logits[: 3 * n // 4, 0] += 30.0
        probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return probs


@pytest.mark.parametrize("kind", ["random", "drop", "ties"])
@pytest.mark.parametrize("dp", [2, 3, 4])
def test_plain_route_with_room_is_the_whole_batch_route(dp, kind):
    """The whole batch routed at once (the reference under ``jit``)
    against each dp rank routing its rows with the room its lower ranks
    leave: the ranks' experts, keeps and positions plus their prefix,
    concatenated, are the whole route's, and each rank's kept rows hold
    the whole route's tokens at ``prefix + row``; the room function is
    handed the rank's counts."""
    n_rank, e, k = 24, 4, 2
    probs = torch.from_numpy(_skewed_probs(n_rank * dp, e, seed=dp, kind=kind))
    cap = max(1, int(CF * n_rank * dp * k / e))
    whole = md.moe_route_reference(probs, k, cap)
    assert not whole.keep.all()
    prefix = torch.zeros(e, dtype=torch.int32)
    for r in range(dp):
        rows = probs[r * n_rank:(r + 1) * n_rank]
        room = torch.clamp_min(cap - prefix, 0).to(torch.int32)
        seen = []
        route = md.moe_route_reference(rows, k, cap, lambda c: seen.append(c) or room)
        assert torch.equal(seen[0], route.counts) and torch.equal(route.room, room)
        cut = slice(r * n_rank, (r + 1) * n_rank)
        assert torch.equal(route.idx, whole.idx[cut]) and torch.equal(route.keep, whole.keep[cut])
        assert torch.equal(route.pos + prefix[route.idx.long()], whole.pos[cut])
        for x in range(e):
            mine = int(min(route.counts[x], room[x]))
            assert (route.slot_token[x, mine:] == -1).all()
            assert torch.equal(route.slot_token[x, :mine] + r * n_rank,
                               whole.slot_token[x, prefix[x]:prefix[x] + mine])
            assert torch.equal(route.slot_k[x, :mine],
                               whole.slot_k[x, prefix[x]:prefix[x] + mine])
        prefix = prefix + route.counts


@pytest.mark.parametrize("tile", [1, 3, 5, 1024])
@pytest.mark.parametrize("room", [[0, 5, 30, 2], [30, 30, 30, 30], [7, 0, 0, 40], [1, 2, 3, 4]])
def test_route_kernel_algorithm_with_room_matches_reference(tile, room):
    """The kernels' two launches emulated with a room (rooms of 0, rooms
    the capacity, a room past it, which the place kernel clips to C): the
    same route as the plain version."""
    probs = _probs(50, 4, seed=tile)
    probs[:30, 0] += 1.0  # most of the tokens' first pick: expert 0
    room_t = torch.tensor(room, dtype=torch.int32)
    want = md.moe_route_reference(torch.from_numpy(probs), 2, 30, lambda counts: room_t)
    _assert_route_equal(_emulate_route(probs, 2, 30, tile, warp=3, room=room), want)
    assert want.keep.sum() < 100


def test_local_experts_view_splits_the_dispatch_and_combine():
    """An ep 2 line's views of one route (experts 0-1 and 2-3): each view's
    dispatch is its experts' rows of the whole dispatch, the other pairs'
    idx out of its range (negative on rank 1); the two combines of the
    views' rows sum to the whole combine, and so do their ``d_w``."""
    rng = np.random.default_rng(3)
    probs = torch.from_numpy(_skewed_probs(40, 4, seed=3, kind="drop"))
    room = torch.tensor([3, 14, 0, 9], dtype=torch.int32)
    route = md.moe_route_reference(probs, 2, 14, lambda counts: room)
    tokens = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    out = torch.from_numpy(rng.standard_normal((4, 14, 8)).astype(np.float32))
    w = torch.gather(probs, 1, route.idx.long()).float().requires_grad_()
    whole_in = md.moe_dispatch(tokens, route)
    whole_y = md.moe_combine(out, w, route)
    (whole_dw,) = torch.autograd.grad(whole_y.sum(), w)
    ys, dws = [], []
    for first in (0, 2):
        view = md.local_experts(route, first, 2)
        assert torch.equal(md.moe_dispatch(tokens, view), whole_in[first:first + 2])
        assert view.room.tolist() == route.room[first:first + 2].tolist()
        if first:
            assert (view.idx[~view.keep] < 0).any()
        y = md.moe_combine(out[first:first + 2], w, view)
        ys.append(y)
        dws.append(torch.autograd.grad(y.sum(), w)[0])
    assert torch.allclose(ys[0] + ys[1], whole_y, atol=1e-6)
    assert torch.allclose(dws[0] + dws[1], whole_dw, atol=1e-6)
    assert md.local_experts(route, 0, 4) is route


# ---------------------------------------------------------------------------
# the layer and the model against one process
# ---------------------------------------------------------------------------


def _layer_case(cfg, seed):
    """A layer's whole params and inputs ``x [4, 8, D]`` that share a
    direction the router's expert 0 favours (most tokens' first pick)."""
    gen = torch.Generator().manual_seed(seed)
    layer = tm.init_moe_layer(cfg, generator=gen, device=CPU)
    d = cfg.base.d_model
    x = torch.randn((4, 8, d), generator=gen) + 1.0
    layer["router"][:, 0] += 2.0 / d
    c = torch.randn((4, 8, d), generator=gen)
    return layer, x, c


@pytest.mark.parametrize("dp, tp, ep", MESHES)
def test_moe_ffn_matches_one_process(dp, tp, ep):
    """The layer on each rank (its rows, its experts' slices) against the
    one-process layer on the whole batch, with drops: the rank's output
    rows, the aux shares summed over dp, the gradients of its rows and of
    its slices (summed over dp) of ``(y c).sum() + aux``."""
    cfg = _cfg()
    layer, x, c = _layer_case(cfg, seed=dp + 3 * tp + 5 * ep)
    leaves = {k: v.clone().requires_grad_() for k, v in layer.items()}
    xw = x.clone().requires_grad_()
    y, aux = tm.moe_ffn(xw, leaves, cfg)
    aux = aux["moe_aux_loss"]
    want = torch.autograd.grad((y * c).sum() + aux, [xw, *leaves.values()])
    with torch.no_grad():
        probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ layer["router"], -1)
        kept = md.moe_route_reference(probs, 2, tm.capacity(cfg, 32)).keep
    assert not kept.all()

    def body(mesh):
        rows = slice(mesh.dp_rank * (4 // dp), (mesh.dp_rank + 1) * (4 // dp))
        specs = tm.moe_layer_specs()
        mine = {k: tm.shard_leaf(v, specs[k], _shard(mesh)).clone().requires_grad_()
                for k, v in layer.items()}
        xr = x[rows].clone().requires_grad_()
        yr, share = tm.moe_ffn(xr, mine, cfg, mesh=mesh)
        share = share["moe_aux_loss"]
        grads = torch.autograd.grad((yr * c[rows]).sum() + share, [xr, *mine.values()])
        total = mesh.all_reduce(share.detach().clone(), "dp")
        for g in grads[1:]:
            mesh.all_reduce(g, "dp")
        return _shard(mesh), rows, yr.detach(), total, grads

    specs = tm.moe_layer_specs()
    for shard, rows, yr, total, grads in run_mesh(dp, tp, ep, body):
        assert _rel(yr, y[rows].detach()) <= LOSS_REL
        assert abs(total.item() - aux.item()) / aux.item() <= LOSS_REL
        assert _rel(grads[0], want[0][rows]) <= GRAD_REL
        for name, g, w in zip(layer, grads[1:], want[1:]):
            assert _rel(g, tm.shard_leaf(w, specs[name], shard)) <= GRAD_REL, name


def _model_case(cfg, seed):
    params = tm.init_params(cfg, generator=torch.Generator().manual_seed(seed), device=CPU)
    chip_smoke.skew_router(torch, params, chip_smoke.MOE_MESH_SKEW)
    toks = np.random.default_rng(seed).integers(0, cfg.base.vocab_size, (4, 16)).astype(np.int32)
    return params, torch.from_numpy(toks)


@pytest.mark.parametrize("dp, tp, ep", MESHES)
def test_loss_and_gradients_match_one_process(dp, tp, ep):
    """``make_mesh_grad`` on each rank (its slices, the whole batch handed
    in) against ``loss_fn`` and ``autograd.grad`` in one process, with
    drops in layer 0: every rank returns the global loss, and its
    gradients are the slices of the one-process ones."""
    cfg = _cfg()
    params, toks = _model_case(cfg, seed=dp + tp + ep)
    kept, slots = chip_smoke.layer0_kept(torch, params, toks, cfg)
    assert kept < slots
    leaves = [p.clone().requires_grad_() for p in optim.tree_leaves(params)]
    loss = tm.loss_fn(_rebuild(params, iter(leaves)), toks, cfg)
    want = _rebuild(params, iter(torch.autograd.grad(loss, leaves)))

    def body(mesh):
        mine = optim.tree_map(lambda t: t.clone().requires_grad_(),
                              tm.shard_params(params, cfg, _shard(mesh)))
        value, grads = tm.make_mesh_grad(cfg, mesh)(mine, toks)
        return _shard(mesh), value.item(), grads

    results = run_mesh(dp, tp, ep, body)
    for shard, value, grads in results:
        assert value == results[0][1]
        assert abs(value - loss.item()) / loss.item() <= LOSS_REL
        mine = optim.tree_leaves(tm.shard_params(want, cfg, shard))
        assert len(grads) == len(mine)
        for g, w in zip(grads, mine):
            assert g.shape == w.shape and _rel(g, w) <= GRAD_REL


def test_sharded_init_is_the_slices_of_the_whole_draw():
    """``init_params(shard=)`` on every rank of dp 1 × tp 2 × ep 2 draws the
    same numbers as the whole draw and keeps the slices
    (``shard_params``), bit for bit; the router whole and fp32."""
    cfg = _cfg()
    whole = tm.init_params(cfg, generator=torch.Generator().manual_seed(4), device=CPU)
    for t in range(2):
        for e in range(2):
            shard = ({"dp": 0, "tp": t, "sp": 0, "ep": e, "pp": 0},
                     {"dp": 1, "tp": 2, "sp": 1, "ep": 2, "pp": 1})
            got = tm.init_params(cfg, generator=torch.Generator().manual_seed(4), device=CPU,
                                 shard=shard)
            want = tm.shard_params(whole, cfg, shard)
            for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(want)):
                assert torch.equal(a, b)
            moe = got["layers"][0]["moe"]
            assert moe["w_gate"].shape == (2, cfg.base.d_model, cfg.d_ff // 2)
            assert moe["w_down"].shape == (2, cfg.d_ff // 2, cfg.base.d_model)
            assert moe["router"].dtype == torch.float32
            assert moe["router"].shape == (cfg.base.d_model, 4)


# ---------------------------------------------------------------------------
# against the JAX package's mesh step
# ---------------------------------------------------------------------------


def test_dp_tp_ep_train_step_matches_jax():
    """8 gloo ranks at dp 2 × tp 2 × ep 2 against ``moe.make_train_step`` on
    ``build_mesh(MeshSpec(dp=2, tp=2, ep=2))`` over 8 CPU devices (the
    reference's MoE dry run, ``tests/test_moe_pipeline.py``), three fp32
    AdamW steps at B 4, T 16, at capacity factor 0.5: tokens drop."""
    jcfg = jm.MoEConfig(base=jl.LlamaConfig(dtype=jnp.float32, **BASE_KW), n_experts=4, top_k=2,
                        capacity_factor=CF)
    cfg = _cfg()
    jinit, jstep = jm.make_train_step(
        jcfg, jmesh.build_mesh(jmesh.MeshSpec(dp=2, tp=2, ep=2), devices=jax.devices()[:8]))
    jparams, jstate = jinit(jax.random.PRNGKey(11))
    full = tm.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    batches = [np.random.default_rng(40 + i).integers(0, 256, (4, 16)).astype(np.int32)
               for i in range(3)]
    kept, slots = chip_smoke.layer0_kept(torch, full, torch.from_numpy(batches[0]), cfg)
    assert kept < slots
    jlosses = []
    for toks in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        jlosses.append(float(jloss))
    want = tm.params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
                              device=CPU)

    def body(mesh):
        _, step = tm.make_train_step(cfg, device=CPU, mesh=mesh)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(),
                                tm.shard_params(full, cfg, _shard(mesh)))
        state = optim.adamw_init(params)
        losses = [step(params, state, torch.from_numpy(t))[2].item() for t in batches]
        return _shard(mesh), losses, [p.detach() for p in optim.tree_leaves(params)]

    results = run_mesh(2, 2, 2, body)
    for shard, losses, leaves in results:
        assert losses == results[0][1]
        for got, w in zip(losses, jlosses):
            assert abs(got - w) / w <= REL
        mine = optim.tree_leaves(tm.shard_params(want, cfg, shard))
        assert len(leaves) == len(mine) == len(_jax_leaves(jparams))
        for got, w in zip(leaves, mine):
            assert (got - w).abs().max().item() <= PARAM_ATOL


# ---------------------------------------------------------------------------
# what the family refuses
# ---------------------------------------------------------------------------


def test_sp_is_refused_naming_a12b():
    def body(mesh):
        with pytest.raises(ValueError, match="ROADMAP A12b, MoE over sp"):
            tm.make_train_step(_cfg(), device=CPU, mesh=mesh)
        return True

    assert run_mesh(1, 1, 1, body, sp=2) == [True, True]


def test_experts_that_ep_does_not_split_are_refused():
    def body(mesh):
        with pytest.raises(ValueError, match="ep=4 does not divide 2 experts"):
            tm.make_train_step(_cfg(n_experts=2), device=CPU, mesh=mesh)
        return True

    assert run_mesh(1, 1, 4, body) == [True] * 4


def test_d_ff_that_tp_does_not_split_is_refused():
    def body(mesh):
        with pytest.raises(ValueError, match="tp=2 does not divide the experts' d_ff 31"):
            tm.make_train_step(_cfg(d_expert=31), device=CPU, mesh=mesh)
        with pytest.raises(ValueError, match="tp=2 does not divide the experts' d_ff 31"):
            tm.init_params(_cfg(d_expert=31), generator=torch.Generator(), device=CPU,
                           shard=_shard(mesh))
        return True

    assert run_mesh(1, 2, 1, body) == [True, True]
