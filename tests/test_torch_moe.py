"""Parity of the port's MoE family (``cordum_tpu_torch/models/moe.py`` and
the plain versions in ``ops/moe_dispatch.py``, B7) with the JAX package's
``cordum_tpu/models/moe.py``, on the CPU.

Weights are JAX's ``init_params`` / ``init_moe_layer`` carried across by
``params_from_jax``; inputs and tokens come from numpy with a seed.  On the
CPU the port's route, dispatch and combine are their plain versions (the
reference's dense one-hot einsums); the kernels' own algorithm is emulated
here in numpy (the route's pick and place passes over tiles of tokens,
the top-k by k passes and the k-th pick as a threshold; the slot gather
token-major, the token gathers in slot order) and held to the plain
versions.  Cases:
``top_k`` 1 and 2, ``n_experts`` 2, 4 and 8, a ragged N (B 3, T 7), the
reference's capacity-drop case (``tests/test_moe_pipeline.py``: E 2, k 1,
capacity factor 0.25, every token routed alike) and exact ties (a zero
router: every probability 1/E, experts 0..k-1 picked).  Tolerances, fp32:

* ``moe_ffn``'s output and aux loss, ``forward``'s logits, ``loss_fn`` and
  every gradient within 1e-5 of the reference tensor's largest ``|value|``
  (the frameworks sum the products and the softmax in other orders), with
  two exceptions where the exact gradient is a difference of roundings:
  - at ``top_k`` 1 the routing weight is ``p / p = 1``, whose exact
    gradient is 0, and each framework computes it as the difference of two
    quotients; that rounding noise reaches the router's gradient, measured
    at up to 6e-5 of it in the reference itself.  The router gradients are
    then held to the exact one (the aux loss's alone, computed by the
    reference) no worse than twice the reference's own error, and within
    1e-5 where that is smaller;
  - a gradient that is zero in exact arithmetic (the capacity-drop case's
    constant tokens make every value row of the first layer alike, so its
    ``wq`` and ``wk`` get none) is rounding noise in both frameworks: the
    port's must stay below 1e-6 of the model's largest gradient, where the
    reference's is;
* three AdamW steps against ``jax.value_and_grad`` and ``optax.adamw(3e-4,
  weight_decay=0.01)``: each step's loss within 1e-5 relative and every
  param within 6 lr = 1.8e-3 after the three steps (Adam moves an element by
  about lr * sign(g), so a gradient within fp32 noise of 0, as above, may
  flip an update by 2 lr a step);
* the route (indices, positions, keep, counts) equal; the emulated
  dispatch and combine-backward ``d_out`` equal to the einsums; the
  emulated combine and dispatch backward within one fp32 rounding of the
  sum of the magnitudes of their terms (2^-22 of it).
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.models import moe as jm
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import moe as tm
from cordum_tpu_torch.ops import moe_dispatch as md

CPU = "cpu"
REL = 1e-5
LR = 3e-4
PARAM_ATOL = 6 * LR
#: below this share of the model's largest gradient a reference gradient is
#: zero up to rounding
ZERO_SHARE = 1e-6
ROUNDING = 2.0**-22
BASE_KW = {k: getattr(tl.LlamaConfig.tiny(), k) for k in (
    "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq_len")}
#: name → (n_experts, top_k, capacity_factor, zero router, (B, T), constant tokens)
CASES = {
    "e2k1": (2, 1, 1.25, False, (2, 16), False),
    "e2k2": (2, 2, 1.25, False, (2, 16), False),
    "e4k1": (4, 1, 1.25, False, (2, 16), False),
    "e4k2": (4, 2, 1.25, False, (2, 16), False),
    "e8k1": (8, 1, 1.25, False, (2, 16), False),
    "e8k2": (8, 2, 1.25, False, (2, 16), False),
    "ragged": (4, 2, 1.25, False, (3, 7), False),
    "drop": (2, 1, 0.25, False, (2, 32), True),
    "ties": (4, 2, 1.25, True, (2, 16), False),
}


def _cfgs(n_experts, top_k, capacity_factor):
    jbase = jl.LlamaConfig(dtype=jnp.float32, **BASE_KW)
    tbase = tl.LlamaConfig(dtype=torch.float32, **BASE_KW)
    return (jm.MoEConfig(base=jbase, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor),
            tm.MoEConfig(base=tbase, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor))


def _case(name, seed=0):
    """(jcfg, tcfg, JAX params as numpy, tokens [B, T] int32)."""
    e, k, cf, zero_router, (b, t), constant = CASES[name]
    jcfg, tcfg = _cfgs(e, k, cf)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed), jcfg))
    if zero_router:
        for layer in params["layers"]:
            layer["moe"]["router"] = np.zeros_like(layer["moe"]["router"])
    rng = np.random.default_rng(seed + 1)
    tokens = (np.zeros((b, t), np.int32) if constant
              else rng.integers(0, jcfg.base.vocab_size, (b, t)).astype(np.int32))
    return jcfg, tcfg, params, tokens


def _port_params(params, *, grad=True):
    out = tm.params_from_jax(params, device=CPU)
    for p in optim.tree_leaves(out):
        p.requires_grad_(grad)
    return out


def _jax_leaves(tree):
    """A JAX tree's leaves in the port's ``tree_leaves`` order."""
    return optim.tree_leaves(jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _names(tree, prefix=""):
    """The leaf paths of a param tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}/{i}")]
    return [prefix]


def _hold_gradients(names, got, want, exact_router=None):
    """Every gradient within ``REL`` of the reference's largest value; the
    two exceptions of the module's docstring: ``exact_router`` (name →
    the exact router gradient, at top_k 1) and gradients that are zero up
    to rounding."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    top = max(np.abs(w).max() for w in want)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if exact_router and name in exact_router:
            exact = np.asarray(exact_router[name], np.float64)
            scale = np.abs(exact).max()
            port, ref = np.abs(g - exact).max(), np.abs(w - exact).max()
            assert port <= max(REL * scale, 2 * ref), (name, port / scale, ref / scale)
        elif np.abs(w).max() <= ZERO_SHARE * top:
            assert np.abs(g).max() <= ZERO_SHARE * top, name
        else:
            assert _rel(g, w) <= REL, name


# ---------------------------------------------------------------------------
# moe_ffn, forward, loss_fn and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_and_gradients_match_jax(case):
    jcfg, tcfg, params, tokens = _case(case)
    layer = params["layers"][0]["moe"]
    b, t = tokens.shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, jcfg.base.d_model)).astype(np.float32)
    if CASES[case][5]:  # every token alike: all route the same way
        x[:] = x[0, 0]
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x, layer):
        y, aux = jm.moe_ffn(x, layer, jcfg)
        return jnp.sum(y * r) + aux["moe_aux_loss"], (y, aux["moe_aux_loss"])

    jx, jlayer = jnp.asarray(x), jax.tree.map(jnp.asarray, layer)
    (jval, (jy, jaux)), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jx, jlayer)
    exact = None
    if jcfg.top_k == 1:  # y reaches the router only through w = p / p = 1
        exact = {"router": jax.grad(
            lambda lay: jm.moe_ffn(jx, lay, jcfg)[1]["moe_aux_loss"])(jlayer)["router"]}
    tx = torch.from_numpy(x).requires_grad_()
    tlayer = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in layer.items()}
    y, aux = tm.moe_ffn(tx, tlayer, tcfg)
    val = (y * torch.from_numpy(r)).sum() + aux["moe_aux_loss"]
    grads = torch.autograd.grad(val, [tx] + [tlayer[k] for k in sorted(tlayer)])
    assert _rel(y.detach().numpy(), jy) <= REL
    assert _rel(aux["moe_aux_loss"].item(), float(jaux)) <= REL
    assert _rel(val.item(), float(jval)) <= REL
    want = [np.asarray(jgrads[0])] + [np.asarray(jgrads[1][k]) for k in sorted(tlayer)]
    _hold_gradients(["x"] + sorted(tlayer), grads, want, exact)
    if case == "drop":  # the overflow goes to the residual path: y = 0
        n = b * t
        cap = tm.capacity(tcfg, n)
        assert cap == 8 and (y.detach().reshape(n, -1).abs().sum(-1) > 0).sum() == cap
        assert np.all(np.asarray(jy).reshape(n, -1)[cap:] == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_gradients_match_jax(case):
    jcfg, tcfg, params, tokens = _case(case)
    jparams, jtokens = jax.tree.map(jnp.asarray, params), jnp.asarray(tokens)
    jlogits, jaux = jax.jit(jm.forward, static_argnums=2)(jparams, jtokens, jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)(
        jparams, jtokens, jcfg)
    tparams = _port_params(params)
    with torch.no_grad():
        logits, aux = tm.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert _rel(logits.numpy(), jlogits) <= REL
    assert _rel(aux["moe_aux_loss"].item(), float(jaux["moe_aux_loss"])) <= REL
    loss = tm.loss_fn(tparams, torch.from_numpy(tokens), tcfg)
    assert _rel(loss.item(), float(jloss)) <= REL
    leaves = optim.tree_leaves(tparams)
    grads = torch.autograd.grad(loss, leaves)
    want = _jax_leaves(jgrads)
    names = _names(params)
    assert len(grads) == len(want) == len(names) == 3 + 10 * tcfg.base.n_layers
    exact = None
    if jcfg.top_k == 1:  # the nll reaches the routers only through w = p / p = 1
        aux_grads = jax.jit(jax.grad(lambda p: 0.01 * jm.forward(p, jtokens, jcfg)[1][
            "moe_aux_loss"]))(jparams)
        exact = {n: w for n, w in zip(names, _jax_leaves(aux_grads)) if n.endswith("/router")}
    _hold_gradients(names, grads, want, exact)


@pytest.mark.parametrize("case", ["e4k2", "drop", "ties"])
def test_three_adamw_steps_match_jax(case):
    jcfg, tcfg, params, tokens = _case(case)
    opt = optax.adamw(LR, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jparams)
    vg = jax.jit(jax.value_and_grad(lambda p, toks: jm.loss_fn(p, toks, jcfg)))
    tparams = _port_params(params)
    _, step = tm.make_train_step(tcfg, device=CPU)
    state = optim.adamw_init(tparams)
    rng = np.random.default_rng(3)
    for i in range(3):
        toks = tokens if i == 0 else rng.integers(
            0, jcfg.base.vocab_size, tokens.shape).astype(np.int32)
        jloss, jgrads = vg(jparams, jnp.asarray(toks))
        updates, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, state, loss = step(tparams, state, torch.from_numpy(toks))
        assert _rel(loss.item(), float(jloss)) <= REL, i
    assert int(state["count"]) == 3
    for name, g, w in zip(_names(params), optim.tree_leaves(tparams), _jax_leaves(jparams)):
        assert (g.detach() - w).abs().max().item() <= PARAM_ATOL, name


def test_exact_ties_pick_the_lowest_experts():
    """A zero router makes every probability 1/E: ``lax.top_k`` and the port
    pick experts 0..k-1 (``torch.topk`` would not), and the capacity cut
    then keeps the first C tokens of experts 0 and 1."""
    probs = torch.full((10, 4), 0.25)
    route = md.moe_route(probs, 2, 6)
    assert route.idx.tolist() == [[0, 1]] * 10
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(jidx).tolist() == [[0, 1]] * 10
    assert route.pos[:, 0].tolist() == list(range(10))
    assert route.keep.sum().item() == 12 and route.counts.tolist() == [10, 10, 0, 0]
    assert route.slot_token.tolist() == [list(range(6))] * 2 + [[-1] * 6] * 2


# ---------------------------------------------------------------------------
# the route against lax.top_k and the reference's cumsum
# ---------------------------------------------------------------------------


def _probs(n, e, seed):
    """Softmax rows with ties planted: uniform rows, rows whose top two are
    equal, rows with a zero."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    probs[::5] = 1.0 / e
    if e > 2:
        probs[1::7, 1] = probs[1::7, 2] = probs[1::7].max(-1)
    probs[2::9, 0] = 0.0
    return probs


def _jax_route(probs, k, cap):
    """The reference's lines 82-94 on ``probs``: (idx, pos_idx, within_cap
    as keep, counts)."""
    p = jnp.asarray(probs)
    n, e = p.shape
    _, topk_idx = jax.lax.top_k(p, k)
    onehot = jax.nn.one_hot(topk_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(n * k, e)
    pos = (jnp.cumsum(flat, axis=0) - flat).reshape(n, k, e)
    within_cap = (pos < cap).astype(jnp.float32) * onehot
    pos_idx = jnp.einsum("nke,nke->nk", pos, within_cap).astype(jnp.int32)
    return (np.asarray(topk_idx), np.asarray(pos_idx),
            np.asarray(within_cap.sum(-1) > 0), np.asarray(onehot.sum((0, 1))))


@pytest.mark.parametrize("e, k, n, cap", [(2, 1, 33, 4), (4, 2, 50, 30), (8, 2, 64, 20),
                                          (8, 1, 17, 1), (4, 4, 12, 6)])
def test_route_reference_matches_lax_top_k(e, k, n, cap):
    probs = _probs(n, e, seed=e + k + n)
    route = md.moe_route_reference(torch.from_numpy(probs), k, cap)
    idx, pos_idx, keep, counts = _jax_route(probs, k, cap)
    assert np.array_equal(route.idx.numpy(), idx)
    assert np.array_equal(route.keep.numpy(), keep)
    assert np.array_equal(torch.where(route.keep, route.pos, 0).numpy(), pos_idx)
    assert np.array_equal(route.counts.numpy(), counts)
    assert route.idx.dtype == route.pos.dtype == torch.int32
    # slot_token / slot_k name each kept slot once; the rest of the rows are -1
    kept = [(int(route.idx[t, s]), int(route.pos[t, s]), t, s)
            for t in range(n) for s in range(k) if route.keep[t, s]]
    assert len(kept) == int((route.slot_token >= 0).sum())
    for ex, p, t, s in kept:
        assert route.slot_token[ex, p] == t and route.slot_k[ex, p] == s


# ---------------------------------------------------------------------------
# the kernels' algorithm, emulated in numpy, against the plain versions
# ---------------------------------------------------------------------------


def _before(a, ia, b, ib):
    """``before()`` of ``csrc/moe_dispatch.cu``: value a at index ia comes
    before b at ib in ``lax.top_k``'s order (ties to the lower index, NaN
    largest)."""
    na, nb = np.isnan(a), np.isnan(b)
    return np.where(na | nb, na & (~nb | (ia < ib)), (a > b) | ((a == b) & (ia < ib)))


def _emulate_route(probs, k, cap, tile, warp=32, chunk=32, room=None):
    """``moe_route_kernel``'s two launches over tiles of ``tile`` tokens,
    a thread a token, experts ``chunk`` at a time.  Pick: k passes find a
    token's picks in order (idx), each the first expert after the last;
    the token picks e when e is not after the k-th pick; its position
    among its tile's picks of e is its ballot prefix in its warp of
    ``warp`` lanes plus the earlier warps' counts, at slot rank(e); the
    tile's counts go to a table ``[n_tiles, E]``.  Place: each tile adds
    the earlier tiles' counts; a pair keeps below its expert's row limit
    (C, or ``min(room[e], C)`` with a room ``[E]``, the place kernel's
    ``row_limit``); the tails of slot_token / slot_k, past ``min(counts,
    limit)``, are -1 over a grid-stride loop."""
    n, e_count = probs.shape
    n_tiles = -(-n // tile)
    junk = -7  # what the allocator left
    idx, pos = np.full((n, k), junk, np.int32), np.full((n, k), junk, np.int32)
    keep = np.full((n, k), True)
    counts = np.full(e_count, junk, np.int32)
    slot_token = np.full((e_count, cap), junk, np.int32)
    slot_k = np.full((e_count, cap), junk, np.int32)
    table = np.full((n_tiles, e_count), junk, np.int32)
    j_all = np.arange(e_count)
    last = np.zeros(n, np.int64)  # each token's k-th pick
    for t in range(n):
        prev = None
        for s in range(k):
            after = [j for j in j_all if prev is None or _before(probs[t, prev], prev, probs[t, j], j)]
            best = after[0]
            for j in after[1:]:
                if _before(probs[t, j], j, probs[t, best], best):
                    best = j
            idx[t, s] = prev = best
        last[t] = prev

    def hit(t, e):
        return e == last[t] or bool(_before(probs[t, e], e, probs[t, last[t]], last[t]))

    def rank(t, e):
        return int(_before(probs[t], j_all, probs[t, e], e).sum())

    for t0 in range(n_tiles):  # the pick launch, a block a tile
        toks = np.arange(t0 * tile, min((t0 + 1) * tile, n))
        lanes = [toks[w:w + warp] for w in range(0, len(toks), warp)]
        for e0 in range(0, e_count, chunk):
            for e in range(e0, min(e0 + chunk, e_count)):
                ballots = [np.array([hit(t, e) for t in lane], bool) for lane in lanes]
                table[t0, e] = sum(int(b.sum()) for b in ballots)
                for w, (lane, b) in enumerate(zip(lanes, ballots)):
                    earlier = sum(int(x.sum()) for x in ballots[:w])
                    for li in np.nonzero(b)[0]:
                        pos[lane[li], rank(lane[li], e)] = earlier + int(b[:li].sum())
    total = table.sum(0)
    limit = [cap if room is None else max(0, min(int(room[e]), cap)) for e in range(e_count)]
    for t0 in range(n_tiles):  # the place launch
        base = table[:t0].sum(0)
        for e0 in range(0, e_count, chunk):
            ne = min(chunk, e_count - e0)
            for t in range(t0 * tile, min((t0 + 1) * tile, n)):
                for s in range(k):
                    if not e0 <= idx[t, s] < e0 + ne:
                        continue
                    p = base[idx[t, s]] + pos[t, s]
                    pos[t, s], keep[t, s] = p, p < limit[idx[t, s]]
                    if p < limit[idx[t, s]]:
                        slot_token[idx[t, s], p], slot_k[idx[t, s], p] = t, s
            if t0 == 0:
                counts[e0:e0 + ne] = total[e0:e0 + ne]
            for tid in range(tile):  # every thread of the block, past N too
                for f in range(t0 * tile + tid, ne * cap, n_tiles * tile):
                    e, c = e0 + f // cap, f % cap
                    if c >= min(total[e], limit[e]):
                        slot_token[e, c] = slot_k[e, c] = -1
    return md.MoERoute(*(torch.from_numpy(a) for a in (idx, pos, keep, counts, slot_token,
                                                       slot_k)),
                       None if room is None else torch.as_tensor(room, dtype=torch.int32))


def _assert_route_equal(got, want):
    for field in md.MoERoute._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None and b is None) or torch.equal(a, b), field


@pytest.mark.parametrize("tile", [1, 3, 5, 1024])
@pytest.mark.parametrize("e, k, n, cap", [(2, 1, 33, 4), (4, 2, 50, 30), (8, 2, 64, 20),
                                          (4, 4, 12, 6), (64, 8, 40, 7)])
def test_route_kernel_algorithm_matches_reference(e, k, n, cap, tile):
    """Tiles of one token, of a few (N not a multiple of them) and larger
    than N; k = E; E 64 k 8 (two passes of 32 experts)."""
    probs = _probs(n, e, seed=n)
    _assert_route_equal(_emulate_route(probs, k, cap, tile),
                        md.moe_route_reference(torch.from_numpy(probs), k, cap))


@pytest.mark.parametrize("tile, warp", [(3, 32), (5, 2), (4, 3)])
@pytest.mark.parametrize("kind", ["ties", "cut"])
def test_route_kernel_algorithm_at_tile_edges(kind, tile, warp):
    """"ties": exact ties on both sides of every tile edge (the last token
    of a tile and the first of the next uniform, the one after it with its
    top two equal).  "cut": every token's top pick is expert 0 and the
    capacity cut falls inside a tile.  Warps narrower than the tile
    exercise the numbering across warps."""
    n, e, k = 37, 4, 2
    probs = _probs(n, e, seed=tile)
    if kind == "ties":
        edges = np.arange(tile, n - 1, tile)
        probs[edges - 1] = probs[edges] = 1.0 / e
        probs[edges + 1, 1:3] = probs[edges + 1].max(-1, keepdims=True)
        cap = 12
    else:
        probs[:, 0] += 1.0
        cap = 2 * tile + 1  # the cut: token 2 tile + 1, inside the third tile
    got = _emulate_route(probs, k, cap, tile, warp=warp)
    _assert_route_equal(got, md.moe_route_reference(torch.from_numpy(probs), k, cap))
    if kind == "cut":
        assert got.keep[:, 0].tolist() == [t < cap for t in range(n)]
    else:
        assert got.idx[edges - 1].tolist() == [[0, 1]] * len(edges)


def test_route_kernel_names_its_expert_limit():
    """Past ``ROUTE_MAX_EXPERTS`` the route kernel refuses, naming the
    limit, before it looks for a card."""
    probs = torch.full((4, md.ROUTE_MAX_EXPERTS + 1), 1.0 / (md.ROUTE_MAX_EXPERTS + 1))
    with pytest.raises(ValueError, match=f"at most {md.ROUTE_MAX_EXPERTS}"):
        md.moe_route_kernel(probs, 2, 4)


def test_route_tiles_match_the_source():
    """The wrapper's count table has a row a route block: ``ROUTE_TILE``
    is the source's ``kRouteTile`` and ``route_tiles`` its ceiling
    division (the C entry refuses any other count)."""
    source = md.SOURCE.read_text()
    tile = int(re.search(r"constexpr int kRouteTile = (\d+);", source).group(1))
    assert tile == md.ROUTE_TILE
    limit = int(re.search(r"constexpr int kRouteMaxExperts = (\d+);", source).group(1))
    assert limit == md.ROUTE_MAX_EXPERTS
    assert limit * tile * 4 + 32 * (tile // 32) * 4 <= 227 * 1024  # rows and ballots
    assert [md.route_tiles(n) for n in (1, tile - 1, tile, tile + 1, 8192)] == [
        1, 1, 1, 2, -(-8192 // tile)]


def _emulate_gathers(tokens, expert_out, w, dy, d_ei, route):
    """The gather kernels in numpy fp32.  The slot gather, token-major: each
    token with a kept slot is read once (the dispatch's token, d_out's dy
    row) and written to each kept slot's row (idx, pos), times w[n, s] for
    d_out; the rows past min(counts[e], C) are then zeros.  The token
    gather: the combine (fmaf in slot order), ``d_w`` (dots) and the
    dispatch backward (w 1)."""
    e, c = route.slot_token.shape
    counts = route.counts.numpy()
    idx, pos, keep = route.idx.numpy(), route.pos.numpy(), route.keep.numpy()
    n, k = idx.shape
    expert_in = np.full((e, c, tokens.shape[1]), np.nan, np.float32)  # the allocator's
    d_out = np.full_like(expert_in, np.nan)
    for t in range(n):
        slots = np.nonzero(keep[t])[0]
        if not len(slots):
            continue
        x, g = tokens[t].copy(), dy[t].copy()  # read once
        for s in slots:
            expert_in[idx[t, s], pos[t, s]] = x
            d_out[idx[t, s], pos[t, s]] = np.float32(w[t, s]) * g
    for ex in range(e):
        expert_in[ex, min(counts[ex], c):] = 0.0
        d_out[ex, min(counts[ex], c):] = 0.0
    y = np.zeros_like(tokens)
    d_tokens = np.zeros_like(tokens)
    d_w = np.zeros((n, k), np.float32)
    for t in range(n):
        for s in range(k):
            if keep[t, s]:
                row = expert_out[idx[t, s], pos[t, s]]
                y[t] = (np.float64(w[t, s]) * row + y[t]).astype(np.float32)  # one rounding
                d_tokens[t] = d_tokens[t] + d_ei[idx[t, s], pos[t, s]]
                d_w[t, s] = np.dot(dy[t].astype(np.float64), row)
    return expert_in, y, d_out, d_w, d_tokens


@pytest.mark.parametrize("e, k, n, cap", [(2, 1, 33, 4), (4, 2, 50, 30), (8, 2, 64, 20),
                                          (4, 4, 12, 2)])
def test_gather_kernels_algorithm_matches_the_einsums(e, k, n, cap):
    rng = np.random.default_rng(e * n)
    d = 24
    probs = torch.from_numpy(_probs(n, e, seed=n))
    route = md.moe_route_reference(probs, k, cap)
    w = torch.gather(probs, 1, route.idx.long())
    w = w / w.sum(-1, keepdim=True)
    tokens, dy = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    expert_out, d_ei = (rng.standard_normal((e, cap, d)).astype(np.float32) for _ in range(2))
    got = _emulate_gathers(tokens, expert_out, w.numpy(), dy, d_ei, route)
    if (e, k, n) in ((2, 1, 33), (4, 4, 12)):  # more slots than rows on some expert
        assert (route.counts > cap).any()
    t_tok = torch.from_numpy(tokens).requires_grad_()
    t_out = torch.from_numpy(expert_out).requires_grad_()
    t_w = w.clone().requires_grad_()
    expert_in = md.moe_dispatch(t_tok, route)
    y = md.moe_combine(t_out, t_w, route)
    d_out, d_w = torch.autograd.grad(y, (t_out, t_w), torch.from_numpy(dy))
    (d_tokens,) = torch.autograd.grad(expert_in, t_tok, torch.from_numpy(d_ei))
    assert np.array_equal(got[0], expert_in.detach().numpy())
    assert np.array_equal(got[2], d_out.numpy())
    # sums of k terms: within one fp32 rounding of the terms' magnitudes
    w_np, keep = w.numpy(), route.keep.numpy()
    idx, pos = route.idx.numpy(), np.where(keep, route.pos.numpy(), 0)
    mag_y = sum(keep[:, s, None] * np.abs(w_np[:, s, None] * expert_out[idx[:, s], pos[:, s]])
                for s in range(k))
    mag_d = sum(keep[:, s, None] * np.abs(d_ei[idx[:, s], pos[:, s]]) for s in range(k))
    assert np.all(np.abs(got[1] - y.detach().numpy()) <= ROUNDING * mag_y)
    assert np.all(np.abs(got[4] - d_tokens.numpy()) <= ROUNDING * mag_d)
    mag_w = np.stack([keep[:, s] * np.abs(dy * expert_out[idx[:, s], pos[:, s]]).sum(-1)
                      for s in range(k)], 1)
    assert np.all(np.abs(got[3] - d_w.numpy()) <= 1e-6 * mag_w + 1e-30)
    assert np.all(d_w.numpy()[~keep] == 0)


def test_empty_capacity_rows_are_zero_and_carry_no_gradient():
    """Rows no token fills are zeros in the dispatch, and their gradient
    never reaches a token: NaN planted in an empty row of d_expert_in
    stays out of d_tokens."""
    probs = torch.tensor([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3]])
    route = md.moe_route(probs, 1, 4)
    tokens = torch.randn(3, 8, requires_grad=True)
    expert_in = md.moe_dispatch(tokens, route)
    assert torch.equal(expert_in[0, 3], torch.zeros(8)) and torch.equal(expert_in[1],
                                                                         torch.zeros(4, 8))
    d_ei = torch.randn(2, 4, 8)
    d_ei[1] = 0.0
    (d_tok,) = torch.autograd.grad(expert_in, tokens, d_ei)
    assert torch.equal(d_tok, d_ei[0, :3])


# ---------------------------------------------------------------------------
# the weights bridge and the model's pieces
# ---------------------------------------------------------------------------


def test_params_from_jax_keeps_the_router_fp32():
    jcfg = jm.MoEConfig.tiny()  # bf16 base
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    for dtype in (torch.bfloat16, None):
        tparams = tm.params_from_jax(params, device=CPU, dtype=dtype)
        for layer, jlayer in zip(tparams["layers"], params["layers"]):
            assert set(layer) == set(jlayer) and set(layer["moe"]) == set(jlayer["moe"])
            assert layer["moe"]["router"].dtype == torch.float32
            assert torch.equal(layer["moe"]["router"],
                               torch.from_numpy(np.array(jlayer["moe"]["router"])))
            assert layer["moe"]["w_gate"].dtype == torch.bfloat16
            assert layer["wq"].dtype == torch.bfloat16
    tparams = tm.params_from_jax(params, device=CPU, dtype=torch.float32)
    assert tparams["layers"][0]["moe"]["w_up"].dtype == torch.float32


def test_llama_params_from_jax_is_unchanged():
    """The MoE bridge shares ``_tensor_from_numpy`` with the Llama one: a
    Llama tree still converts leaf for leaf, each leaf keeping its dtype
    unless ``dtype`` is given."""
    jcfg = jl.LlamaConfig.tiny()  # bf16 leaves
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg))
    want = optim.tree_leaves(jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)), params))
    for dtype in (None, torch.float32):
        got = tl.params_from_jax(params, device=CPU, dtype=dtype)
        assert set(got) == {"embed", "layers", "final_norm", "lm_head"}
        assert all(set(a) == set(b) for a, b in zip(got["layers"], params["layers"]))
        for g, w in zip(optim.tree_leaves(got), want):
            assert torch.equal(g, w.to(dtype or torch.bfloat16))


def test_init_params_replaces_the_dense_ffn():
    cfg = tm.MoEConfig.tiny()
    params = tm.init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    jcfg = jm.MoEConfig.tiny()
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    assert set(params) == set(jparams)
    for layer, jlayer in zip(params["layers"], jparams["layers"]):
        assert set(layer) == set(jlayer)
        for name, w in layer["moe"].items():
            assert tuple(w.shape) == jlayer["moe"][name].shape
            assert str(w.dtype).split(".")[-1] == str(jlayer["moe"][name].dtype), name
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    assert tm.MoEConfig().d_ff == cfg.base.d_ff and tm.MoEConfig(d_expert=32).d_ff == 32


def test_make_train_step_learns_on_the_cpu():
    cfg = tm.MoEConfig.tiny()
    init, step = tm.make_train_step(cfg, device=CPU)
    params, state = init(0)
    leaves = optim.tree_leaves(params)
    assert all(p.is_leaf and p.requires_grad for p in leaves)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.base.vocab_size, (2, 16)).astype(np.int32))
    losses = [step(params, state, toks)[2].item() for _ in range(4)]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_train_step(tm.MoEConfig.tiny())


def test_import_scan_covers_the_moe_slice():
    """``tests/test_torch_serving.py`` imports every module of the package
    with JAX, the JAX package and msgpack blocked; this slice's modules are
    among them."""
    import pkgutil

    import cordum_tpu_torch

    mods = {m.name for m in pkgutil.walk_packages(cordum_tpu_torch.__path__,
                                                   "cordum_tpu_torch.")}
    assert {"cordum_tpu_torch.models.moe", "cordum_tpu_torch.ops.moe_dispatch",
            "cordum_tpu_torch.parallel.mesh", "cordum_tpu_torch.parallel.collectives"} <= mods


def test_chip_smoke_moe_bounds_count_this_routes_rows():
    """Phase 9.1's bounds count each input once and only the rows this
    route touches, for each launch mode: the route reads N E probs and
    writes its outputs; the slot gathers read the tokens (or dy rows) with
    a kept slot and write every capacity row; the token gathers and the dot
    read the kept slots' rows and write every token (or d_w)."""
    import chip_smoke

    probs = torch.tensor([[0.7, 0.2, 0.1], [0.6, 0.3, 0.1], [0.5, 0.1, 0.4],
                          [0.8, 0.1, 0.1]])
    route = md.moe_route_reference(probs, 1, 2)  # expert 0 takes tokens 0, 1; 2, 3 drop
    n, e, cap, k, d, el = 4, 3, 2, 1, 8, 2
    work = chip_smoke.moe_work_of(route, n, d, e, cap, k, el)
    assert set(work) == set(chip_smoke.MOE_KERNELS)
    assert work["moe_route"] == (n * e * 4 + n * k * 9 + e * 4 + 2 * e * cap * 4, n * e * e)
    assert work["moe_slot_gather"] == (e * cap * 4 + 2 * d * el + e * cap * d * el, 0)
    assert work["moe_slot_gather_scaled"] == (
        2 * e * cap * 4 + 2 * 4 + 2 * d * el + e * cap * d * el, 2 * d)
    assert work["moe_token_gather"] == (n * k * 13 + 2 * d * el + n * d * el, 2 * 2 * d)
    assert work["moe_token_sum"] == (n * k * 9 + 2 * d * el + n * d * el, 2 * d)
    assert work["moe_token_dot"] == (n * k * 9 + 2 * d * el + 2 * d * el + n * k * 4,
                                     2 * 2 * d)
