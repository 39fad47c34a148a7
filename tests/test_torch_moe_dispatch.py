"""The MoE routing, dispatch and combine kernels (B7,
``cordum_tpu_torch/csrc/moe_dispatch.cu``) against their plain versions on
the card.

Every test here is ``gpu``-marked and skips without a card: the kernels
have no CPU mode (on the CPU the wrappers are the plain versions, which
``tests/test_torch_moe.py`` holds to the JAX package and to a numpy
emulation of the kernels' algorithm).  Each case runs
``chip_smoke.check_moe``: the route (indices, positions, keep, counts,
slot_token, slot_k) equal to the plain version's and the same on two calls;
the dispatch and the combine backward's ``d_out`` equal to autograd of the
reference's einsums, empty capacity rows zero; the combine and the dispatch
backward within one rounding (fp32 sums of k terms in another order,
rounded once to the dtype: ``chip_smoke.MOE_SUM_ROUNDING`` of the terms'
magnitudes plus one ulp of the dtype); ``d_w`` within
``chip_smoke.MOE_DW_REL`` of its products' magnitudes (a D-long fp32 dot in
another order); each backward kernel run twice gives the same bits.  Cases
at block and tile edges: N 1, 7 and 8193, and N at the route's tile size
(``md.ROUTE_TILE``) less one, equal and plus one; D 64, 4096 and 4104
(4104 bf16 rows are 16-byte vectors, fp32 rows too; odd D takes the
scalar loop, 4104 a partial last group of the slot gather's vectors);
capacity 1, fewer rows than kept slots, a capacity cut inside a route
tile, all tokens on one expert, k = E with drops on every expert, more
than 32 kept slots a token (the route, the dispatch and d_out only), exact
ties (at N 8192 planted on the route's tile edges too), bf16 and fp32.
The route with a room (a dp rank's, phase 14.1's gate off its main shape,
the fused and the split launches) and an ep rank's view of a route, whose
unkept pairs hold negative or out-of-range experts the gathers never read.
On the card (no JAX there) run them with ``python -m pytest --noconftest
-m gpu tests/test_torch_moe_dispatch.py``.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from cordum_tpu_torch.ops import moe_dispatch as md

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("d", [64, 4096, 4104, 100])
@pytest.mark.parametrize("n", [1, 7, md.ROUTE_TILE - 1, md.ROUTE_TILE, md.ROUTE_TILE + 1, 8193])
def test_kernels_match_plain_version_on_card(n, d, dtype):
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=n, d=d, seed=n + d)
    chip_smoke.check_moe(torch, case, f"N {n} D {d}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("kind, e, k, cf, n", [
    ("random", 8, 2, 0.01, 64),   # capacity 1
    ("random", 8, 2, 0.5, 300),   # fewer rows than kept slots: drops on every expert
    ("one", 8, 2, 1.25, 2000),    # every token on expert 0
    ("one", 2, 1, 1.25, 2000),
    ("drop", 2, 1, 0.25, 4096),   # the reference's capacity-drop case, at width
    ("ties", 8, 2, 1.25, 3000),
    ("ties", 4, 4, 1.25, 1500),   # k = E: every expert, in index order on ties
    ("random", 64, 8, 1.25, 1025),
    ("random", 4, 4, 0.5, 700),     # k = E: every token in every queue, drops on every expert
])
def test_capacity_and_tie_edges_on_card(kind, e, k, cf, n, dtype):
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=n, d=256, e=e, k=k, cf=cf, kind=kind,
                               seed=e + k + n)
    route, _, _ = chip_smoke.check_moe(torch, case, f"{kind} E {e} k {k} C {case['cap']}")
    if kind == "one":
        assert route.counts[0].item() == n
    if cf < 1:
        assert not route.keep.all()
    if k == e:
        assert (route.counts == n).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ties_on_route_tile_edges_on_card(dtype):
    """N 8192 with exact ties on both sides of every tile edge: the last
    token of a tile and the first of the next all equal, the next one's
    top two equal."""
    dev = _need_card()
    n, e = 8192, 8
    case = chip_smoke.moe_case(torch, dev, dtype, n=n, d=256, e=e, seed=3)
    edges = torch.arange(md.ROUTE_TILE, n, md.ROUTE_TILE, device=dev)
    probs = case["probs"]
    probs[edges - 1] = 1.0 / e
    probs[edges] = 1.0 / e
    probs[edges + 1, 2:4] = probs[edges + 1].amax(-1, keepdim=True)
    route, _, _ = chip_smoke.check_moe(torch, case, "ties on tile edges")
    assert route.idx[edges - 1].tolist() == [[0, 1]] * len(edges)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_capacity_cut_inside_a_route_tile_on_card(dtype):
    """Every token on expert 0 with capacity 200: the cut falls inside the
    route's second tile, so one tile keeps its first tokens and drops the
    rest."""
    dev = _need_card()
    n = 1000
    case = chip_smoke.moe_case(torch, dev, dtype, n=n, d=256, cf=0.8, kind="one", seed=5)
    cap = case["cap"]
    assert cap == 200 and cap % md.ROUTE_TILE
    route, _, _ = chip_smoke.check_moe(torch, case, f"cut at {cap}")
    assert torch.equal(route.keep[:, 0].cpu(), torch.arange(n) < cap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_more_than_32_slots_on_card(dtype):
    """k 36 of E 40: the slot gather takes a token's kept slots 32 at a
    time.  The route, the dispatch and d_out against the plain versions;
    not the token gathers, whose sums of 36 terms are outside
    ``check_moe``'s one-rounding gate (derived for a sum of a few)."""
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=200, d=64, e=40, k=36, seed=11)
    probs, k, cap, tokens, dy = (case[x] for x in ("probs", "k", "cap", "tokens", "dy"))
    route = md.moe_route_kernel(probs, k, cap)
    plain = md.moe_route_reference(probs, k, cap)
    assert md.route_equal(route, plain)
    w = chip_smoke.routing_weights(torch, probs, route)
    assert torch.equal(md.moe_slot_gather(tokens, route), md.moe_dispatch_reference(tokens, plain))
    out = case["expert_out"].clone().requires_grad_()
    (d_out,) = torch.autograd.grad(md.moe_combine_reference(out, w, plain), out, dy)
    assert torch.equal(md.moe_slot_gather_scaled(dy, route, w), d_out)
    assert route.keep.sum(1).max() > 32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_empty_rows_are_written_as_zeros_on_card(dtype):
    """The caching allocator hands back a block just filled with NaN: the
    dispatch must still write every empty capacity row as zeros."""
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=512, d=512, kind="one")
    route = md.moe_route_kernel(case["probs"], case["k"], case["cap"])
    e, cap = route.slot_token.shape
    junk = torch.full((e, cap, 512), float("nan"), dtype=dtype, device=dev)
    del junk
    expert_in = md.moe_slot_gather(case["tokens"], route)
    assert torch.isfinite(expert_in).all()
    assert (expert_in[route.slot_token < 0] == 0).all()


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, torch.float32, n=64, d=128)
    probs, k, cap, tokens = case["probs"], case["k"], case["cap"], case["tokens"]
    route = md.moe_route_kernel(probs, k, cap)
    w = chip_smoke.routing_weights(torch, probs, route)
    with pytest.raises(ValueError, match="fp32"):
        md.moe_route_kernel(probs.double(), k, cap)
    with pytest.raises(ValueError, match="contiguous"):
        md.moe_route_kernel(probs.t().contiguous().t(), k, cap)
    with pytest.raises(ValueError, match="top_k"):
        md.moe_route_kernel(probs, probs.shape[1] + 1, cap)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        md.moe_dispatch(tokens.half(), route)
    with pytest.raises(ValueError, match="contiguous"):
        md.moe_dispatch(torch.empty_like(tokens).t().contiguous().t().copy_(tokens), route)
    with pytest.raises(ValueError, match="w must be fp32"):
        md.moe_combine(case["expert_out"], w.double(), route)
    with pytest.raises(ValueError, match="contiguous"):
        md.moe_combine(case["expert_out"].transpose(0, 1).contiguous().transpose(0, 1), w,
                       route)
    with pytest.raises(ValueError, match="route.idx"):
        md.moe_dispatch(tokens, route._replace(idx=route.idx.long()))
    with pytest.raises(ValueError, match="CUDA"):
        md.moe_token_sum(case["expert_out"].cpu(), route)


@pytest.mark.gpu
def test_each_launch_mode_counts_once_a_forward_and_backward_on_card():
    """A dispatch and a combine, forward and backward, launch each B7 mode
    once, each counted in its own wrapper's ``launches``."""
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, torch.bfloat16, n=256, d=128)
    counters = chip_smoke.launch_counters()
    before = {mode: counters[mode].launches for mode in chip_smoke.MOE_KERNELS}
    route = md.moe_route(case["probs"], case["k"], case["cap"])
    w = chip_smoke.routing_weights(torch, case["probs"], route).requires_grad_()
    tokens = case["tokens"].clone().requires_grad_()
    y = md.moe_combine(md.moe_dispatch(tokens, route), w, route)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert {mode: counters[mode].launches - before[mode]
            for mode in chip_smoke.MOE_KERNELS} == dict.fromkeys(chip_smoke.MOE_KERNELS, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_library_yardsticks_compute_the_same_function_on_card(dtype):
    """Phase 9.1's library calls: ``index_select`` over the tokens with a
    zero row appended is the dispatch; ``embedding_bag`` over bags of one
    row scaled by its weight is d_out, and with per-sample weights w (or
    keep) is the combine (the dispatch backward), up to the weights'
    rounding to the dtype."""
    import torch.nn.functional as F

    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=1000, d=256)
    tokens, probs, k, cap = case["tokens"], case["probs"], case["k"], case["cap"]
    route = md.moe_route_kernel(probs, k, cap)
    w = chip_smoke.routing_weights(torch, probs, route)
    e, n = probs.shape[1], tokens.shape[0]
    tol = dict(rtol=2e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    rows = torch.where(route.slot_token >= 0, route.slot_token, n).reshape(-1).long()
    padded = torch.cat([tokens, tokens.new_zeros((1, tokens.shape[1]))])
    assert torch.equal(torch.index_select(padded, 0, rows).reshape(e, cap, -1),
                       md.moe_slot_gather(tokens, route))
    row_w = torch.where(route.slot_token >= 0, w[route.slot_token.clamp_min(0).long(),
                                                 route.slot_k.clamp_min(0).long()], 0.0)
    lib = F.embedding_bag(rows[:, None], padded, per_sample_weights=row_w.reshape(-1, 1)
                          .to(dtype), mode="sum")
    torch.testing.assert_close(lib.float(), md.moe_slot_gather_scaled(tokens, route, w)
                               .reshape(e * cap, -1).float(), **tol)
    flat = route.idx.long() * cap + torch.where(route.keep, route.pos, 0).long()
    table = case["expert_out"].reshape(e * cap, -1)
    lib = F.embedding_bag(flat, table, per_sample_weights=(w * route.keep).to(dtype), mode="sum")
    torch.testing.assert_close(lib.float(), md.moe_token_gather(case["expert_out"], route,
                                                                w).float(), **tol)
    lib = F.embedding_bag(flat, table, per_sample_weights=route.keep.to(dtype), mode="sum")
    torch.testing.assert_close(lib.float(), md.moe_token_sum(case["expert_out"], route).float(),
                               **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("tag, kind0, kind1", chip_smoke.MOE_ROOM_CASES)
@pytest.mark.parametrize("n", [md.ROUTE_TILE + 1, 3000])
def test_route_with_a_room_on_card(n, tag, kind0, kind1, dtype):
    """Phase 14.1's gate (``chip_smoke.check_room_route``) off its main
    shape: rank 1 of a dp 2 mesh routes with the room rank 0 leaves it
    (pick, the room from the counts, place), equal to the plain version
    and to the whole batch's route on its rows; the gathers on that route
    and on an ep 2 rank's view of it by 9.1's gates."""
    dev = _need_card()
    chip_smoke.check_room_route(torch, dev, dtype, tag, kind0, kind1, n=n, d=256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("first, count", [(4, 4), (7, 1)])
def test_gathers_never_read_the_idx_of_an_unkept_pair_on_card(first, count, dtype):
    """An ep rank's view (``local_experts``: experts 4-7 of 8, or expert 7
    alone, fewer than k) leaves the other experts' pairs unkept with idx
    negative or past its experts; planting ``INT32_MIN`` and
    ``INT32_MAX`` there too changes no output of the five gathers, which
    equal the plain versions on the view."""
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, dtype, n=1000, d=256, kind="drop", seed=5)
    route = md.moe_route_kernel(case["probs"], case["k"], case["cap"])
    w = chip_smoke.routing_weights(torch, case["probs"], route)
    view = md.local_experts(route, first, count)
    assert (view.idx[~view.keep] < 0).any()
    planted = view._replace(idx=torch.where(
        view.keep, view.idx, torch.where(view.idx < 0, -2**31, 2**31 - 1)).to(torch.int32))
    cut = slice(first, first + count)
    local = dict(case, expert_out=case["expert_out"][cut].contiguous(),
                 d_ei=case["d_ei"][cut].contiguous())
    for r in (view, planted):
        chip_smoke.check_moe_gathers(torch, local, r, w, f"experts {first}-{first + count - 1}")
    out = [md.moe_slot_gather(case["tokens"], r) for r in (view, planted)]
    assert torch.equal(out[0], out[1])


@pytest.mark.gpu
def test_route_room_is_checked_and_counted_on_card():
    """A room of the wrong dtype, length or device is refused before the
    place launch; a route with a room counts in ``launches`` and
    ``room_launches``, one without it only in ``launches``."""
    dev = _need_card()
    case = chip_smoke.moe_case(torch, dev, torch.float32, n=300, d=64)
    probs, k, cap = case["probs"], case["k"], case["cap"]
    room = torch.full((probs.shape[1],), cap // 2, dtype=torch.int32, device=dev)
    for bad in (room.long(), room[:-1], room.cpu()):
        with pytest.raises(ValueError, match="room must be"):
            md.moe_route_kernel(probs, k, cap, lambda counts, bad=bad: bad)
    before = (md.moe_route_kernel.launches, md.moe_route_kernel.room_launches)
    md.moe_route_kernel(probs, k, cap)
    md.moe_route_kernel(probs, k, cap, lambda counts: room)
    assert (md.moe_route_kernel.launches - before[0],
            md.moe_route_kernel.room_launches - before[1]) == (2, 1)
