"""The paged-attention kernel's plain version and wrapper
(``cordum_tpu_torch.ops.paged_attention``).

On the CPU the plain version is held against the JAX package's own
formulation of the ragged step's attention core — the page-table gather
``k_pages[li][pt_tok]`` followed by ``_attention(q_offset=pos2)`` — in
fp32 with ``ATOL``/``RTOL`` 1e-5 (the two frameworks sum the score and PV
products in different orders; outputs are O(1)).  The wrapper must take
the plain version for CPU tensors, bit for bit, without counting a launch.

The kernel's work list (``build_plan``) is property-tested with
``hypothesis`` on random steps — sequences, positions, prefill chunks,
draft rows, padding and shuffled token order: every (token, KV head, page
the token reaches) lies in exactly one item, no group mixes sequences or
holds more than 16 tokens (64 query rows), every item holds at most
``span`` pages and every item of a split group at least ``span // 2``,
and the plan's shapes follow only the step's shape.  A plain emulation of
the kernel's split and merge over the plan (``paged_attention_planned``)
is held to the plain version in fp32 at 1e-5 (the same sums, grouped by
page run, then merged).

The ``gpu``-marked tests hold the CUDA kernel against the plain version on
the card: fp32 within 1e-4 absolute (fp32 sums in another order over
contexts up to a few thousand keys), bf16 within 6e-2 absolute — both
round the scores to bf16, but the plain version rounds the normalised
probabilities to bf16 before the PV product while the kernel rounds its
unnormalised online-softmax weights, a difference of a few bf16 ulps
(2^-8 relative) on outputs of magnitude up to ~3.

JAX is imported inside the one test that uses it, so that the file also
collects where JAX is not installed: the card's machine runs
``python -m pytest --noconftest -m gpu tests/test_torch_paged_attention.py``
(``tests/conftest.py`` imports JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cordum_tpu_torch.ops import paged_attention as pa

ATOL = RTOL = 1e-5
KERNEL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


def _case(h=4, kvh=2, hd=16, ps=8, num_pages=40, p_cols=8, seed=0):
    """A populated arena and one buffer of decode rows, a prefill chunk
    crossing a page boundary, a draft row and padding on the null row.
    Two rows alias one physical page (a shared prefix)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    s_rows = 4
    tables = np.zeros((s_rows + 1, p_cols), np.int32)
    tables[0, :8] = [3, 7, 1, 12, 13, 14, 15, 16]
    tables[1, :2] = [3, 2]  # shares physical page 3 with row 0
    tables[2, :3] = [9, 4, 11]
    tables[3, :4] = [8, 10, 17, 18]
    rows = [(0, 60, 1), (1, 9, 1), (2, 5, 6), (3, 27, 5)]  # (seq, start, n)
    t_buf = 16
    pos = np.zeros(t_buf, np.int32)
    seq = np.full(t_buf, s_rows, np.int32)
    ti = 0
    for s, start, n in rows:
        pos[ti:ti + n] = np.arange(start, start + n)
        seq[ti:ti + n] = s
        ti += n
    q = rng.standard_normal((t_buf, h, hd)).astype(np.float32)
    return q, k, v, tables, seq, pos


def _jax_formulation(q, k, v, tables, seq, pos):
    """``ragged_step``'s gather + ``_attention`` at one layer."""
    import jax.numpy as jnp

    from cordum_tpu.models import llama as jl

    t, h, hd = q.shape
    kvh = k.shape[2]
    cfg = jl.LlamaConfig(d_model=h * hd, n_heads=h, n_kv_heads=kvh, dtype=jnp.float32)
    pt_tok = jnp.asarray(tables)[jnp.asarray(seq)]
    kc = jnp.asarray(k)[pt_tok].reshape(t, -1, kvh, hd)
    vc = jnp.asarray(v)[pt_tok].reshape(t, -1, kvh, hd)
    pos2 = jnp.asarray(pos)[:, None]
    return np.asarray(jl._attention(jnp.asarray(q)[:, None], kc, vc, cfg, q_offset=pos2)[:, 0])


def test_plain_version_matches_jax_formulation():
    case = _case()
    got = pa.paged_attention_reference(*map(torch.from_numpy, case))
    np.testing.assert_allclose(got.numpy(), _jax_formulation(*case), atol=ATOL, rtol=RTOL)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _case(seed=1)]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    assert pa.paged_attention.launches == before  # no kernel launch
    assert torch.equal(got, pa.paged_attention_reference(*args))


def test_kernel_checks_reject_what_it_does_not_take():
    q, k, v, tables, seq, pos = [torch.from_numpy(a) for a in _case(hd=16)]
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.check_kernel_args(q, k, v, tables, seq, pos)  # CPU tensors
    q64, k64, v64, *_ = [torch.from_numpy(a) for a in _case(hd=64)]
    with pytest.raises(ValueError, match="head_dim 64"):
        pa.check_kernel_args(q64, k64, v64, tables, seq, pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.check_kernel_args(q.half(), k.half(), v.half(), tables, seq, pos)
    with pytest.raises(ValueError, match="int32"):
        pa.check_kernel_args(q, k, v, tables.long(), seq, pos)
    with pytest.raises(ValueError, match="contiguous"):
        pa.check_kernel_args(q.transpose(0, 1), k, v, tables, seq, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1, 16), (16, 4, 128)], ids=["tiny-tp2", "8b-tp2"])
def test_kernel_at_a_tensor_parallel_ranks_heads_on_card(dtype, shape):
    """A tp-2 serving rank attends with half the heads of each kind
    (serving/shard.py): the kernel and its plan at those counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, kvh, hd = shape
    dev = torch.device("cuda")
    q, k, v, tables, seq, pos = [
        torch.from_numpy(a).to(dev) for a in _case(h=h, kvh=kvh, hd=hd, ps=16)
    ]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    plan = pa.build_plan(seq.cpu().numpy(), pos.cpu().numpy(), page_size=16,
                         pages_per_seq=tables.shape[1], n_heads=h, n_kv_heads=kvh,
                         dtype=dtype, device=dev)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, seq, pos, plan=plan)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    assert (got.float() - want.float()).abs().max().item() <= KERNEL_ATOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 16), (32, 8, 128)])
def test_kernel_matches_plain_version_on_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, kvh, hd = shape
    dev = torch.device("cuda")
    q, k, v, tables, seq, pos = [
        torch.from_numpy(a).to(dev) for a in _case(h=h, kvh=kvh, hd=hd, ps=16)
    ]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, seq, pos)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err


# ---------------------------------------------------------------------------
# the plan and the split/merge emulation
# ---------------------------------------------------------------------------


def _ragged_case(rows, *, h=4, kvh=2, hd=16, ps=8, num_pages=None, t_buf=None,
                 p_cols=None, shuffle=False, last_page_row=None, seed=0):
    """A step of ``rows`` ((start, n) per sequence) in one buffer, padding
    tokens on the null row after them; pages drawn at random from the
    arena (page 0 is the null page).  ``shuffle`` permutes the buffer, so a
    sequence's tokens are not side by side; ``last_page_row`` ends that
    row on the arena's last page."""
    rng = np.random.default_rng(seed)
    need = [(start + n - 1) // ps + 1 for start, n in rows]
    p_cols = p_cols or max(need)
    num_pages = num_pages or sum(need) + 3
    s_rows = len(rows)
    tables = np.zeros((s_rows + 1, p_cols), np.int32)
    free = rng.permutation(np.arange(1, num_pages - 1)).tolist()
    for s, n_pages in enumerate(need):
        tables[s, :n_pages] = [free.pop() for _ in range(n_pages)]
    if last_page_row is not None:
        tables[last_page_row, need[last_page_row] - 1] = num_pages - 1
    n_tok = sum(n for _, n in rows)
    t_buf = t_buf or n_tok + 2
    pos = np.zeros(t_buf, np.int32)
    seq = np.full(t_buf, s_rows, np.int32)
    ti = 0
    for s, (start, n) in enumerate(rows):
        pos[ti:ti + n] = np.arange(start, start + n)
        seq[ti:ti + n] = s
        ti += n
    if shuffle:
        perm = rng.permutation(t_buf)
        pos, seq = pos[perm], seq[perm]
    k = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    q = rng.standard_normal((t_buf, h, hd)).astype(np.float32)
    return q, k, v, tables, seq, pos


def _plan(seq, pos, *, ps, p_cols, h, kvh, device=None, weighted=False):
    """The plan of the float32 kernel (pages weighted by rows per warp)
    with ``weighted``, else of the bf16 kernel."""
    return pa.build_plan(seq, pos, page_size=ps, pages_per_seq=p_cols,
                         n_heads=h, n_kv_heads=kvh, device=device,
                         dtype=torch.float32 if weighted else torch.bfloat16)


@st.composite
def _steps(draw):
    h, kvh = draw(st.sampled_from([(4, 2), (32, 8), (8, 8), (16, 1)]))
    ps = draw(st.sampled_from([8, 16]))
    rows = draw(st.lists(
        st.tuples(st.integers(0, 6000), st.sampled_from([1, 1, 1, 5, 12, 17, 40])),
        min_size=1, max_size=7))
    n_pad = draw(st.integers(0, 20))
    seed = draw(st.integers(0, 2**16))
    return h, kvh, ps, rows, n_pad, seed, draw(st.booleans())


@settings(max_examples=150, deadline=None)
@given(step=_steps())
def test_plan_partitions_the_step(step):
    h, kvh, ps, rows, n_pad, seed, weighted = step
    rng = np.random.default_rng(seed)
    s_rows = len(rows)
    pos = np.concatenate([np.arange(a, a + n) for a, n in rows] + [np.zeros(n_pad, np.int64)])
    seq = np.concatenate([np.full(n, s) for s, (_, n) in enumerate(rows)]
                         + [np.full(n_pad, s_rows)])
    perm = rng.permutation(len(pos))
    pos, seq = pos[perm].astype(np.int32), seq[perm].astype(np.int32)
    p_cols = int(pos.max()) // ps + 1 + int(rng.integers(0, 3))
    plan = _plan(seq, pos, ps=ps, p_cols=p_cols, h=h, kvh=kvh, weighted=weighted)
    items, groups, splits = plan.items.numpy(), plan.groups.numpy(), plan.splits.numpy()
    t = len(pos)
    tpg = min(16, 64 // (h // kvh))
    assert plan.tokens_per_group == tpg

    # every token in exactly one group; a group is one sequence, <= tpg tokens
    n_groups = int((groups[:, 1] > 0).sum())
    seen = np.zeros(t, np.int64)
    for g in range(n_groups):
        row, n = groups[g, :2]
        toks = groups[g, 2:2 + n]
        assert 1 <= n <= tpg and n * (h // kvh) <= pa.MAX_GROUP_ROWS
        assert (groups[g, 2 + n:] == -1).all()
        assert (seq[toks] == row).all()
        seen[toks] += 1
    assert (seen == 1).all() and (groups[n_groups:, 1] == 0).all()

    # every (token, KV head, page <= pos // ps) in exactly one item: the grid
    # runs every item for every KV head, so count (token, page) per item
    cover = np.zeros((t, p_cols), np.int64)
    for grp, first, end, _ in items[:plan.n_items]:
        row, n = groups[grp, :2]
        assert 0 <= first < end <= p_cols
        cover[groups[grp, 2:2 + n], first:end] += 1
    reach = np.arange(p_cols)[None, :] <= (pos // ps)[:, None]
    assert (cover[reach] == 1).all()
    assert (items[plan.n_items:, 0] == -1).all()

    # sizes: at most span pages an item, at least span // 2 when split; with
    # row weighting a page of group g costs w = ceil(rows / 4) and an item
    # costs at most span + w - 1
    size = items[:plan.n_items, 2] - items[:plan.n_items, 1]
    split = items[:plan.n_items, 3] >= 0
    assert size.min() >= 1
    if weighted:
        w = -(-groups[items[:plan.n_items, 0], 1] * (h // kvh) // 4)
        assert (size * w <= plan.span + w - 1).all()
    else:
        assert size.max() <= plan.span
        assert (size[split] >= plan.span // 2).all()
    # split items carry their own slot; the split list names their runs
    assert (items[:plan.n_items, 3][split] == np.flatnonzero(split)).all()
    for grp, first, n in splits[:plan.n_splits]:
        assert n >= 2 and (items[first:first + n, 0] == grp).all()
    assert int(split.sum()) == int(splits[:plan.n_splits, 2].sum())
    assert (splits[plan.n_splits:, 0] == -1).all()

    # static shapes: the same step shape with other contents
    other = _plan(np.full(t, s_rows, np.int32), np.zeros(t, np.int32), ps=ps,
                  p_cols=p_cols, h=h, kvh=kvh)
    for a, b in ((plan.items, other.items), (plan.groups, other.groups),
                 (plan.splits, other.splits)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.int32
    assert plan.items.shape[0] == pa.plan_capacity(t, kvh)[0]


SPLIT_CASES = {
    "mixed": dict(rows=[(60, 1), (9, 1), (5, 6), (27, 5)]),
    "long_and_short": dict(rows=[(3000, 1), (7, 1), (100, 3), (1900, 1)], ps=16),
    "prefill_over_16": dict(rows=[(3, 20), (50, 1), (0, 33)], shuffle=True),
    "gqa_8": dict(rows=[(300, 12), (2, 1), (77, 5)], h=16, kvh=2, shuffle=True),
    "last_page": dict(rows=[(20, 1), (35, 4)], last_page_row=1),
    "wide_table": dict(rows=[(5000, 1), (7, 2), (4500, 3)], ps=4),  # 1251 pages a row
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_emulation_matches_plain_version(name, weighted):
    case = _ragged_case(**SPLIT_CASES[name])
    q, k, v, tables, seq, pos = map(torch.from_numpy, case)
    plan = _plan(seq.numpy(), pos.numpy(), ps=k.shape[1], p_cols=tables.shape[1],
                 h=q.shape[1], kvh=k.shape[2], weighted=weighted)
    got = pa.paged_attention_planned(q, k, v, tables, pos, plan)
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_plan_rejects_what_the_kernel_does_not_take():
    seq = np.zeros(4, np.int32)
    pos = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="query heads"):
        _plan(seq, pos, ps=16, p_cols=4, h=6, kvh=4)
    with pytest.raises(ValueError, match="query heads"):
        _plan(seq, pos, ps=16, p_cols=4, h=128, kvh=1)
    plan = _plan(seq, pos, ps=16, p_cols=4, h=4, kvh=2)
    q = torch.zeros((5, 4, 16))
    with pytest.raises(ValueError, match="another step shape"):
        pa.check_plan(plan, q, 2)


@pytest.mark.parametrize("sms", [pa.DEFAULT_SMS, 1000])
def test_plan_caps_runs_at_the_merge_bound_not_the_table_width(sms, monkeypatch):
    """A 20000-page row over one KV head, on an H100's SM count and on a
    card with 1000 SMs: the plan cuts no group into more runs than the
    merge pass holds, and the kernel's checks take the row (only the
    device check fails on CPU tensors)."""
    monkeypatch.setattr(pa, "DEFAULT_SMS", sms)
    p_cols, ps = 20000, 4
    seq = np.array([0, 1, 2, 2], np.int32)
    pos = np.array([p_cols * ps - 1, 9, 40000, 40001], np.int32)
    plan = _plan(seq, pos, ps=ps, p_cols=p_cols, h=8, kvh=1)
    runs = np.bincount(plan.items[:plan.n_items, 0].numpy())
    cap_runs = pa.plan_capacity(len(seq), 1)[0] - len(seq)
    assert cap_runs == min(pa.BLOCKS_PER_SM * sms, pa.MAX_MERGE_RUNS)
    assert 1 < runs.max() <= cap_runs
    q = torch.zeros((4, 8, 16))
    k = torch.zeros((8, ps, 1, 16))
    tables = torch.zeros((4, p_cols), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.check_kernel_args(q, k, k, tables, torch.from_numpy(seq), torch.from_numpy(pos))


PARTITION_CASES = {
    "prefill_over_16": dict(rows=[(3, 20), (50, 1), (200, 1)]),
    "not_adjacent": dict(rows=[(300, 12), (2, 1), (77, 5), (900, 1)], shuffle=True),
    "last_page": dict(rows=[(20, 1), (35, 4), (640, 1)], last_page_row=2),
    "one_and_many_runs": dict(rows=[(8190, 1), (5, 1), (40, 3), (2040, 5), (0, 1)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 16), (32, 8, 128)])
@pytest.mark.parametrize("name", sorted(PARTITION_CASES))
def test_kernel_partition_cases_on_card(name, dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, kvh, hd = shape
    dev = torch.device("cuda")
    case = _ragged_case(**PARTITION_CASES[name], h=h, kvh=kvh, hd=hd, ps=16)
    q, k, v, tables, seq, pos = [torch.from_numpy(a).to(dev) for a in case]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    plan = pa.build_plan(case[4], case[5], page_size=16, pages_per_seq=tables.shape[1],
                         n_heads=h, n_kv_heads=kvh, dtype=dtype, device=dev)
    if name == "one_and_many_runs":
        runs = np.bincount(plan.items[:plan.n_items, 0].cpu().numpy())
        assert runs.min() == 1 and runs.max() > 1
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, seq, pos, plan=plan)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err
    # the plan serves every layer of a step: a second call gives the same bits
    assert torch.equal(pa.paged_attention(q, k, v, tables, seq, pos, plan=plan), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 16), (32, 8, 128)])
def test_kernel_pages_smaller_than_a_tile_on_card(dtype, shape):
    """Page size 8: the second half of every 16-key tile is padding the
    kernel must keep at zero weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, kvh, hd = shape
    dev = torch.device("cuda")
    case = _ragged_case(**PARTITION_CASES["not_adjacent"], h=h, kvh=kvh, hd=hd, ps=8)
    q, k, v, tables, seq, pos = [torch.from_numpy(a).to(dev) for a in case]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    got = pa.paged_attention(q, k, v, tables, seq, pos)  # the wrapper builds the plan
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 16), (32, 8, 128)])
def test_kernel_rows_wider_than_1024_pages_on_card(ps, dtype, shape):
    """Page-table rows of more than 1024 pages: an 8192-token context at
    page size 4, a 20000-token context at page size 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, kvh, hd = shape
    dev = torch.device("cuda")
    longest = 8191 if ps == 4 else 19999
    case = _ragged_case([(longest, 1), (longest // 2, 3), (10, 1)], h=h, kvh=kvh, hd=hd, ps=ps)
    q, k, v, tables, seq, pos = [torch.from_numpy(a).to(dev) for a in case]
    assert tables.shape[1] > 1024
    q, k, v = (x.to(dtype) for x in (q, k, v))
    got = pa.paged_attention(q, k, v, tables, seq, pos)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err


def test_per_token_gate_sees_a_lost_run_on_long_rows():
    """``chip_smoke.py``'s per-token gate on its 8192-token case (here at
    small widths): a merge that leaves out one run of a split group moves
    the long rows' small outputs by less than the 6e-2 absolute tolerance
    can see, but by far more than the per-token bound."""
    import chip_smoke

    case = chip_smoke.attention_case(torch, torch.device("cpu"), chip_smoke.LONG_ROWS,
                                     h=4, kvh=2, hd=16)
    q, k, v, tables, seq, pos = case
    plan = _plan(seq.numpy(), pos.numpy(), ps=16, p_cols=tables.shape[1], h=4, kvh=2)
    want = pa.paged_attention_reference(*case)

    def row_rel(got):
        diff = (got - want).abs()
        return (diff.amax((1, 2)) / want.abs().amax((1, 2))).max().item()

    bound = chip_smoke.KERNEL_ROW_REL["bfloat16"]
    assert row_rel(pa.paged_attention_planned(q, k, v, tables, pos, plan)) <= 1e-5
    assert plan.n_splits >= 2
    abs_errs = []
    for i in range(plan.n_splits):
        splits = plan.splits.clone()
        splits[i, 2] -= 1  # the merge leaves out the group's last run
        got = pa.paged_attention_planned(q, k, v, tables, pos, dataclasses.replace(plan, splits=splits))
        assert row_rel(got) > bound
        abs_errs.append((got - want).abs().max().item())
    assert min(abs_errs) < chip_smoke.KERNEL_ATOL["bfloat16"]
