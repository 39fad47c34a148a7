"""The Hopper schedule of the dense causal attention kernels (B9,
``cordum_tpu_torch/csrc/dense_attention.cu``), emulated in plain Python and
held against the mask.

The bf16 kernels at head_dim 64 and 128 cut the work into tiles whose spans
come from ``positions`` (any positions, not only ``arange``):

* forward and dQ: blocks of two consumers of 64 rows each; a row is a
  (position, head) pair, ``g`` query heads of one KV head a position (``g``
  the largest power of two dividing H / KVH, at most 16).  A consumer
  visits the key tiles below its span (its largest position + 1, or T when a
  row has no live key; in dQ a row at a negative position sends no
  gradient and adds no span) and masks only the tiles where a key is dead
  for one of its rows ("open" tiles are not masked);
* dK/dV: blocks of 128 keys, 64 a consumer; the query tiles that reach the
  block's keys (a bit each, from the positions), for every query head of
  the group; both consumers compute every such item, masking it unless
  every row reaches all their keys.

The tile sizes are read from the CUDA source, so the emulation follows it.
Checks: on random T, group sizes and positions (negative ones and ones past
T included), every contributing (query, key) pair is visited exactly once,
a skipped tile holds none and an open tile holds only live pairs; and a
tiled fp32 emulation of the forward and backward (with bf16's D pass:
sum_k P dP a row over the dQ schedule) over exactly the visited
tiles, masking only the tiles the kernel masks, equals the plain version at
1e-5 of each tensor's largest value (the sums run in another order).  The
same checks hold for a sequence-parallel rank's chunk: Tq query rows at
their global positions against Tk keys (rows and query tiles over Tq, key
tiles and dK/dV blocks over Tk).
"""
from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cordum_tpu_torch.ops import dense_attention as da

SRC = da.SOURCE.read_text()
CONSUMER_ROWS = 64  # a warpgroup's wgmma M


def _const(struct: str, name: str) -> int:
    body = SRC[SRC.index(f"struct {struct} {{"):]
    body = body[:body.index("};")]
    return int(re.search(rf"static constexpr int {name} = (\d+);", body).group(1))


FWD_KEYS = _const("HopperFwd", "BN")
DQ_KEYS = _const("HopperDq", "BK")
DKV_KEYS = _const("HopperDkv", "BK")
DKV_ROWS = _const("HopperDkv", "BQ")


def group_of(h: int, kvh: int) -> int:
    rep = h // kvh
    return min(rep & -rep, 16)


def consumers(t_len: int, h: int, kvh: int):
    """Every forward/dQ consumer with rows: ``(t0, t1, h0, g)``, positions
    ``t0 .. t1`` (below T) of heads ``h0 .. h0 + g``."""
    g = group_of(h, kvh)
    per = CONSUMER_ROWS // g
    for b0 in range(0, t_len, 2 * per):
        for h0 in range(0, h, g):
            for c in range(2):
                t0 = b0 + c * per
                if t0 < t_len:
                    yield t0, min(t0 + per, t_len), h0, g


def key_tiles(pos_rows: np.ndarray, t_len: int, tile: int, dq: bool):
    """A consumer's visited key tiles and the open ones among them."""
    lo = int(pos_rows.min())
    spans = np.where(pos_rows < 0, 0 if dq else t_len, np.minimum(t_len, pos_rows + 1))
    n = -(-int(spans.max()) // tile)
    open_ = {j for j in range(n) if (j + 1) * tile <= t_len and (j + 1) * tile - 1 <= lo}
    return list(range(n)), open_


def dkv_items(pos_b: np.ndarray, t_len: int, rep: int, tk: int | None = None):
    """Every dK/dV consumer's items: ``(kc, [(head r, query tile, open)])``;
    ``t_len`` query rows (the positions' length), ``tk`` keys (default
    ``t_len``)."""
    tk = t_len if tk is None else tk
    n_qt = -(-t_len // DKV_ROWS)
    for k0 in range(0, tk, DKV_KEYS):
        need = []
        for qt in range(n_qt):
            p = pos_b[qt * DKV_ROWS:(qt + 1) * DKV_ROWS]
            need.append(bool(((p < 0) | (p >= k0)).any()))
        for c in range(2 if k0 + 64 < tk else 1):
            kc = k0 + 64 * c
            items = []
            for r in range(rep):
                for qt in range(n_qt):
                    if not need[qt]:
                        continue
                    p = pos_b[qt * DKV_ROWS:(qt + 1) * DKV_ROWS]
                    lo = int(p.min()) if len(p) == DKV_ROWS else -1  # -1: the tile passes T
                    items.append((r, qt, lo >= kc + 63 and kc + 63 < tk))
            yield kc, items


# ---------------------------------------------------------------------------
# coverage of the mask
# ---------------------------------------------------------------------------


@st.composite
def _cases(draw):
    t_len = draw(st.integers(1, 400))
    kvh = draw(st.sampled_from([1, 2]))
    rep = draw(st.sampled_from([1, 2, 3, 4, 8, 16]))
    kind = draw(st.sampled_from(["arange", "packed", "random"]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    if kind == "arange":
        pos = np.arange(t_len)
    elif kind == "packed":  # two sequences in one row, a row at -1
        cut = int(rng.integers(0, t_len + 1))
        pos = np.concatenate([np.arange(cut), np.arange(t_len - cut)])
        pos[int(rng.integers(0, t_len))] = -1
    else:
        pos = rng.integers(-3, t_len + 20, t_len)
    return t_len, kvh, rep, pos.astype(np.int64)


def _live(pos_rows: np.ndarray, keys: np.ndarray, t_len: int, uniform: bool) -> np.ndarray:
    """rows x keys: whether a key counts for a row, causally, and, with
    ``uniform``, every key for a row without a live key (its weights)."""
    p = pos_rows[:, None]
    return (keys[None, :] < t_len) & ((keys[None, :] <= p) & (p >= 0) | (uniform & (p < 0)))


@settings(max_examples=150, deadline=None)
@given(case=_cases())
def test_row_schedule_visits_every_live_pair_once(case):
    """Forward and dQ: each row in exactly one consumer; its live keys all
    in the consumer's visited tiles (a skipped tile holds none); an open
    tile holds only live pairs."""
    t_len, kvh, rep, pos = case
    _check_row_schedule(t_len, t_len, kvh, rep, pos)


def _check_row_schedule(tq, tk, kvh, rep, pos):
    h = kvh * rep
    seen = np.zeros((tq, h), np.int64)
    checked = set()
    for t0, t1, h0, g in consumers(tq, h, kvh):
        seen[t0:t1, h0:h0 + g] += 1
        if (t0, t1) in checked:  # the same positions in every head group
            continue
        checked.add((t0, t1))
        rows = pos[t0:t1]
        for tile, dq in ((FWD_KEYS, False), (DQ_KEYS, True)):
            visited, open_ = key_tiles(rows, tk, tile, dq)
            keys = np.arange(max(tk, len(visited) * tile))
            counts = _live(rows, keys, tk, uniform=not dq)
            assert not counts[:, len(visited) * tile:].any(), (tile, visited)
            for j in open_:
                assert _live(rows, np.arange(j * tile, (j + 1) * tile), tk, False).all()
    assert (seen == 1).all()


@settings(max_examples=150, deadline=None)
@given(case=_cases())
def test_dkv_schedule_visits_every_contributing_pair_once(case):
    """dK/dV: for the keys of each consumer, every (query head, row) pair
    that sends them a weight (dV) or dS (dK) lies in exactly one item;
    tiles left out send nothing; an open item holds only live pairs."""
    t_len, kvh, rep, pos = case
    _check_dkv_schedule(t_len, t_len, rep, pos)


def _check_dkv_schedule(tq, tk, rep, pos):
    for kc, items in dkv_items(pos, tq, rep, tk):
        keys = np.arange(kc, min(kc + 64, tk))
        counts = np.zeros((rep, tq), np.int64)
        for r, qt, open_ in items:
            rows = slice(qt * DKV_ROWS, min((qt + 1) * DKV_ROWS, tq))
            counts[r, rows] += 1
            if open_:
                assert _live(pos[rows], keys, tk, uniform=False).all()
        sends = _live(pos, keys, tk, uniform=True).any(1)
        assert (counts <= 1).all()
        assert (counts[:, sends] == 1).all()


@st.composite
def _chunk_cases(draw):
    """A sequence-parallel rank's chunk: Tq rows at ``first ..`` against Tk
    keys (``first + Tq <= Tk``), or rows at random positions (negative ones
    and ones past Tk included) against keys of another length."""
    tq = draw(st.integers(1, 300))
    tk = draw(st.integers(1, 400))
    kvh = draw(st.sampled_from([1, 2]))
    rep = draw(st.sampled_from([1, 2, 4, 8, 16]))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    if draw(st.booleans()) and tq <= tk:
        first = int(rng.integers(0, tk - tq + 1))
        pos = np.arange(first, first + tq)
    else:
        pos = rng.integers(-3, tk + 20, tq)
    return tq, tk, kvh, rep, pos.astype(np.int64)


@settings(max_examples=150, deadline=None)
@given(case=_chunk_cases())
def test_chunk_row_schedule_visits_every_live_pair_once(case):
    """Forward and dQ over a chunk: each of its Tq rows in one consumer;
    its live keys (of Tk) all in the visited tiles; open tiles all live."""
    _check_row_schedule(*case)


@settings(max_examples=150, deadline=None)
@given(case=_chunk_cases())
def test_chunk_dkv_schedule_visits_every_contributing_pair_once(case):
    """dK/dV over Tk keys, query tiles over the chunk's Tq rows."""
    tq, tk, _, rep, pos = case
    _check_dkv_schedule(tq, tk, rep, pos)


# ---------------------------------------------------------------------------
# a tiled fp32 emulation over exactly the visited tiles
# ---------------------------------------------------------------------------


def _mask(pos_rows: torch.Tensor, keys: torch.Tensor, t_len: int) -> torch.Tensor:
    """The kernels' masked score semantics: 1 where the key counts (a row
    without a live key counts every key below T, at score 0)."""
    p = pos_rows[:, None]
    return (keys[None, :] < t_len) & ((keys[None, :] <= p) | (p < 0))


def tiled_forward(q, k, v, pos):
    """(out, lse) over the forward schedule: an online softmax over each
    consumer's visited key tiles, masking only the tiles it masks (T query
    rows, ``tk`` keys)."""
    b_, t_len, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    scale = 1 / math.sqrt(hd)
    out = torch.zeros_like(q)
    lse = torch.zeros(b_, h, t_len)
    for b in range(b_):
        for t0, t1, h0, g in consumers(t_len, h, kvh):
            rows = pos[b, t0:t1]
            visited, open_ = key_tiles(rows.numpy(), tk, FWD_KEYS, dq=False)
            kv = h0 // (h // kvh)
            qr = q[b, t0:t1, h0:h0 + g].reshape(-1, hd)  # (position, head) rows
            pr = rows.repeat_interleave(g)
            m = torch.full((len(pr),), -math.inf)
            l = torch.zeros(len(pr))
            o = torch.zeros(len(pr), hd)
            for j in visited:
                keys = torch.arange(j * FWD_KEYS, (j + 1) * FWD_KEYS)
                kt = k[b, keys.clamp(max=tk - 1), kv] * (keys < tk)[:, None]
                vt = v[b, keys.clamp(max=tk - 1), kv] * (keys < tk)[:, None]
                s = qr @ kt.T * scale
                if j not in open_:
                    ok = _mask(pr, keys, tk)
                    s = torch.where(ok, torch.where(pr[:, None] < 0, 0.0, s), -math.inf)
                mn = torch.maximum(m, s.max(1).values)
                mu = torch.where(mn == -math.inf, 0.0, mn)
                alpha = torch.exp(m - mu)
                w = torch.exp(s - mu[:, None])
                l = l * alpha + w.sum(1)
                o = o * alpha[:, None] + w @ vt
                m = mn
            out[b, t0:t1, h0:h0 + g] = (o / l[:, None]).reshape(t1 - t0, g, hd)
            lse[b, h0:h0 + g, t0:t1] = (m + torch.log(l)).reshape(t1 - t0, g).T
    return out, lse


def tiled_backward(q, k, v, pos, lse, do):
    """(dq, dk, dv) over the D, dQ and dK/dV schedules, from the saved lse:
    the D pass (sum_k P dP a row, bf16's D) sweeps the dQ schedule without
    its product, so a key tile it skipped would leave D short."""
    b_, t_len, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1 / math.sqrt(hd)
    dmat = torch.zeros(b_, h, t_len)  # D [B, H, T]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for d_pass in (True, False):
        for b in range(b_):
            for t0, t1, h0, g in consumers(t_len, h, kvh):
                rows = pos[b, t0:t1]
                visited, open_ = key_tiles(rows.numpy(), tk, DQ_KEYS, dq=True)
                kv = h0 // rep
                qr = q[b, t0:t1, h0:h0 + g].reshape(-1, hd)
                dor = do[b, t0:t1, h0:h0 + g].reshape(-1, hd)
                pr = rows.repeat_interleave(g)
                lr = lse[b, h0:h0 + g, t0:t1].T.reshape(-1)
                dr = dmat[b, h0:h0 + g, t0:t1].T.reshape(-1)
                acc = torch.zeros(len(pr), hd)
                dsum = torch.zeros(len(pr))
                for j in visited:
                    keys = torch.arange(j * DQ_KEYS, (j + 1) * DQ_KEYS)
                    kt = k[b, keys.clamp(max=tk - 1), kv] * (keys < tk)[:, None]
                    vt = v[b, keys.clamp(max=tk - 1), kv] * (keys < tk)[:, None]
                    prob = torch.exp(qr @ kt.T * scale - lr[:, None])
                    if j not in open_:
                        live = _mask(pr, keys, tk) & (pr[:, None] >= 0)
                        prob = torch.where(live, prob, 0.0)
                    if d_pass:
                        dsum += (prob * (dor @ vt.T)).sum(1)
                    else:
                        acc += prob * (dor @ vt.T - dr[:, None]) * scale @ kt
                if d_pass:
                    dmat[b, h0:h0 + g, t0:t1] = dsum.reshape(t1 - t0, g).T
                else:
                    dq[b, t0:t1, h0:h0 + g] = acc.reshape(t1 - t0, g, hd)
    for b in range(b_):
        for kv in range(kvh):
            for kc, items in dkv_items(pos[b].numpy(), t_len, rep, tk):
                keys = torch.arange(kc, min(kc + 64, tk))
                kb, vb = k[b, keys, kv], v[b, keys, kv]
                for r, qt, open_ in items:
                    hh = kv * rep + r
                    rows = torch.arange(qt * DKV_ROWS, min((qt + 1) * DKV_ROWS, t_len))
                    qt_, dot = q[b, rows, hh], do[b, rows, hh]
                    pr = pos[b, rows]
                    lt, dt = lse[b, hh, rows], dmat[b, hh, rows]
                    st_ = kb @ qt_.T * scale  # S^T: keys x rows
                    if open_:
                        pt = torch.exp(st_ - lt[None, :])
                        dst = pt * (vb @ dot.T - dt[None, :]) * scale
                    else:
                        ok = _mask(pr, keys, tk).T
                        lv = ok & (pr[None, :] >= 0)
                        pt = torch.where(ok, torch.exp(torch.where(lv, st_, 0.0) - lt[None, :]), 0.0)
                        dst = torch.where(lv, pt * (vb @ dot.T - dt[None, :]) * scale, 0.0)
                    dv[b, keys, kv] += pt @ dot
                    dk[b, keys, kv] += dst @ qt_
    return dq, dk, dv


def _case(b, t_len, kvh, rep, hd, pos, seed, tk=None):
    rng = np.random.default_rng(seed)
    h = kvh * rep
    q, do = (torch.from_numpy(rng.standard_normal((b, t_len, h, hd)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk or t_len, kvh, hd)).astype(np.float32))
            for _ in range(2))
    return q, k, v, do, torch.from_numpy(np.asarray(pos, np.int64))


def _positions(kind, b, t_len, seed):
    rng = np.random.default_rng(seed)
    if kind == "arange":
        return np.broadcast_to(np.arange(t_len), (b, t_len)).copy()
    if kind == "packed":  # two sequences a row, one row at -1
        cut = t_len // 3
        row = np.concatenate([np.arange(cut), np.arange(t_len - cut)])
        pos = np.broadcast_to(row, (b, t_len)).copy()
        pos[0, t_len // 2] = -1
        return pos
    return rng.integers(-2, t_len + 10, (b, t_len))


@pytest.mark.parametrize("kind", ["arange", "packed", "random"])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_tiled_emulation_matches_plain_version(hd, rep, kind):
    """fp32 forward and backward over exactly the visited tiles (T 161:
    two forward key tiles, three dQ tiles, two dK/dV key blocks of which the
    last has one consumer) equal autograd of the plain version at 1e-5."""
    b, t_len, kvh = 2, 161, 1
    pos = _positions(kind, b, t_len, seed=hd + rep)
    q, k, v, do, pos_t = _case(b, t_len, kvh, rep, hd, pos, seed=7 * hd + rep)
    out, lse = tiled_forward(q, k, v, pos_t)
    grads = tiled_backward(q, k, v, pos_t, lse, do)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = da.dense_attention_reference(qr, kr, vr, pos_t)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), do)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
        err = (got - want.detach()).abs().max().item() / max(want.abs().max().item(), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("tq, tk, first", [(97, 161, 64), (65, 200, 135), (40, 161, 0)])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("hd", [16, 128])
def test_tiled_emulation_of_a_chunk_matches_plain_version(hd, rep, tq, tk, first):
    """A chunk of Tq rows at ``first ..`` against Tk keys (the last chunk,
    a middle one whose later keys get no gradient, the first): the fp32
    tiled forward and backward over exactly the visited tiles equal
    autograd of the plain version at 1e-5."""
    b = 2
    pos = np.broadcast_to(np.arange(first, first + tq), (b, tq)).copy()
    q, k, v, do, pos_t = _case(b, tq, 1, rep, hd, pos, seed=hd + rep + tq, tk=tk)
    out, lse = tiled_forward(q, k, v, pos_t)
    grads = tiled_backward(q, k, v, pos_t, lse, do)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = da.dense_attention_reference(qr, kr, vr, pos_t)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), do)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
        err = (got - want.detach()).abs().max().item() / max(want.abs().max().item(), 1e-30)
        assert err <= 1e-5, (name, err)
