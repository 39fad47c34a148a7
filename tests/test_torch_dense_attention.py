"""Parity of the port's dense causal attention (``cordum_tpu_torch/ops/
dense_attention.py``, B9) with the JAX package's ``_attention``
(``cordum_tpu/models/llama.py``), forward and gradient.

The same inputs, made from a seed with numpy, go through JAX's
``_attention`` (and ``jax.vjp`` of it) and through the port on the CPU,
where the wrapper runs the plain version (autograd of ``gqa_attention``).
Cases: head widths 16, 64 and 128, GQA groups of 1, 2 and 4 query heads a
KV head, T 1, 17 and 64, fp32 and bf16, positions ``arange(T)`` as
``forward`` passes them; and positions other than ``arange`` (a negative
position, whose row has no live key and attends uniformly to every key,
and positions past T) in fp32.  Tolerances, each over the largest
``|value|`` of the reference tensor:

* fp32: 1e-5 for the output and every gradient — the two frameworks sum the
  einsums and the softmax in other orders, a few fp32 ulps of O(1) values;
* bf16: 2e-2 — both round the scores, the probabilities, the output, dP and
  dS to bf16 at the same points, so what differs is a rounding flipped by
  the fp32 sum order (2^-8 relative); on a score of magnitude ~4 such a
  flip moves a probability by ~1.5%, so outputs and gradients move by up
  to a few bf16 ulps of their largest value.

The ``gpu``-marked tests hold the CUDA kernels against the plain version on
the card, at those shapes and at T 2048 (B 2), forward and backward, on the
same seeded ``dO``.  fp32: output 1e-5 absolute, gradients 1e-4 relative to
their largest value (the kernels sum over up to 2048 keys, and dK/dV over 4
query heads, in another order).  Further ``gpu`` cases: T at the edges of
the Hopper kernels' tiles (1 .. 2048) with 1, 4 and 8 query heads a KV head,
positions of two packed sequences with a row at -1, and two backward calls
that must give the same bits.  bf16 is held row by row by
``chip_smoke.py``'s gate (``bf16_row_gate``): a long row's output and a
late key's dk and dv are small beside their tensor's largest value, so a
gate on that largest value would pass a wrong row.  For each query row of
out and dq and each key row of dk and dv, the max error from the exact
result (the plain version in fp32 on the same bf16-rounded inputs and dO)
over the row's largest ``|exact|`` value, or over 2^-8 of the tensor's
largest where the row is smaller; the kernel's worst row within twice the
bf16 plain version's worst row, plus 2^-9.  On the card (no JAX there) run them with
``python -m pytest --noconftest -m gpu tests/test_torch_dense_attention.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cordum_tpu_torch.ops import dense_attention as da

CPU_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
KERNEL_OUT_ATOL = 1e-5  # fp32
KERNEL_GRAD_REL = 1e-4  # fp32
HEAD_DIMS = (16, 64, 128)
REPS = (1, 2, 4)
LENGTHS = (1, 17, 64)


def _case(b, t, kvh, rep, hd, *, seed=0, positions=None):
    """q, k, v, dO (fp32 numpy) and int32 positions; ``arange`` by default."""
    rng = np.random.default_rng(seed)
    h = kvh * rep
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    do = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    if positions is None:
        positions = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return q, k, v, do, positions


def _torch_grads(q, k, v, do, pos, dtype, device="cpu"):
    """Output and (dq, dk, dv) of the port's ``dense_attention`` in
    ``dtype`` on ``device``, as fp32 numpy."""
    q_t, k_t, v_t = (torch.from_numpy(x).to(device=device, dtype=dtype).requires_grad_()
                     for x in (q, k, v))
    out = da.dense_attention(q_t, k_t, v_t, torch.from_numpy(pos).to(device))
    grads = torch.autograd.grad(out, (q_t, k_t, v_t),
                                torch.from_numpy(do).to(device=device, dtype=dtype))
    return [x.detach().float().cpu().numpy() for x in (out, *grads)]


def _jax_grads(q, k, v, do, pos, dtype):
    import jax
    import jax.numpy as jnp

    from cordum_tpu.models import llama as jl

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    h, kvh = q.shape[2], k.shape[2]
    cfg = jl.LlamaConfig(n_heads=h, n_kv_heads=kvh, d_model=h * q.shape[3], dtype=jdt)

    @jax.jit
    def run(q_, k_, v_, do_, pos_):
        out, vjp = jax.vjp(lambda a, b_, c: jl._attention(a, b_, c, cfg, q_offset=pos_),
                           q_, k_, v_)
        return (out, *vjp(do_))

    res = run(*(jnp.asarray(x, jdt) for x in (q, k, v, do)), jnp.asarray(pos))
    return [np.asarray(x.astype(jnp.float32)) for x in res]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_version_matches_jax_attention_and_vjp(hd, rep, t, dtype):
    q, k, v, do, pos = _case(2, t, 2, rep, hd, seed=hd + 7 * rep + t)
    got = _torch_grads(q, k, v, do, pos, dtype)
    want = _jax_grads(q, k, v, do, pos, dtype)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= CPU_REL[dtype], (name, _rel_err(g, w))


def test_plain_version_matches_jax_with_other_positions():
    """A row at position -1 has no live key (uniform over every key, no
    gradient into q or k through it); rows past T see every key."""
    t = 12
    pos = np.array([[-1, 0, 5, 3, 11, 20, 2, 2, 7, 1, 9, 30],
                    [4, 4, 4, 0, 1, 2, 3, 15, -3, 6, 6, 11]], np.int32)
    q, k, v, do, pos = _case(2, t, 2, 2, 16, seed=3, positions=pos)
    got = _torch_grads(q, k, v, do, pos, torch.float32)
    want = _jax_grads(q, k, v, do, pos, torch.float32)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= CPU_REL[torch.float32], name
    # the position -1 row: the mean of v over all keys, and no dq
    np.testing.assert_allclose(got[0][0, 0], np.repeat(v[0].mean(0), 2, axis=0), atol=1e-6)
    assert not got[1][0, 0].any()


def test_cpu_tensors_take_the_plain_version():
    q, k, v, _, pos = _case(1, 5, 1, 2, 16)
    before = (da.dense_attention_fwd.launches, da.dense_attention_bwd.launches)
    out = da.dense_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)))
    want = da.gqa_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            q_offset=torch.from_numpy(pos))
    assert torch.equal(out, want)
    assert (da.dense_attention_fwd.launches, da.dense_attention_bwd.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _, pos = (torch.from_numpy(x) for x in _case(1, 5, 1, 2, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        da.dense_attention_fwd(q, k, v, pos)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _row_gate(got, plain, exact):
    """``chip_smoke.bf16_row_gate`` on fp32 numpy (out, dq, dk, dv)."""
    import chip_smoke

    return chip_smoke.bf16_row_gate(*([torch.from_numpy(x) for x in xs]
                                      for xs in (got, plain, exact)))


def _kernel_vs_plain(b, t, kvh, rep, hd, dtype, *, seed=0, positions=None):
    """The kernels against the plain version on the card (see the module
    note)."""
    q, k, v, do, pos = _case(b, t, kvh, rep, hd, seed=seed, positions=positions)
    before = (da.dense_attention_fwd.launches, da.dense_attention_bwd.launches)
    got = _torch_grads(q, k, v, do, pos, dtype, device="cuda")
    torch.cuda.synchronize()
    assert (da.dense_attention_fwd.launches, da.dense_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(np.isfinite(g).all() for g in got)
    # the plain version on the card, on the same rounded inputs
    rounded = [torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v, do)]
    want = _plain_on_card(*rounded, pos, dtype)
    # a gradient that is exactly zero (T 1: a softmax over one key has none
    # for q and k) is held against the largest |dv| instead
    dv_max = float(np.abs(want[3]).max())
    if dtype == torch.float32:
        out_err = float(np.abs(got[0] - want[0]).max())
        assert out_err <= KERNEL_OUT_ATOL, out_err
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            err = float(np.abs(g - w).max()) / (float(np.abs(w).max()) or dv_max)
            assert err <= KERNEL_GRAD_REL, (name, err)
        return
    exact = _plain_on_card(*rounded, pos, torch.float32)
    gate = _row_gate(got, want, exact)
    assert all(g["ok"] for g in gate.values()), gate


def _spec_numerics(q, k, v, do, pos, *, d_from="weights"):
    """Out, dq, dk, dv as the head comment of ``csrc/dense_attention.cu``
    specifies the bf16 kernels, in plain torch on the CPU (fp32 numpy in,
    the values bf16-exact; fp32 numpy out): scores rounded to bf16 then
    scaled; weights exp(s - max) rounded to bf16 for PV, their fp32 sum
    divided out; P = exp(s - lse) in fp32, dP unrounded, D = sum_k P dP
    over the row's live keys; dS = P (dP - D) scale rounded to bf16; dV
    from the bf16 weights P.  ``d_from="output"`` takes D as the earlier
    kernels did instead, rowsum(dO * (out + out_lo)) with out_lo the
    output's rounding residual.  A row at a negative position attends
    uniformly and sends no dS; one softmax over all keys (the kernels'
    online softmax rounds at the running max of a tile)."""
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    pos_t = torch.from_numpy(pos).long()
    t, h, hd = q.shape[1], q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    kh, vh = (x.repeat_interleave(rep, 2) for x in (k, v))
    scale = 1 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh).to(bf).float() * scale
    p_ = pos_t[:, None, :, None]
    key = torch.arange(t, device=q.device)
    live = (key <= p_) & (p_ >= 0)
    counts = live | (p_ < 0)
    s = torch.where(p_ < 0, 0.0, s).masked_fill(~counts, float("-inf"))
    m = s.amax(-1, keepdim=True)
    w = torch.exp(s - m)
    l = w.sum(-1, keepdim=True)
    o32 = torch.einsum("bhqk,bkhd->bqhd", w.to(bf).float(), vh) / l.squeeze(-1).transpose(1, 2)[..., None]
    out = o32.to(bf).float()
    prob = torch.exp(s - (m + torch.log(l)))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vh)
    if d_from == "weights":
        d = torch.where(live, prob * dp, 0.0).sum(-1, keepdim=True)
    else:
        out_lo = (o32 - out).to(bf).float()
        d = (do * (out + out_lo)).sum(-1).transpose(1, 2)[..., None]
    ds = torch.where(live, prob * (dp - d) * scale, 0.0).to(bf).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh).to(bf).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", prob.to(bf).float(), do)
    b, kvh = k.shape[0], k.shape[2]
    dk = dk.reshape(b, t, kvh, rep, hd).sum(3).to(bf).float()
    dv = dv.reshape(b, t, kvh, rep, hd).sum(3).to(bf).float()
    return [x.numpy() for x in (out, dq, dk, dv)]


def _plain_on_card(q, k, v, do, pos, dtype):
    """Output and gradients of the plain version on the card in ``dtype``,
    as fp32 numpy."""
    q_t, k_t, v_t = (torch.from_numpy(x).cuda().to(dtype).requires_grad_() for x in (q, k, v))
    out = da.dense_attention_reference(q_t, k_t, v_t, torch.from_numpy(pos).cuda())
    grads = torch.autograd.grad(out, (q_t, k_t, v_t), torch.from_numpy(do).cuda().to(dtype))
    return [x.detach().float().cpu().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("fault, caught", [
    (None, set()),
    ("head-dropped", {"dk", "dv"}),
    ("late-rows-scaled", {"out"}),
])
def test_row_gate_refuses_a_wrong_row_the_max_gate_passes(fault, caught):
    """The bf16 row gate on the plain version's numbers (the CPU stands in
    for the card) refuses a dk/dv that leaves one query head of each KV
    group out of its sum, and an output whose last quarter of rows is off
    by a tenth, which the earlier gate (6e-2 absolute on out, 5e-2 of a
    gradient's largest value) passes; the bf16 plain version itself
    passes."""
    b, t, kvh, rep, hd = 1, 1024, 2, 2, 64
    q, k, v, do, pos = _case(b, t, kvh, rep, hd, seed=11)
    rounded = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do)]
    plain = _torch_grads(*rounded, pos, torch.bfloat16)
    exact = _torch_grads(*rounded, pos, torch.float32)
    got = [x.copy() for x in plain]
    if fault == "head-dropped":
        do_drop = rounded[3].copy()
        do_drop[:, :, rep - 1::rep] = 0
        got[2:] = _torch_grads(*rounded[:3], do_drop, pos, torch.bfloat16)[2:]
    elif fault == "late-rows-scaled":
        got[0][:, 3 * t // 4:] *= 0.9
    old_ok = np.abs(got[0] - plain[0]).max() <= 6e-2 and all(
        _rel_err(g, p) <= 5e-2 for g, p in zip(got[1:], plain[1:]))
    if fault == "late-rows-scaled":
        assert old_ok  # what the earlier gate could not see
    gate = _row_gate(got, plain, exact)
    assert {name for name, g in gate.items() if not g["ok"]} == caught


def _kernel_dq_emulation(q, k, v, do, *, d_from):
    """dq as the bf16 kernels compute it, in plain torch (causal, positions
    ``arange``): scores rounded to bf16, fp32 softmax, dP unrounded, dS
    rounded to bf16 before dS K, and the softmax gradient's D from
    ``d_from``: ``"weights"``, sum_k P dP (the kernels' D pass);
    ``"output"``, rowsum(dO * O) with O the bf16 output, built as the
    forward builds it (weights exp(s - max) rounded to bf16 for PV, their
    fp32 sum divided out); ``"output+lo"``, the same with O plus its
    rounding residual (the earlier kernels)."""
    t, hd = q.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    kf, vf = (x.repeat_interleave(rep, 2).float() for x in (k, v))
    qf, dof = q.float(), do.float()
    scale = 1 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).to(torch.bfloat16).float() * scale
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if d_from == "weights":
        d = (p * dp).sum(-1, keepdim=True)
    else:
        w = torch.exp(s - s.amax(-1, keepdim=True))
        o32 = torch.einsum("bhqk,bkhd->bqhd", w.to(torch.bfloat16).float(), vf)
        o32 = o32 / w.sum(-1).transpose(1, 2)[..., None]
        o = o32.to(torch.bfloat16).float()
        if d_from == "output+lo":
            o = o + (o32 - o).to(torch.bfloat16).float()
        d = (dof * o).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - d) * scale).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(torch.bfloat16)


#: (b, t, kvh, rep, hd, seed): long rows (T 512, hd 128), and the tile-edge
#: case whose three-key row the earlier kernels' D failed (hd 64, 4 query
#: heads a KV head, T 64)
D_CASES = {"long-rows": (1, 512, 1, 2, 128, 0), "short-row": (1, 64, 1, 4, 64, 3 * 64 + 4 + 64)}


def _dq_gate(case, d_from):
    b, t, kvh, rep, hd, seed = D_CASES[case]
    q, k, v, do, pos = _case(b, t, kvh, rep, hd, seed=seed)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    rounded = [x.float().numpy() for x in bf]
    exact = _torch_grads(*rounded, pos, torch.float32)
    plain = _torch_grads(*rounded, pos, torch.bfloat16)
    got = [plain[0], _kernel_dq_emulation(*bf, d_from=d_from).float().numpy(), *plain[2:]]
    return _row_gate(got, plain, exact)["dq"]


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_backward_d_from_the_weights_passes_the_row_gate(case):
    """D = sum_k P dP from the weights the backward forms, as the plain
    version's autograd takes it from its own probabilities: dq is within
    the row gate on long rows and on a row whose weight sits on few keys,
    where dP - D cancels down to any mismatch in D."""
    gate = _dq_gate(case, "weights")
    assert gate["ok"], gate


@pytest.mark.parametrize("case, d_from", [("long-rows", "output"), ("short-row", "output+lo")])
def test_backward_d_from_the_output_fails_the_row_gate(case, d_from):
    """D = rowsum(dO * O) from the bf16 output alone is off by a bf16 ulp of
    |dO| |O|, the size of a short row's dq, and the row gate refuses it at
    T 512; with the output's rounding residual added back it passes there,
    but the output was built from weights rounded to bf16, and the
    three-key row of the short case still fails."""
    gate = _dq_gate(case, d_from)
    assert not gate["ok"], gate
    if d_from == "output+lo":
        assert _dq_gate("long-rows", d_from)["ok"]


def test_specified_numerics_fail_the_plain_row_gate_on_a_short_row():
    """The earlier specified numerics (D = rowsum(dO * (out + out_lo))) fail
    the plain version's row gate on a short row, and the kernels' specified
    numerics now pass it: emulated on the CPU at hd 64, 4 query heads a KV
    head, T 64 (a tile-edge case), the row at position 2 (three keys) had a
    dq beyond the gate, because dP - D cancels down to the mismatch between
    D and that row's own sum of P dP.  With D = sum_k P dP every tensor
    passes."""
    b, t, kvh, rep, hd, seed = D_CASES["short-row"]
    q, k, v, do, pos = _case(b, t, kvh, rep, hd, seed=seed)
    rounded = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do)]
    exact = _torch_grads(*rounded, pos, torch.float32)
    plain = _torch_grads(*rounded, pos, torch.bfloat16)
    old = _row_gate(_spec_numerics(*rounded, pos, d_from="output"), plain, exact)
    assert not old["dq"]["ok"], old["dq"]
    assert all(old[name]["ok"] for name in ("out", "dk", "dv")), old
    new = _row_gate(_spec_numerics(*rounded, pos), plain, exact)
    assert all(g["ok"] for g in new.values()), new


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", LENGTHS + (2048,))
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_matches_plain_version_on_card(hd, rep, t, dtype):
    _need_card()
    _kernel_vs_plain(2, t, 2, rep, hd, dtype, seed=hd + rep + t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_with_other_positions_on_card(dtype):
    """Positions other than ``arange``: a row with no live key, rows past T,
    and a query tile whose rows reach back to key 0 only (130 rows: three
    64-row tiles, the last one partial)."""
    _need_card()
    t = 130
    rng = np.random.default_rng(5)
    pos = rng.integers(-2, t + 10, (2, t)).astype(np.int32)
    pos[1, 64:] = 0
    _kernel_vs_plain(2, t, 2, 2, 64, dtype, seed=9, positions=pos)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take_on_card():
    _need_card()
    q, k, v, _, pos = (torch.from_numpy(x).cuda() for x in _case(1, 8, 2, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        da.dense_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pos)
    q32, k32, v32, _, pos32 = (torch.from_numpy(x).cuda() for x in _case(1, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="head_dim 32"):
        da.dense_attention_fwd(q32, k32, v32, pos32)


#: T at the edges of the Hopper kernels' tiles: 64-row consumers (128 rows a
#: block), 128-key forward tiles, 64-key dQ tiles, 32-row dK/dV query tiles
#: and 128-key dK/dV blocks
EDGE_LENGTHS = (1, 63, 64, 65, 127, 129, 2047, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", EDGE_LENGTHS)
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_at_tile_edges_on_card(hd, rep, t, dtype):
    """T at the tile edges, with 1, 4 and 8 query heads a KV head (the
    forward and dQ rows pack that many heads a position)."""
    _need_card()
    _kernel_vs_plain(1, t, 1, rep, hd, dtype, seed=3 * hd + rep + t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_with_packed_sequences_on_card(hd, rep, dtype):
    """Positions that are not ``arange``: two sequences packed into each
    batch row (positions restart at 0), and one row at position -1."""
    _need_card()
    t = 300
    row = np.concatenate([np.arange(100), np.arange(t - 100)]).astype(np.int32)
    pos = np.stack([row, np.roll(row, 37)])
    pos[1, 150] = -1
    _kernel_vs_plain(2, t, 2, rep, hd, dtype, seed=hd + rep, positions=pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_backward_is_deterministic_on_card(hd, dtype):
    """Two backward calls on the same inputs give the same bits: dK/dV sums
    a KV head's query heads in registers and dQ has a pass of its own, so
    no sum depends on the order blocks run in."""
    _need_card()
    q, k, v, do, pos = (torch.from_numpy(x).cuda() for x in _case(2, 300, 2, 4, hd, seed=hd))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    fwd = da.dense_attention_fwd(q, k, v, pos)
    first = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    second = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
