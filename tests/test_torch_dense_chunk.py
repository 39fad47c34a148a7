"""B9 at a sequence-parallel rank's shapes (``cordum_tpu_torch/ops/
dense_attention.py``, ``csrc/dense_attention.cu``): a chunk of ``Tq``
queries at their global positions against the ``Tk`` keys gathered over sp.

On the CPU: the plain version at such shapes against the JAX package's
``_attention`` with ``q_offset`` (``cordum_tpu/models/llama.py``, as
``_block`` calls it over an sp mesh), forward and ``jax.vjp``; the chunk's
output as the rows of the whole sequence's and its key gradients as their
share of the whole's; ``check_kernel_args`` on the new shapes.  Tolerances
as ``tests/test_torch_dense_attention.py``'s: fp32 1e-5 of the largest
``|value|`` (the frameworks sum in other orders), bf16 2e-2 (a rounding
flipped by the sum order).  JAX is imported inside the CPU tests only.

The ``gpu``-marked tests hold the kernels against the plain version on the
card at chunk shapes, forward and backward, with that file's gates (fp32:
output 1e-5 absolute, gradients 1e-4 of their largest value; bf16: the row
gate against the exact result), and count each launch as a chunk's.  On
the card run them with ``python -m pytest --noconftest -m gpu
tests/test_torch_dense_chunk.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cordum_tpu_torch.ops import dense_attention as da

from .test_torch_dense_attention import (CPU_REL, KERNEL_GRAD_REL, KERNEL_OUT_ATOL, _need_card,
                                         _plain_on_card, _rel_err, _row_gate, _torch_grads)


def _chunk(b, tq, tk, kvh, rep, hd, first, *, seed=0):
    """q and dO of ``tq`` rows at positions ``first ..``, k and v of ``tk``
    rows (fp32 numpy), positions int32 ``[B, Tq]``."""
    rng = np.random.default_rng(seed)
    h = kvh * rep
    q = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, kvh, hd)).astype(np.float32)
    do = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(first, first + tq, dtype=np.int32), (b, tq)).copy()
    return q, k, v, do, pos


def _jax_grads(q, k, v, do, pos, dtype):
    import jax
    import jax.numpy as jnp

    from cordum_tpu.models import llama as jl

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    h, kvh = q.shape[2], k.shape[2]
    cfg = jl.LlamaConfig(n_heads=h, n_kv_heads=kvh, d_model=h * q.shape[3], dtype=jdt)
    out, vjp = jax.vjp(lambda a, b_, c: jl._attention(a, b_, c, cfg, q_offset=jnp.asarray(pos)),
                       *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(jnp.asarray(do, jdt)))]


#: (Tq, Tk, first position): sp 2's two chunks of T 16, sp 4's last chunk
#: of T 32, a chunk that ends before the last key, and one row at the end
CHUNKS = ((8, 16, 0), (8, 16, 8), (8, 32, 24), (5, 24, 10), (1, 9, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tq, tk, first", CHUNKS)
def test_plain_chunk_matches_jax_attention_and_vjp(tq, tk, first, dtype):
    q, k, v, do, pos = _chunk(2, tq, tk, 2, 2, 16, first, seed=tq + tk + first)
    got = _torch_grads(q, k, v, do, pos, dtype)
    want = _jax_grads(q, k, v, do, pos, dtype)
    assert got[2].shape == k.shape and got[0].shape == q.shape
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= CPU_REL[dtype], name


@pytest.mark.parametrize("sp", [2, 4])
def test_chunks_are_rows_of_the_whole_and_their_key_gradients_sum_to_its(sp):
    """The sequence cut into sp chunks, each chunk's queries against every
    key: the outputs are the rows of the whole's, and the key and value
    gradients of the chunks sum to the whole's (what ``gather_seq``'s
    reduce-scatter takes)."""
    t, hd = 32, 16
    q, k, v, do, pos = _chunk(2, t, t, 2, 4, hd, 0, seed=sp)
    whole = _torch_grads(q, k, v, do, pos, torch.float32)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    n = t // sp
    for c in range(sp):
        rows = slice(c * n, (c + 1) * n)
        out, dq, dk_c, dv_c = _torch_grads(q[:, rows], k, v, do[:, rows], pos[:, rows],
                                           torch.float32)
        assert _rel_err(out, whole[0][:, rows]) <= CPU_REL[torch.float32]
        assert _rel_err(dq, whole[1][:, rows]) <= CPU_REL[torch.float32]
        dk, dv = dk + dk_c, dv + dv_c
    assert _rel_err(dk, whole[2]) <= CPU_REL[torch.float32]
    assert _rel_err(dv, whole[3]) <= CPU_REL[torch.float32]


def test_cpu_chunk_takes_the_plain_version_and_counts_no_launch():
    q, k, v, _, pos = (torch.from_numpy(x) for x in _chunk(1, 4, 12, 1, 2, 16, 8))
    before = (da.dense_attention_fwd.launches, da.dense_attention_fwd.chunk_launches)
    out = da.dense_attention(q, k, v, pos)
    assert torch.equal(out, da.gqa_attention(q, k, v, q_offset=pos))
    assert (da.dense_attention_fwd.launches, da.dense_attention_fwd.chunk_launches) == before


def _args(b=1, tq=4, tk=12, kvh=2, rep=2, hd=64):
    q, k, v, do, pos = (torch.from_numpy(x) for x in _chunk(b, tq, tk, kvh, rep, hd, tk - tq))
    return q, k, v, do, pos


@pytest.mark.parametrize("tq, tk", [(4, 12), (12, 4), (1, 1), (7, 7)])
def test_check_kernel_args_takes_chunk_shapes(tq, tk):
    """Any Tq and Tk pass every check but the device's (the CPU's tensors
    fail only that one), the backward's output and dO of q's shape too."""
    q, k, v, do, pos = _args(tq=tq, tk=tk)
    with pytest.raises(ValueError, match="one CUDA device"):
        da.check_kernel_args(q, k, v, pos, q.clone(), do)


@pytest.mark.parametrize("fault, match", [
    ("positions of the keys' length", "positions must be int32 \\[B, Tq\\]"),
    ("k and v of other lengths", "q \\[B,Tq,H,hd\\], k/v \\[B,Tk,KVH,hd\\]"),
    ("k of another batch", "q \\[B,Tq,H,hd\\], k/v \\[B,Tk,KVH,hd\\]"),
    ("dO of k's shape", "q \\[B,Tq,H,hd\\], k/v \\[B,Tk,KVH,hd\\]"),
    ("k of another head width", "q \\[B,Tq,H,hd\\], k/v \\[B,Tk,KVH,hd\\]"),
])
def test_check_kernel_args_still_refuses_the_rest(fault, match):
    q, k, v, do, pos = _args()
    more = (q.clone(), do)
    if fault == "positions of the keys' length":
        pos = torch.zeros(1, k.shape[1], dtype=torch.int32)
    elif fault == "k and v of other lengths":
        v = v[:, :-1].contiguous()
    elif fault == "k of another batch":
        k, v = torch.cat([k, k]), torch.cat([v, v])
    elif fault == "dO of k's shape":
        more = (q.clone(), torch.zeros(1, k.shape[1], q.shape[2], q.shape[3]))
    else:
        k, v = k[..., :32].contiguous(), v[..., :32].contiguous()
    with pytest.raises(ValueError, match=match):
        da.check_kernel_args(q, k, v, pos, *more)


def test_row_gate_holds_longer_rows_apart_from_short_ones():
    """C2: where the plain version's worst dq row is a row of two keys
    (dP - D cancels there), every longer row used to share that row's loose
    limit.  With the positions, rows of more than ``SHORT_ROW_KEYS`` live
    keys are held to the plain version's worst such row: an error on a long
    row between the two limits passes the tensor-wide limit and is refused
    by the long rows' one; without an error both pass."""
    import chip_smoke

    b, t, kvh, rep, hd = 1, 256, 1, 2, 64
    q, k, v, do, pos = _chunk(b, t, t, kvh, rep, hd, 0, seed=13)
    rounded = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do)]
    exact = [torch.from_numpy(x) for x in _torch_grads(*rounded, pos, torch.float32)]
    plain = [torch.from_numpy(x) for x in _torch_grads(*rounded, pos, torch.bfloat16)]
    pos_t = torch.from_numpy(pos)
    # the plain version's short row: a tenth of its largest value off
    plain[1][0, 1, 0] += 0.1 * exact[1][0, 1, 0].abs().max()
    got = [x.clone() for x in plain]
    got[1][0, 1, 0] = exact[1][0, 1, 0]  # the kernel gets that row right
    fine = chip_smoke.bf16_row_gate(got, plain, exact, pos_t)
    assert fine["dq"]["ok"] and fine["dq"]["long"]["limit"] < fine["dq"]["limit"]
    row = exact[1][0, 200, 1]
    mid = (fine["dq"]["long"]["limit"] + fine["dq"]["limit"]) / 2
    got[1][0, 200, 1] = row + mid * row.abs().max()
    assert chip_smoke.bf16_row_gate(got, plain, exact)["dq"]["ok"]
    gate = chip_smoke.bf16_row_gate(got, plain, exact, pos_t)
    assert not gate["dq"]["ok"] and gate["out"]["ok"], gate


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _chunk_vs_plain(b, tq, tk, kvh, rep, hd, first, dtype, *, seed=0):
    q, k, v, do, pos = _chunk(b, tq, tk, kvh, rep, hd, first, seed=seed)
    fwd = da.dense_attention_fwd
    bwd = da.dense_attention_bwd
    before = (fwd.launches, bwd.launches, fwd.chunk_launches, bwd.chunk_launches)
    got = _torch_grads(q, k, v, do, pos, dtype, device="cuda")
    torch.cuda.synchronize()
    chunk = int(tq != tk)
    assert (fwd.launches, bwd.launches, fwd.chunk_launches, bwd.chunk_launches) == (
        before[0] + 1, before[1] + 1, before[2] + chunk, before[3] + chunk)
    assert all(np.isfinite(g).all() for g in got)
    assert got[2].shape == k.shape
    rounded = [torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v, do)]
    want = _plain_on_card(*rounded, pos, dtype)
    dv_max = float(np.abs(want[3]).max())
    if dtype == torch.float32:
        assert float(np.abs(got[0] - want[0]).max()) <= KERNEL_OUT_ATOL
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            err = float(np.abs(g - w).max()) / (float(np.abs(w).max()) or dv_max)
            assert err <= KERNEL_GRAD_REL, (name, err)
        return
    exact = _plain_on_card(*rounded, pos, torch.float32)
    gate = _row_gate(got, want, exact)
    assert all(g["ok"] for g in gate.values()), gate


#: (Tq, Tk, first position) on the card: the tiles' edges on both lengths
#: (64-row consumers and 128-row blocks over Tq; 128-key forward tiles,
#: 64-key dQ tiles and 128-key dK/dV blocks over Tk), chunks that end
#: before the last key, a first chunk (its keys past it get no gradient)
#: and sp 4's last chunk of T 2048
CARD_CHUNKS = ((64, 128, 64), (65, 130, 65), (1, 2048, 2047), (127, 256, 0),
               (129, 2048, 1024), (512, 2048, 1536), (33, 200, 100))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tq, tk, first", CARD_CHUNKS)
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_chunk_kernel_matches_plain_version_on_card(hd, rep, tq, tk, first, dtype):
    _need_card()
    _chunk_vs_plain(1, tq, tk, 1, rep, hd, first, dtype, seed=hd + rep + tq + first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_chunk_backward_is_deterministic_on_card(hd, dtype):
    _need_card()
    q, k, v, do, pos = (torch.from_numpy(x).cuda() for x in _chunk(2, 300, 700, 2, 4, hd, 400,
                                                                   seed=hd))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    fwd = da.dense_attention_fwd(q, k, v, pos)
    first = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    second = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
