"""The paged-attention kernel's plain version and wrapper
(``cordum_tpu_torch.ops.paged_attention``).

On the CPU the plain version is held against the JAX package's own
formulation of the ragged step's attention core — the page-table gather
``k_pages[li][pt_tok]`` followed by ``_attention(q_offset=pos2)`` — in
fp32 with ``ATOL``/``RTOL`` 1e-5 (the two frameworks sum the score and PV
products in different orders; outputs are O(1)).  The wrapper must take
the plain version for CPU tensors, bit for bit, without counting a launch.

The ``gpu``-marked test holds the CUDA kernel against the plain version on
the card: fp32 within 1e-4 absolute (fp32 sums in another order over
contexts up to a few hundred keys), bf16 within 6e-2 absolute — the plain
version rounds the scores and the probabilities to bf16 before the PV
product while the kernel keeps both in fp32, a difference of a few bf16
ulps (2^-8 relative) on outputs of magnitude up to ~3.

JAX is imported inside the one test that uses it, so that the file also
collects where JAX is not installed: the card's machine runs
``python -m pytest --noconftest -m gpu tests/test_torch_paged_attention.py``
(``tests/conftest.py`` imports JAX).
"""
import numpy as np
import pytest
import torch

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
