"""Parity of ``cordum_tpu_torch.models.llama`` with ``cordum_tpu.models.llama``.

Both packages run on the CPU in fp32 over the same weights (JAX-initialised,
handed over through ``params_from_jax``) and the same numpy inputs.

Tolerances: fp32 everywhere.  The two frameworks sum matrix products in
different orders, so float results agree to a few ulps of their magnitude;
``ATOL``/``RTOL`` of 1e-5 cover O(1) activations with two orders of margin
over fp32's 1.2e-7 epsilon, and logits (magnitude up to ~5) get 1e-4.
Token outputs (argmax) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu_torch.models import llama as tl

ATOL = RTOL = 1e-5
LOGIT_ATOL = LOGIT_RTOL = 1e-4
CPU = "cpu"


def _cfgs():
    # the tests/test_serving.py config: vocab 256, d 64, 2 layers, 4 heads
    # over 2 KV heads (GQA rep 2), head_dim 16
    kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128)
    return jl.LlamaConfig(dtype=jnp.float32, **kw), tl.LlamaConfig(dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def env():
    jcfg, tcfg = _cfgs()
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tl.params_from_jax(np_tree, device=CPU)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def test_params_from_jax_is_exact(env):
    _, tcfg, jparams, tparams = env
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_params_from_jax_moves_bf16_bits():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    out = tl.params_from_jax(
        {"embed": a, "layers": [], "final_norm": a[0], "lm_head": a.T}, device=CPU
    )
    assert out["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["embed"].float().numpy(), np.asarray(a.astype(jnp.float32))
    )


def test_init_params_shapes_and_scale():
    jcfg, tcfg = _cfgs()
    gen = torch.Generator(device=CPU).manual_seed(0)
    tp = tl.init_params(tcfg, generator=gen, device=CPU)
    jp = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == jax.tree.map(
        lambda x: tuple(x.shape), tp)
    # 1/sqrt(fan_in) scale: 256*64 draws, so the sample std is within 5%
    assert abs(float(tp["embed"].std()) * 8.0 - 1.0) < 0.05
    assert abs(float(tp["layers"][0]["w_down"].std()) * np.sqrt(128) - 1.0) < 0.05
    assert torch.equal(tp["final_norm"], torch.ones(64))


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(w), 1e-5), jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    _close(tl.rope(_t(x), _t(pos), 500000.0),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


@pytest.mark.parametrize("offset", [False, True])
def test_attention_matches_gqa(env, offset):
    jcfg, tcfg, _, _ = env
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)
    off = rng.integers(0, 9, (3, 6)).astype(np.int32) if offset else None
    got = tl._attention(_t(q), _t(k), _t(v), tcfg,
                        q_offset=None if off is None else _t(off))
    want = jl._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                         q_offset=None if off is None else jnp.asarray(off))
    _close(got, want)


def test_forward_matches(env):
    jcfg, tcfg, jparams, tparams = env
    toks = np.random.default_rng(3).integers(0, 256, (2, 11)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, jcfg))(jparams, jnp.asarray(toks)))
    got = tl.forward(tparams, _t(toks), tcfg).numpy()
    _close(got, want, LOGIT_ATOL, LOGIT_RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _mixed_buffer(ps=8, num_pages=24, s_rows=4, p_cols=6):
    """One step's operands mixing every row kind: two decode rows (one
    mid-page, one on a page's first slot), a prefill chunk crossing a page
    boundary, a draft row of k+1 = 4 tokens, and padding on the null row."""
    rng = np.random.default_rng(4)
    tables = np.zeros((s_rows + 1, p_cols), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [5, 2]
    tables[2, :4] = [9, 4, 11, 6]
    tables[3, :2] = [8, 10]
    rows = [  # (seq, start, n)
        (0, 19, 1),   # decode at page 2, slot 3
        (1, 8, 1),    # decode on page 1's first slot
        (2, 5, 6),    # prefill chunk 5..10 crosses page 0 -> 1
        (3, 12, 4),   # draft row: last token + 3 drafts
    ]
    t_buf = 16
    tokens = np.zeros(t_buf, np.int32)
    positions = np.zeros(t_buf, np.int32)
    token_seq = np.full(t_buf, s_rows, np.int32)
    out_idx = np.zeros(s_rows, np.int32)
    ti = 0
    for s, start, n in rows:
        tokens[ti:ti + n] = rng.integers(0, 256, n)
        positions[ti:ti + n] = np.arange(start, start + n)
        token_seq[ti:ti + n] = s
        out_idx[s] = ti + n - 1
        ti += n
    return dict(tokens=tokens, positions=positions, page_tables=tables,
                token_seq=token_seq, out_idx=out_idx, ps=ps, num_pages=num_pages)


def _arena(cfg_layers, num_pages, ps, seed=5):
    # a populated arena: every earlier position already holds K/V
    rng = np.random.default_rng(seed)
    shape = (cfg_layers, num_pages, ps, 2, 16)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("sample", [True, False])
def test_ragged_step_mixed_buffer_matches(env, sample):
    jcfg, tcfg, jparams, tparams = env
    b = _mixed_buffer()
    kp, vp = _arena(jcfg.n_layers, b["num_pages"], b["ps"])
    ops = [b[k] for k in ("tokens", "positions", "page_tables", "token_seq", "out_idx")]
    jstep = jax.jit(lambda *a: jl.ragged_step(*a, jcfg, sample_logits=sample))
    jn, jk, jv = jstep(jparams, jnp.asarray(kp), jnp.asarray(vp), *map(jnp.asarray, ops))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tn, tk2, tv2 = tl.ragged_step(tparams, tk, tv, *map(_t, ops), tcfg,
                                  sample_logits=sample)
    assert tk2 is tk and tv2 is tv  # updated in place
    assert tn.dtype == torch.int32 and tn.shape == (16,)
    if sample:
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    else:
        assert not tn.any() and not np.asarray(jn).any()
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_copy_kv_page_matches(env):
    jcfg = env[0]
    kp, vp = _arena(jcfg.n_layers, 6, 4)
    jk, jv = jl.copy_kv_page(jnp.asarray(kp), jnp.asarray(vp), 2, 5)
    tk, tv = tl.copy_kv_page(_t(kp.copy()), _t(vp.copy()), 2, 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gather_scatter_round_trip_matches(env):
    jcfg, tcfg, _, _ = env
    kp, vp = _arena(jcfg.n_layers, 6, 4)
    ids, used = [1, 4, 3], [4, 4, 2]
    jblocks = jl.gather_kv_pages(jnp.asarray(kp), jnp.asarray(vp), ids, used)
    tblocks = tl.gather_kv_pages(_t(kp), _t(vp), ids, used)
    for (jk, jv), (tk, tv) in zip(jblocks, tblocks):
        assert tk.dtype == np.float32 and tk.shape == jk.shape
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tv, jv)
    # scatter the exported blocks into fresh pages of zeroed arenas
    jz = jl.init_kv_pages(jcfg, 6, 4)
    tz = tl.init_kv_pages(tcfg, 6, 4, device=CPU)
    dst = [2, 5, 1]
    jk2, jv2 = jl.scatter_kv_pages(*jz, dst, jblocks)
    tk2, tv2 = tl.scatter_kv_pages(*tz, dst, tblocks)
    assert tk2 is tz[0]  # in place
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    # and back out: the round trip is exact, partial page trimmed
    again = tl.gather_kv_pages(tk2, tv2, dst, used)
    for (a, b), (c, d) in zip(again, tblocks):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
