"""Parity of the port's context-engine embedder (``cordum_tpu_torch/models/
embedder.py``) and its attention kernel's plain version
(``cordum_tpu_torch/ops/embed_attention.py``) with the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
and its PyTorch counterpart on the CPU.  Tolerances:

* tokenizer ids, masks and counts: equal;
* ``forward`` in fp32 through ``params_from_jax``: 1e-5 max abs on unit
  L2-normalised embeddings (the two packages sum in other orders);
* ``forward`` in bf16: 1e-2 max abs — XLA and PyTorch round bf16 at other
  places (XLA may keep a fused elementwise chain such as GELU in fp32 and
  round once; matmul outputs round at one bf16 ulp, 2^-8 relative, either
  way), and over four layers the pooled, normalised embeddings drift by
  about 1e-3;
* the attention core's plain version against the reference formulation:
  1e-6 in fp32, one bf16 ulp of the output magnitude (2^-8 of max |v|) in
  bf16.

The kernel's masked-tile skip (16-key tiles whose keys are all masked are
never loaded, scored or multiplied; an all-pad row skips nothing; keys past
``L`` are in no softmax) is emulated in plain PyTorch
(``embed_attention_tiled``) and held to the plain version BIT FOR BIT in
fp32: prefix masks, masks with holes, a single-key row and an all-pad row,
at L 5, 16 and 128.

The ``gpu``-marked tests hold the CUDA kernel against its plain version on
the card; it skips without one.  Tolerances there, fixed before the first
run: fp32 1e-5 (sums of at most 128 terms in another order on O(1)
outputs); bf16 6e-2 (the kernel and the plain version round scores and
probabilities to bf16 at the same points, so what differs is fp32 sum
order flipping a rounding: two bf16 ulps at outputs up to ~4).  On the card
(no JAX there) run it with ``python -m pytest --noconftest -m gpu
tests/test_torch_embedder.py``; JAX is imported inside the tests that use
it.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cordum_tpu_torch.models import embedder as te
from cordum_tpu_torch.ops import embed_attention as ea

FORWARD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KERNEL_ATOL = {torch.float32: 1e-5, torch.bfloat16: 6e-2}
TEXTS = [
    "Hello, world! Agents chain LLM turns.",
    "a",
    "",  # CLS only
    "the quick brown fox jumps over the lazy dog " * 20,  # past max_len
    "Ünïcödé — ≠ ascii; tabs\tand\nnewlines... 42 % done?",
]


def _jax_cfg(dtype):
    import jax.numpy as jnp

    from cordum_tpu.models import embedder as je

    return je.EmbedderConfig(dtype={torch.float32: jnp.float32,
                                    torch.bfloat16: jnp.bfloat16}[dtype])


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(texts=st.lists(
    st.text(alphabet=st.characters(codec="utf-8"), max_size=80)
    | st.text(alphabet=" \t\n.,;:!?-_()[]{}'\"/\\@#$%^&*+=<>|~`abcXYZ019", max_size=200),
    min_size=1, max_size=6,
))
def test_tokenizer_ids_equal_the_reference(texts):
    from cordum_tpu.models import embedder as je

    jcfg, tcfg = je.EmbedderConfig(), te.EmbedderConfig()
    for t in texts:
        assert te.tokenize(t, tcfg) == je.tokenize(t, jcfg)
        assert te.token_count(t, tcfg) == je.token_count(t, jcfg)
    for max_len in (0, 16, 64):
        ids, mask = te.batch_tokenize(texts, tcfg, max_len=max_len)
        jids, jmask = je.batch_tokenize(texts, jcfg, max_len=max_len)
        assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
        assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax(dtype):
    """Full EmbedderConfig widths, mixed lengths and one all-pad batch row
    (the micro-batcher's padding): equal within the tolerance, no NaN."""
    import jax
    import jax.numpy as jnp

    from cordum_tpu.models import embedder as je

    jcfg = _jax_cfg(dtype)
    tcfg = te.EmbedderConfig(dtype=dtype)
    jparams = je.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = te.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert tparams["embed"].dtype == dtype
    ids, mask = je.batch_tokenize(TEXTS, jcfg)
    ids = np.concatenate([ids, np.zeros((1, ids.shape[1]), np.int32)])
    mask = np.concatenate([mask, np.zeros((1, mask.shape[1]), np.float32)])
    want = np.asarray(je.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = te.forward(tparams, torch.from_numpy(ids), torch.from_numpy(mask), tcfg).numpy()
    assert got.shape == (len(TEXTS) + 1, tcfg.d_model) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= FORWARD_ATOL[dtype]


def test_embedder_wrapper_matches_forward_and_buckets():
    """``Embedder.embed`` is tokenizer + forward at max_len; trimming the
    sequence to a shorter bucket leaves the embeddings unchanged (masked
    keys carry exactly zero weight)."""
    cfg = te.EmbedderConfig(dtype=torch.float32)
    emb = te.Embedder(cfg, seed=3, device="cpu")
    full = emb.embed(TEXTS[:3])
    ids, mask = te.batch_tokenize(TEXTS[:3], cfg, max_len=16)
    np.testing.assert_allclose(emb.embed_tokens(ids, mask), full, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(full, axis=1), 1.0, atol=1e-5)


def test_embedder_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Embedder(te.EmbedderConfig())


# ---------------------------------------------------------------------------
# the attention core
# ---------------------------------------------------------------------------


def _attention_case(b=5, length=32, h=4, hd=64, seed=0):
    """q, k, v as views of one fused [B, L, 3, h, hd] projection (the
    embedder's layout), rows of mixed lengths, one all-pad row and one
    length-1 row."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, length, 3, h, hd)).astype(np.float32)
    lens = rng.integers(2, length + 1, b)
    lens[1], lens[2] = 0, 1
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    return qkv, mask


def _jax_core(q, k, v, mask):
    """The reference's attention core, as ``cordum_tpu/models/embedder.py``
    ``forward`` writes it."""
    import jax
    import jax.numpy as jnp

    hd = q.shape[-1]
    attn_bias = jnp.where(mask[:, None, None, :] > 0, 0.0, -1e30).astype(jnp.float32)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32) / math.sqrt(hd)
    probs = jax.nn.softmax(scores + attn_bias, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_matches_reference_core(dtype):
    import jax.numpy as jnp

    qkv, mask = _attention_case()
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jqkv = jnp.asarray(qkv).astype(jdt)
    want = np.asarray(_jax_core(jqkv[:, :, 0], jqkv[:, :, 1], jqkv[:, :, 2],
                                jnp.asarray(mask)).astype(jnp.float32))
    tqkv = torch.from_numpy(qkv).to(dtype)
    got = ea.embed_attention_reference(
        tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2], torch.from_numpy(mask)).float().numpy()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8 * np.abs(qkv[:, :, 2]).max()
    assert np.abs(got - want).max() <= tol
    # the all-pad row attends uniformly to every key, padding included
    uniform = qkv[1, :, 2].mean(axis=0)
    np.testing.assert_allclose(got[1], np.broadcast_to(uniform, got[1].shape),
                               atol=1e-5 if dtype == torch.float32 else 5e-2)


def test_wrapper_takes_plain_version_on_cpu():
    qkv, mask = _attention_case()
    tqkv, tmask = torch.from_numpy(qkv), torch.from_numpy(mask)
    args = (tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2], tmask)
    before = ea.embed_attention.launches
    got = ea.embed_attention(*args)
    assert ea.embed_attention.launches == before  # no kernel launch
    assert torch.equal(got, ea.embed_attention_reference(*args))


def test_kernel_checks_reject_what_it_does_not_take():
    qkv, mask = _attention_case()
    tqkv, tmask = torch.from_numpy(qkv), torch.from_numpy(mask)
    q, k, v = tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2]
    with pytest.raises(ValueError, match="CUDA"):
        ea.check_kernel_args(q, k, v, tmask)  # CPU tensors
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ea.check_kernel_args(q.half(), k.half(), v.half(), tmask)
    with pytest.raises(ValueError, match="mask must be float32"):
        ea.check_kernel_args(q, k, v, tmask.bool())
    with pytest.raises(ValueError, match="head_dim"):
        ea.check_kernel_args(q[..., :32], k[..., :32], v[..., :32], tmask)
    long = torch.zeros((1, 129, 4, 64))
    with pytest.raises(ValueError, match="L 129"):
        ea.check_kernel_args(long, long, long, torch.ones((1, 129)))
    with pytest.raises(ValueError, match="strides"):
        ea.check_kernel_args(q.contiguous(), k, v, tmask)
    with pytest.raises(ValueError, match="contiguous"):
        ea.check_kernel_args(q, k, v, tmask.t().contiguous().t())


def test_kernel_build_without_nvcc_raises(tmp_path):
    """No compiler, no kernel: the build raises (the wrapper never falls
    back to the plain version for a CUDA tensor)."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    from cordum_tpu_torch.ops import _build

    if CUDA_HOME or shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    src = tmp_path / "never_built.cu"
    src.write_text(f"// {tmp_path}\n")  # a source no library was built from
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(src, lambda lib: None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 32), (256, 128), (3, 16)])
def test_kernel_matches_plain_version_on_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    qkv, mask = _attention_case(b=shape[0], length=shape[1])
    tqkv = torch.from_numpy(qkv).to(dev, dtype)
    tmask = torch.from_numpy(mask).to(dev)
    args = (tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2], tmask)
    before = ea.embed_attention.launches
    got = ea.embed_attention(*args)
    torch.cuda.synchronize()
    assert ea.embed_attention.launches == before + 1
    want = ea.embed_attention_reference(*args)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err


def _mask_case(b, length, seed):
    """Masks of every kind the skip must get right: prefix rows, a row with
    holes (every third key masked, and a whole masked tile when L > 16), a
    single-key row, an all-pad row, a full row."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, length + 1, b)
    lens[0], lens[1], lens[2] = 0, 1, length
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    mask[3, ::3] = 0.0
    if length > 16:
        mask[3, 16:32] = 0.0
    mask[4, :] = 0.0
    mask[4, length - 1] = 1.0  # one real key, at the end
    return mask


@pytest.mark.parametrize("length", [5, 16, 128])
def test_tile_skip_emulation_is_bit_exact(length):
    rng = np.random.default_rng(length)
    b = 6
    qkv = torch.from_numpy(rng.standard_normal((b, length, 3, 4, 64)).astype(np.float32))
    mask = torch.from_numpy(_mask_case(b, length, seed=length))
    args = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask)
    live = ea.live_key_tiles(mask)
    n_tiles = -(-length // 16)
    assert live.shape == (b, n_tiles)
    assert live[0].all()  # the all-pad row skips nothing
    if length > 16:
        assert not live[1, 1:].any() and not live[3, 1]  # skipped tiles exist
    got = ea.embed_attention_tiled(*args)
    want = ea.embed_attention_reference(*args)
    assert torch.equal(got, want)
    # the all-pad row is uniform over its L keys, never the padding to 16
    uniform = qkv[0, :, 2].mean(0)
    torch.testing.assert_close(got[0], uniform.expand_as(got[0]), atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [5, 17, 100])
def test_kernel_tiling_cases_on_card(dtype, length):
    """A last tile that is not full, masks with holes and a masked tile, a
    single-key row and an all-pad row (at L 5 too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(length + 1)
    b = 8
    qkv = torch.from_numpy(rng.standard_normal((b, length, 3, 4, 64)).astype(np.float32))
    tqkv = qkv.to(dev, dtype)
    tmask = torch.from_numpy(_mask_case(b, length, seed=length + 1)).to(dev)
    args = (tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2], tmask)
    before = ea.embed_attention.launches
    got = ea.embed_attention(*args)
    torch.cuda.synchronize()
    assert ea.embed_attention.launches == before + 1
    want = ea.embed_attention_reference(*args)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL[dtype], err
