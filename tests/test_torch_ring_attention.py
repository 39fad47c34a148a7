"""Ring attention over the sp line (``cordum_tpu_torch/ops/ring_attention.py``
and the Llama family's ``use_ring_attention``) against the JAX package's
``ring_attention`` and ``make_train_step`` on the conftest's 8 virtual CPU
devices, with the port's ranks as threads over in-process gloo groups and
its chunk steps the plain versions (CPU tensors).

Inputs come from numpy with a seed; JAX weights cross by ``params_from_jax``.
Tolerances, fp32 unless said:

* ``ring_attention`` against the JAX ring (dp 2 × sp 2, 3, 4; causal and
  not): the output within 1e-5 absolute (O(1) values; the chunks merge in
  another order), the gradients of ``sum(out * w)`` each within 1e-5 of its
  largest ``|value|``; bf16 within 2e-2 of the largest value (the port's
  chunks round their scores and outputs to bf16 where the reference's fp32
  online softmax does not);
* the Llama ring's loss within 1e-6 relative and every gradient within 1e-5
  of its largest ``|value|`` of the JAX ring's ``value_and_grad`` and of the
  port's all-gather flavour (A10's "done when"), at dp 2 × sp 2, 3, 4; the
  ring ``forward`` at dp 2 × sp 4 within 1e-5 of the largest logit;
* the train step at dp 2 × tp 2 × sp 2 against the JAX ring step: the
  gates of ``test_dp_tp_sp_train_step_matches_jax``.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.ops import ring_attention as jra
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.ops import ring_attention as ra

from .test_torch_ring_steps import run_mesh
from .test_torch_train_mesh import (BF16_FLIP, BF16_ULP, PARAM_ATOL_FP32, REPO, STEP_LOSS_REL,
                                    _cfgs, _rel, _tokens)

CPU = torch.device("cpu")
OUT_ATOL = 1e-5
GRAD_REL = 1e-5
BF16_REL = 2e-2
LOSS_REL = 1e-6


def _jax_mesh(dp, sp, tp=1):
    return jmesh.build_mesh(jmesh.MeshSpec(dp=dp, tp=tp, sp=sp),
                            devices=jax.devices()[:dp * tp * sp])


def _port_ring(q, k, v, w, dp, sp, causal, dtype):
    """Every rank's chunk through the port's ring and the gradients of
    ``sum(out * w)``, joined back into whole arrays (fp32 numpy)."""
    def body(mesh):
        rows = slice(mesh.dp_rank * (q.shape[0] // dp), (mesh.dp_rank + 1) * (q.shape[0] // dp))
        start, n = mesh.sp_span(q.shape[1])
        mine = [torch.from_numpy(x[rows, start:start + n]).to(dtype).requires_grad_()
                for x in (q, k, v)]
        out = ra.ring_attention(*mine, mesh, causal=causal)
        grads = torch.autograd.grad(
            (out.float() * torch.from_numpy(w[rows, start:start + n])).sum(), mine)
        with torch.no_grad():
            plain = ra._ring_attention_local(*mine, mesh, causal=causal)
        return [x.detach().float().numpy() for x in (out, *grads, plain)]

    parts = run_mesh(dp, 1, sp, body)
    return [np.concatenate([np.concatenate([parts[d * sp + s][i] for s in range(sp)], 1)
                            for d in range(dp)], 0) for i in range(5)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp, t, dtype", [(4, 32, torch.float32), (2, 32, torch.float32),
                                          (3, 24, torch.float32), (4, 32, torch.bfloat16)],
                         ids=["sp4", "sp2", "sp3", "sp4-bf16"])
def test_ring_matches_jax_ring_attention(sp, t, dtype, causal):
    """``test_models.py``'s shapes ``(b, t, h, hkv, d) = (2, t, 4, 2,
    16)`` over dp 2 × sp: the port's ring against the JAX ring, output and
    the gradients of ``sum(out * w)`` (``jax.grad`` through the ring's
    ``ppermute``s); the port's plain ring (``_ring_attention_local``) and
    ``reference_attention`` against the JAX package's."""
    rng = np.random.default_rng(sp + t)
    b, h, hkv, d = 2, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    w = rng.standard_normal((b, t, h, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mesh = _jax_mesh(2, sp)
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]

    def objective(q_, k_, v_):
        out = jra.ring_attention(q_, k_, v_, mesh, causal=causal)
        return (out.astype(jnp.float32) * w).sum(), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2),
                                                   has_aux=True))(*args)
    want = [np.asarray(x.astype(jnp.float32)) for x in (jout, *jgrads)]
    *got, plain = _port_ring(q, k, v, w, 2, sp, causal, dtype)
    exact = ra.reference_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                   causal=causal).float().numpy()
    jexact = np.asarray(jra.reference_attention(*args, causal=causal).astype(jnp.float32))
    if dtype == torch.float32:
        for out in (got[0], plain, exact):
            assert np.abs(out - want[0]).max() <= OUT_ATOL
        assert np.abs(exact - jexact).max() <= OUT_ATOL
        for g, x in zip(got[1:], want[1:]):
            assert _rel(g, x) <= GRAD_REL
    else:
        for g, x in zip([*got, plain, exact], [*want, want[0], jexact]):
            assert _rel(g, x) <= BF16_REL


def _ring_cfgs(dtype=torch.float32):
    jcfg, tcfg = _cfgs(dtype)
    return (dataclasses.replace(jcfg, use_ring_attention=True),
            dataclasses.replace(tcfg, use_ring_attention=True), tcfg)


def test_llama_ring_forward_matches_jax_ring():
    """``test_models.py``'s Llama ring setup (dp 2 × sp 4, T 32, fp32):
    each rank's ``forward(mesh=)`` logits, on ``params_from_jax`` weights,
    are the JAX ring forward's rows."""
    jcfg = jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, dtype=jnp.float32, use_ring_attention=True)
    tcfg = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, dtype=torch.float32, use_ring_attention=True)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(2, 32, 1, vocab=128)
    mesh = _jax_mesh(2, 4)
    want = np.asarray(jax.jit(lambda p, x: jl.forward(p, x, jcfg, mesh=mesh))(
        jl.shard_params(params, jcfg, mesh), jnp.asarray(toks)))
    full = tl.params_from_jax(jax.tree.map(np.asarray, params), device=CPU)

    def body(mesh):
        start, n = mesh.sp_span(32)
        rows = mesh.dp_rows(torch.from_numpy(toks))
        with torch.no_grad():
            return mesh.dp_rank, start, tl.forward(full, rows[:, start:start + n], tcfg,
                                                   mesh=mesh).numpy()

    for dp_rank, start, got in run_mesh(2, 1, 4, body):
        assert _rel(got, want[dp_rank:dp_rank + 1, start:start + 8]) <= GRAD_REL


@pytest.mark.parametrize("sp, t", [(2, 24), (3, 24), (4, 24)])
def test_ring_loss_and_gradients_match_jax_and_the_gather_flavour(sp, t):
    """dp 2 × sp at B 4: the ring's loss and gradients (every rank's,
    summed over dp and sp) against ``jax.value_and_grad`` of the JAX ring's
    ``loss_fn`` and against the port's all-gather flavour on the same
    weights and batch."""
    jcfg, rcfg, gcfg = _ring_cfgs()
    mesh = _jax_mesh(2, sp)
    jparams = jl.init_params(jax.random.PRNGKey(sp), jcfg)
    toks = _tokens(4, t, 50 + sp)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jl.loss_fn(p, x, jcfg, mesh=mesh)))(jl.shard_params(jparams, jcfg, mesh),
                                                         jnp.asarray(toks))
    full = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    want = optim.tree_leaves(tl.params_from_jax(jax.tree.map(np.asarray, jgrads), device=CPU))

    def grads_of(cfg):
        def body(mesh):
            mine = optim.tree_map(lambda x: x.clone().requires_grad_(), full)
            loss, grads = tl.make_mesh_grad(cfg, mesh)(mine, torch.from_numpy(toks))
            return loss.item(), grads
        return run_mesh(2, 1, sp, body)

    ring, gather = grads_of(rcfg), grads_of(gcfg)
    for loss, grads in ring:
        assert abs(loss - float(jloss)) / float(jloss) <= LOSS_REL
        assert abs(loss - gather[0][0]) / gather[0][0] <= LOSS_REL
        for g, w, o in zip(grads, want, gather[0][1]):
            assert _rel(g.numpy(), w.numpy()) <= GRAD_REL
            assert _rel(g.numpy(), o.numpy()) <= GRAD_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ring_train_step_matches_jax(dtype):
    """8 gloo ranks at dp 2 × tp 2 × sp 2 with ``use_ring_attention``
    against ``make_train_step`` of the JAX ring over 8 CPU devices, B 4, T
    16, as ``test_dp_tp_sp_train_step_matches_jax`` holds the all-gather
    flavour."""
    jcfg, tcfg, _ = _ring_cfgs(dtype)
    jinit, jstep = jl.make_train_step(jcfg, _jax_mesh(2, 2, tp=2))
    jparams, jstate = jinit(jax.random.PRNGKey(7))
    full = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    n_steps = 3 if dtype == torch.float32 else 1
    batches = [_tokens(4, 16, 30 + i) for i in range(n_steps)]
    jlosses = []
    for toks in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        jlosses.append(float(jloss))
    want = tl.params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
                              device=CPU)

    def body(mesh):
        _, step = tl.make_train_step(tcfg, device=CPU, mesh=mesh)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(),
                                tl.shard_params(full, tcfg, mesh.tp_rank, mesh.tp))
        state = optim.adamw_init(params)
        losses = [step(params, state, torch.from_numpy(t))[2].float().item() for t in batches]
        return mesh.tp_rank, losses, [p.detach() for p in optim.tree_leaves(params)]

    results = run_mesh(2, 2, 2, body)
    for tp_rank, losses, leaves in results:
        assert losses == results[0][1]
        for got, w in zip(losses, jlosses):
            assert abs(got - w) / w <= STEP_LOSS_REL[dtype]
        for got, w in zip(leaves, optim.tree_leaves(tl.shard_params(want, tcfg, tp_rank, 2))):
            diff = (got.float() - w).abs()
            if dtype == torch.float32:
                assert diff.max().item() <= PARAM_ATOL_FP32
            else:
                bound = BF16_FLIP + BF16_ULP * torch.maximum(got.float().abs(), w.abs())
                assert bool((diff <= bound).all()), (diff / bound).max().item()


def test_import_scan_covers_the_ring_slice():
    """The modules this slice added or changed import with JAX, the JAX
    package and msgpack blocked (``tests/test_torch_serving.py`` scans every
    import statement)."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import cordum_tpu_torch.ops.ring_attention, cordum_tpu_torch.ops.dense_attention
import cordum_tpu_torch.parallel.mesh, cordum_tpu_torch.models.llama, chip_smoke
assert callable(cordum_tpu_torch.ops.ring_attention.ring_attention)
assert callable(chip_smoke.phase_ring_kernel) and callable(chip_smoke.phase_ring_mesh)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr

