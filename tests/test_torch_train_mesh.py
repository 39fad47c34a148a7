"""The training rank mesh (``cordum_tpu_torch/parallel/mesh.py``
``TrainMesh``) and data-parallel Llama training over it
(``models/llama.py`` ``make_train_step(..., mesh=)``), on the CPU, against
the JAX package's ``build_mesh`` and ``make_train_step`` and against the
port's one-card step; then ``chip_smoke.py``'s phase 12 rehearsed on the
CPU.

Ranks are threads over in-process gloo groups (``in_process_meshes``),
except in the tests over real processes and a ``TCPStore``.  The Llama
config is ``LlamaConfig.tiny()``'s widths; tokens come from numpy with a
seed; JAX weights cross by ``params_from_jax``.  Tolerances, fp32 unless
said:

* against JAX's mesh step: each loss within 1e-4 (fp32) and 2e-2 (bf16)
  relative, every param after 3 fp32 steps within 6 lr and after 1 bf16
  step within ``2 lr (1 + 2^-5) + 2^-7 |x|`` (an Adam update is about lr
  sign(g); ``tests/test_torch_pipeline.py``'s derivation);
* against the port's one-card step: the loss within 1e-6 relative and
  every gradient within 1e-6 of its largest ``|value|`` (the same
  operations on fewer rows; the mean of the ranks' means is the global
  mean).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cordum_tpu.models import llama as jl
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import pipeline as tp
from cordum_tpu_torch.parallel import mesh as tm
from cordum_tpu_torch.parallel.mesh import MeshSpec, in_process_meshes

from .test_torch_pipeline_ranks import run_ranks

CPU = torch.device("cpu")
ONE_PROCESS_REL = 1e-6
LR = 3e-4
STEP_LOSS_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PARAM_ATOL_FP32 = 6 * LR
BF16_ULP = 2.0**-7
BF16_FLIP = 2 * LR * (1 + 2.0**-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kw = {k: getattr(tl.LlamaConfig.tiny(), k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq_len")}
    return jl.LlamaConfig(dtype=jdt, **kw), tl.LlamaConfig(dtype=dtype, **kw)


def _tokens(b, t, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp, pp", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_mesh_coordinates_and_lines_are_the_reference_grid(dp, pp):
    """Rank r sits where device r sits in ``build_mesh``'s grid, and its dp
    and pp lines are the grid's lines through it; the groups sum over
    exactly those ranks."""
    n = dp * pp
    grid = np.vectorize(lambda d: d.id)(
        jmesh.build_mesh(jmesh.MeshSpec(dp=dp, pp=pp), devices=jax.devices()[:n]).devices)
    assert grid.shape == (dp, 1, 1, 1, pp)
    sizes = MeshSpec(dp=dp, pp=pp).resolve(n)

    def body(mesh):
        sums = {}
        for over in ("dp", "pp", "world"):
            t = torch.tensor([2.0 ** mesh.rank])
            sums[over] = int(mesh.all_reduce(t, over).item())
        return mesh.coords, mesh.backend, sums

    for r, (coords, backend, sums) in enumerate(run_ranks(dp, pp, body)):
        idx = tuple(int(i) for i in np.argwhere(grid == r)[0])
        assert tuple(coords[a] for a in tm.AXES) == idx
        assert tm.mesh_coords(sizes, r) == coords and tm.mesh_rank(sizes, coords) == r
        d, p = coords["dp"], coords["pp"]
        assert tm.line_ranks(sizes, r, "dp") == grid[:, 0, 0, 0, p].tolist()
        assert tm.line_ranks(sizes, r, "pp") == grid[d, 0, 0, 0, :].tolist()
        assert sums["dp"] == sum(2 ** x for x in grid[:, 0, 0, 0, p])
        assert sums["pp"] == sum(2 ** x for x in grid[d, 0, 0, 0, :])
        assert sums["world"] == 2 ** n - 1
        assert backend == "gloo"


@pytest.mark.parametrize("axis, item", [("ep", "A12")])
def test_axes_not_yet_ported_are_refused(axis, item):
    """The refusal this test once held (a training mesh with ep above 1,
    not ported before ROADMAP A12) is gone: an ep 2 mesh joins, each rank
    on its own ep coordinate, and its ep line (and the tp × ep plane, here
    the same two ranks) sums over both ranks."""
    meshes = in_process_meshes(MeshSpec(dp=1, **{axis: 2}), 2, CPU, timeout_s=10)
    out: list = [None, None]

    def body(mesh):
        out[mesh.rank] = (mesh.coords[axis], mesh.ep,
                          int(mesh.all_reduce(torch.tensor([1.0 + mesh.rank]), axis).item()),
                          int(mesh.all_reduce(torch.tensor([1.0]), tm.EXPERT_PLANE).item()))

    threads = [threading.Thread(target=body, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    for m in meshes:
        m.close()
    assert item == "A12" and out == [(0, 2, 3, 2), (1, 2, 3, 2)]


def test_backend_is_nccl_only_for_distinct_cards():
    assert tm.choose_backend(["cuda:a", "cuda:b"]) == "nccl"
    assert tm.choose_backend(["cuda:a", "cuda:a"]) == "gloo"
    assert tm.choose_backend(["cpu", "cpu"]) == "gloo"


def test_p2p_carries_tensors_between_pp_neighbours_and_counts_host_time():
    def body(mesh):
        if mesh.pp_rank == 0:
            mesh.send(torch.arange(6.0).reshape(2, 3) + mesh.dp_rank, 1, 5)
            return None, mesh.calls["p2p"]
        got = mesh.recv((2, 3), torch.float32, 0, 5)
        return got, mesh.calls["p2p"]

    out = run_ranks(2, 2, body)
    for rank, (got, calls) in enumerate(out):
        assert calls == 1
        if rank % 2:
            assert torch.equal(got, torch.arange(6.0).reshape(2, 3) + rank // 2)


@pytest.mark.parametrize("kind", ["all_reduce", "recv"])
def test_a_silent_rank_fails_its_peers_within_the_timeout(kind):
    """A peer that never calls: the waiting rank's call raises within the
    group's timeout (2 s) rather than hanging."""
    meshes = in_process_meshes(MeshSpec(dp=2 if kind == "all_reduce" else 1,
                                        pp=1 if kind == "all_reduce" else 2),
                               2, CPU, timeout_s=2.0)
    try:
        waiting = meshes[1]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            if kind == "all_reduce":
                waiting.all_reduce(torch.ones(3), "dp")
            else:
                waiting.recv((3,), torch.float32, 0, 0)
        assert time.monotonic() - t0 < 10.0
    finally:
        for m in meshes:
            m.close()


def test_a_closed_mesh_refuses_calls():
    meshes = in_process_meshes(MeshSpec(dp=2), 2, CPU, timeout_s=5)
    for m in meshes:
        m.close()
        m.close()  # idempotent
    with pytest.raises(RuntimeError, match="the mesh was closed"):
        meshes[0].all_reduce(torch.ones(1))


# ---------------------------------------------------------------------------
# data-parallel Llama
# ---------------------------------------------------------------------------


def _dp_grads(tcfg, params0, toks, dp):
    def body(mesh):
        params = optim.tree_map(lambda t: t.clone().requires_grad_(), params0)
        loss, grads = tl.make_mesh_grad(tcfg, mesh)(params, torch.from_numpy(toks))
        return loss.item(), grads

    return run_ranks(dp, 1, body)


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_loss_and_gradients_match_one_card(dp):
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, generator=torch.Generator().manual_seed(dp), device=CPU)
    toks = _tokens(4, 16, dp)
    results = _dp_grads(tcfg, params, toks, dp)
    leaves = [p.clone().requires_grad_() for p in optim.tree_leaves(params)]
    loss = tl.loss_fn(_rebuild(params, iter(leaves)), torch.from_numpy(toks), tcfg)
    want = torch.autograd.grad(loss, leaves)
    for got_loss, grads in results:
        assert got_loss == results[0][0]  # every rank returns the global loss
        assert abs(got_loss - loss.item()) / loss.item() <= ONE_PROCESS_REL
        for g, w in zip(grads, want):
            assert _rel(g.numpy(), w.numpy()) <= ONE_PROCESS_REL


def _rebuild(tree, it):
    """The leaves from ``it`` (in ``tree_leaves`` order) in ``tree``'s
    structure."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return [_rebuild(x, it) for x in tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("dp", [2, 4])
def test_dp_train_step_matches_jax(dp, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jinit, jstep = jl.make_train_step(
        jcfg, jmesh.build_mesh(jmesh.MeshSpec(dp=dp), devices=jax.devices()[:dp]))
    jparams, jstate = jinit(jax.random.PRNGKey(dp))
    full = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    n_steps = 3 if dtype == torch.float32 else 1
    batches = [_tokens(8, 16, 20 + i) for i in range(n_steps)]
    jlosses = []
    for toks in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
        jlosses.append(float(jloss))

    def body(mesh):
        _, step = tl.make_train_step(tcfg, device=CPU, mesh=mesh)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(), full)
        state = optim.adamw_init(params)
        losses = [step(params, state, torch.from_numpy(t))[2].float().item() for t in batches]
        return losses, [p.detach() for p in optim.tree_leaves(params)]

    results = run_ranks(dp, 1, body)
    want = optim.tree_leaves(jax.tree.map(
        lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))), jparams))
    for losses, leaves in results:
        assert losses == results[0][0]
        for got, w in zip(losses, jlosses):
            assert abs(got - w) / w <= STEP_LOSS_REL[dtype]
        for got, w in zip(leaves, want):
            diff = (got.float() - w).abs()
            if dtype == torch.float32:
                assert diff.max().item() <= PARAM_ATOL_FP32
            else:
                bound = BF16_FLIP + BF16_ULP * torch.maximum(got.float().abs(), w.abs())
                assert bool((diff <= bound).all()), (diff / bound).max().item()
    # the replicas stay equal, bit for bit
    for _, leaves in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves, results[0][1]))


def test_llama_over_pipeline_stages_is_refused():
    _, tcfg = _cfgs()

    def body(mesh):
        with pytest.raises(ValueError, match="the llama family has no pipeline stages"):
            tl.make_train_step(tcfg, device=CPU, mesh=mesh)
        return True

    assert run_ranks(1, 2, body) == [True, True]


def test_dp_refuses_a_batch_it_cannot_split():
    _, tcfg = _cfgs()
    params0 = tl.init_params(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)

    def body(mesh):
        params = optim.tree_map(lambda t: t.clone().requires_grad_(), params0)
        with pytest.raises(ValueError, match="3 rows do not split over dp 2"):
            tl.make_mesh_grad(tcfg, mesh)(params, torch.zeros(3, 8, dtype=torch.int32))
        return True

    assert run_ranks(2, 1, body) == [True, True]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12 on the CPU
# ---------------------------------------------------------------------------


def _job(family, dp, pp, **kw):
    kw = {"widths": "tiny", "layers": 4 if family == "pipeline" else 2, "dtype": "float32",
          "batch": 4, "seq": 16, "steps": 2, "m": 2 if family == "pipeline" else 1,
          "device": "cpu", **kw}
    return chip_smoke.mesh_job(family, dp, pp, **kw)


def _rehearse(job, tmp_path, monkeypatch):
    """Phase 12's leg with the ranks as threads: the one-process oracle,
    every rank's :func:`chip_smoke.train_rank`, then its gates; the CPU
    counts no kernel launch, so each rank's launches are set to what its
    layers and steps give before the launch gate."""
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    chip_smoke.mesh_oracle(torch, CPU, "cpu", job, str(tmp_path))
    docs = run_ranks(job["dp"], job["pp"], lambda mesh: chip_smoke.train_rank(job, mesh.rank,
                                                                              mesh=mesh))
    layers = job["layers"] // job["pp"] * job["m"] if job["family"] == "pipeline" \
        else job["layers"]
    for d in docs:
        d["launches"] = [layers * job["steps"]] * 2
    return chip_smoke.check_mesh_ranks("cpu", job, docs, collective="gloo", falling=True)


@pytest.mark.parametrize("family, dp, pp", [("pipeline", 2, 2), ("pipeline", 1, 4),
                                            ("llama", 2, 1)])
def test_chip_smoke_mesh_gates_pass_on_the_cpu(tmp_path, monkeypatch, family, dp, pp):
    launches = _rehearse(_job(family, dp, pp), tmp_path, monkeypatch)
    per = (4 // pp * 2 if family == "pipeline" else 2) * 2
    assert launches == [per * dp * pp] * 2


def test_chip_smoke_mesh_gate_refuses_a_hop_with_the_wrong_microbatch(tmp_path, monkeypatch):
    """Stage 0 sends its first microbatch's output in place of every later
    one: the loss gate refuses it."""
    sent = {}
    real = tp._hop_forward

    def stale(mesh, y, m):
        first = sent.setdefault(mesh.rank, y)
        real(mesh, first if m else y, m)

    monkeypatch.setattr(tp, "_hop_forward", stale)
    with pytest.raises(AssertionError, match="against the one-process step: losses"):
        _rehearse(_job("pipeline", 1, 2), tmp_path, monkeypatch)


def test_chip_smoke_mesh_gate_refuses_dp_gradients_summed(tmp_path, monkeypatch):
    """The dp gradients of each rank's mean over its own rows summed (each
    share taken over ``B / dp`` rows where it should be over ``B``): the
    loss is unchanged and Adam's first steps barely see the scale, but the
    gradient gate refuses it."""
    real = tl._mesh_sum

    def summed(value, grads, mesh):
        value, grads = real(value, grads, mesh)
        for g in grads:
            g.mul_(mesh.dp)
        return value, grads

    monkeypatch.setattr(tl, "_mesh_sum", summed)
    with pytest.raises(AssertionError, match=r"worst gradient \[(0\.[5-9]|1\.0)"):
        _rehearse(_job("llama", 2, 1), tmp_path, monkeypatch)


def test_chip_smoke_mesh_ranks_over_processes_and_a_tcp_store(tmp_path, monkeypatch):
    """Two rank processes of ``chip_smoke.py --train-rank`` (pp 2, CPU)
    meet at a ``TCPStore`` and pass phase 12's gates against the
    one-process step; the CPU counts no launch, so the launch gate is
    read apart."""
    job = _job("pipeline", 1, 2, layers=2, steps=2)
    monkeypatch.setattr(chip_smoke, "mesh_launches", lambda job, docs: [d["launches"]
                                                                        for d in docs])
    docs, launches = chip_smoke.mesh_leg(torch, CPU, "cpu", job, oracle=True, collective="gloo",
                                         falling=True)
    assert launches == [[0, 0], [0, 0]]
    assert [d["coords"]["pp"] for d in docs] == [0, 1]
    assert [d["collective"] for d in docs] == ["gloo", "gloo"]
    # steps 2 on: each rank sends and receives once a microbatch a step
    assert all(d["calls"]["p2p"] == 2 * 2 * (job["steps"] - 1) for d in docs)
    assert docs[0]["leaves"] == ["embed", *(f"stages/{k}" for k in sorted(tp.STAGE_LEAVES))]


def test_chip_smoke_mesh_rank_fails_the_run(tmp_path):
    """A rank process that fails fails the leg, with its log printed."""
    job = dict(_job("pipeline", 1, 2), layers=3)  # 3 layers do not split over 2 stages
    with pytest.raises(AssertionError, match="rank processes exited"):
        chip_smoke.run_train_ranks(job, str(tmp_path))


def test_import_scan_covers_the_mesh_slice():
    """The modules this slice changed import with JAX, the JAX package and
    msgpack blocked (``tests/test_torch_serving.py`` scans every import
    statement)."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import cordum_tpu_torch.parallel.mesh, cordum_tpu_torch.models.pipeline
import cordum_tpu_torch.models.llama, chip_smoke
assert callable(chip_smoke.train_rank) and callable(cordum_tpu_torch.parallel.mesh.TrainMesh.join)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr
