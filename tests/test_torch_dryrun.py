"""The port's driver entry points (``cordum_tpu_torch/graft_entry.py``), the
counterpart of ``__graft_entry__.py``, on the CPU.

* ``factor2`` and the three meshes and batch shapes of the dry run are the
  reference's for n = 1..16 (its ``factor2`` read out of
  ``__graft_entry__.py``'s source).
* ``python -m cordum_tpu_torch.graft_entry --dryrun 8 --cpu`` (8 gloo CPU
  rank processes) prints three finite losses at the meshes
  ``MULTICHIP_r05.json`` records: dense dp 2 tp 2 sp 2, MoE dp 2 tp 2 ep
  2, pipeline dp 4 pp 2.
* Parity: each of the three meshes on 8 in-process gloo ranks, fed the JAX
  dry run's own draws (weights from ``PRNGKey(0)``, ``(2)``, ``(4)``,
  tokens from ``(1)``, ``(3)``, ``(5)``, across by ``params_from_jax``),
  against the JAX package's step on ``build_mesh`` over the 8 CPU devices
  of ``tests/conftest.py``: each loss within ``STEP_LOSS_REL`` (2e-2) in
  bf16, the reference's dtype, and within 1e-5 in fp32 (the same sums,
  split over the ranks at other places than XLA's).
* ``entry()``: the reference's widths, a ``[4, 128]`` batch, finite
  logits.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.models import moe as jm
from cordum_tpu.models import pipeline as jp
from cordum_tpu.parallel import mesh as jmesh
from cordum_tpu_torch import graft_entry, optim
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import moe as tm
from cordum_tpu_torch.models import pipeline as tp
from cordum_tpu_torch.parallel.mesh import in_process_meshes

from .test_torch_train_mesh import STEP_LOSS_REL

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60.0
FP32_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here on one torch thread: its ranks (threads or processes)
    and the other test workers share the host's cores, and tiny steps gain
    nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reference_factor2():
    """``factor2`` as ``__graft_entry__.py`` defines it (nested in
    ``dryrun_multichip``), compiled from its source."""
    with open(os.path.join(REPO, "__graft_entry__.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "factor2")
    scope: dict = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "__graft_entry__.py", "exec"), scope)
    return scope["factor2"]


@pytest.mark.parametrize("n", range(1, 17))
def test_factor2_and_the_meshes_are_the_reference_dry_runs(n):
    ref = _reference_factor2()
    for k in (1, 2, 3):
        assert graft_entry.factor2(n, k) == ref(n, k)
    (tp_, sp), _ = ref(n, 2)
    (tp2, ep), _ = ref(n, 2)
    pp = 2 if n % 2 == 0 else 1
    want = [jmesh.MeshSpec(dp=-1, tp=tp_, sp=sp), jmesh.MeshSpec(dp=-1, tp=tp2, ep=ep),
            jmesh.MeshSpec(dp=-1, pp=pp)]
    cases = graft_entry.dryrun_cases(n)
    assert [c.name for c in cases] == list(graft_entry.DRYRUN_NAMES)
    dps = [w.resolve(n)["dp"] for w in want]
    for case, w in zip(cases, want):
        assert case.spec.resolve(n) == w.resolve(n)
    assert [c.tokens for c in cases] == [(dps[0] * 2, max(16, sp * 8)), (dps[1] * 2, 16),
                                         (dps[2] * 2 * 2, 16)]
    assert [c.seeds for c in cases] == [(0, 1), (2, 3), (4, 5)]
    assert cases[2].cfg.n_stages == pp and cases[2].cfg.n_microbatches == 2


def test_dryrun_over_eight_cpu_rank_processes_prints_the_reference_meshes():
    proc = subprocess.run([sys.executable, "-m", "cordum_tpu_torch.graft_entry", "--dryrun", "8",
                           "--cpu"], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        recorded = json.load(f)["tail"].strip().splitlines()
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip ok:")]
    pattern = re.compile(r"dryrun_multichip ok: (.+) mesh=(\{.*\}) loss=(\S+)$")
    assert len(lines) == len(recorded) == 3
    for got, want in zip(lines, recorded):
        g, w = pattern.match(got), pattern.match(want)
        assert g.group(1) == w.group(1) and g.group(2) == w.group(2)
        assert math.isfinite(float(g.group(3)))


# ---------------------------------------------------------------------------
# parity with the JAX dry run, on its own draws
# ---------------------------------------------------------------------------


def run_threads(spec, world, body):
    """``body(mesh)`` on every rank of ``spec`` over ``world`` in-process
    gloo ranks, one thread a rank; the results in rank order."""
    meshes = in_process_meshes(spec, world, CPU, timeout_s=TIMEOUT_S)
    out: list = [None] * world
    errors: list = []

    def run(mesh):
        try:
            out[mesh.rank] = body(mesh)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(e)
            for other in meshes:
                other.close()

    threads = [threading.Thread(target=run, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * TIMEOUT_S)
    for m in meshes:
        m.close()
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    return out


def _jax_case(i, dtype):
    """The JAX dry run's step ``i`` at 8 devices (``__graft_entry__.py:
    84-121``) in ``dtype``: its loss, the initial params as numpy, the
    tokens, and the port's config."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    base = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jdt)
    case = graft_entry.dryrun_cases(8, dtype)[i]
    sizes = case.spec.resolve(8)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(**sizes), devices=jax.devices()[:8])
    if i == 0:
        cfg = base
        init, step = jl.make_train_step(cfg, mesh)
        vocab = cfg.vocab_size
    elif i == 1:
        cfg = dataclasses.replace(jm.MoEConfig.tiny(), base=base)
        init, step = jm.make_train_step(cfg, mesh)
        vocab = cfg.base.vocab_size
    else:
        cfg = jp.PipelineConfig(base=base, n_stages=sizes["pp"], n_microbatches=2)
        init, step = jp.make_train_step(cfg, mesh)
        vocab = cfg.base.vocab_size
    params, state = init(jax.random.PRNGKey(case.seeds[0]))
    host = jax.tree.map(np.asarray, params)  # copied before the donating step
    tokens = jax.random.randint(jax.random.PRNGKey(case.seeds[1]), case.tokens, 0, vocab)
    if i == 2:
        tokens = jp.microbatch(tokens, 2)
    _, _, loss = step(params, state, tokens)
    return float(loss), host, np.asarray(tokens).astype(np.int32), case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", [0, 1, 2], ids=["dense", "moe", "pipeline"])
def test_each_mesh_matches_the_jax_dry_run_on_its_draws(i, dtype):
    want, host, tokens, case = _jax_case(i, dtype)
    if i == 0:
        full = tl.params_from_jax(host, device=CPU)
    elif i == 1:
        full = tm.params_from_jax(host, device=CPU)
    else:
        full = tp.params_from_jax(host, device=CPU)

    def body(mesh):
        _, step = graft_entry._train_step(case, CPU, mesh)
        if i == 0:
            mine = tl.shard_params(full, case.cfg, mesh.tp_rank, mesh.tp)
        elif i == 1:
            mine = tm.shard_params(full, case.cfg, (mesh.coords, mesh.sizes))
        else:
            mine = tp.stage_slice(full, case.cfg, mesh.pp_rank)
        params = optim.tree_map(lambda t: t.clone().requires_grad_(), mine)
        return step(params, optim.adamw_init(params), torch.from_numpy(tokens))[2].item()

    losses = run_threads(case.spec, 8, body)
    assert all(x == losses[0] for x in losses)
    bound = FP32_REL if dtype == torch.float32 else STEP_LOSS_REL[torch.bfloat16]
    assert abs(losses[0] - want) / abs(want) <= bound, (case.name, losses[0], want)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["dense", "moe", "pipeline"])
def test_rank_steps_equal_the_one_process_step_on_the_same_draws(i):
    """The port's own draws: 8 in-process ranks of a case against
    ``dryrun_one_process`` (what the chip's dryrun leg holds the ranks to),
    fp32, within 1e-5."""
    case = graft_entry.dryrun_cases(8, torch.float32)[i]
    want = graft_entry.dryrun_one_process(8, device=CPU, dtype=torch.float32)[case.name]
    losses = run_threads(case.spec, 8, lambda mesh: graft_entry._step_loss(case, CPU, mesh))
    assert all(x == losses[0] for x in losses)
    assert abs(losses[0] - want) / abs(want) <= FP32_REL


def test_entry_is_the_reference_forward_at_its_widths():
    fn, (params, tokens) = graft_entry.entry(device=CPU)
    assert tuple(tokens.shape) == (4, 128) and tokens.dtype == torch.int32
    assert params["embed"].shape == (32000, 512) and len(params["layers"]) == 4
    with torch.no_grad():
        logits = fn(params, tokens)
    assert logits.shape == (4, 128, 32000) and bool(torch.isfinite(logits).all())


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


def test_the_new_modules_import_with_jax_blocked():
    """``tests/test_torch_serving.py`` scans every module of the package
    for JAX, ``cordum_tpu`` and msgpack imports; the launcher and the
    entry points import with all three blocked."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import cordum_tpu_torch.parallel.launch, cordum_tpu_torch.graft_entry
import cordum_tpu_torch.worker.training, cordum_tpu_torch.cmd.worker, chip_smoke
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
