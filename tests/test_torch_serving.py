"""End-to-end parity of the PyTorch serving slice (``cordum_tpu_torch``)
with the JAX package, plus the port's import and device boundaries.

The port's engine over the port's backend, fed the JAX package's fp32
weights through ``params_from_jax``, must emit exactly the tokens of the
JAX dense greedy oracle (``tests/test_serving.py`` ``ref_greedy``) — for
plain greedy decoding, speculative decoding (the oracle-cut drafter of
``tests/test_speculative.py``) and copy-on-write prefix sharing.  KV
pages exported by either package's backend must import into the other's
and continue to the same tokens.  Token identity is the oracle: no
tolerance.

The oracle runs ``ref_greedy``'s loop through one jitted JAX ``forward``
over a fixed 64-slot buffer (eager JAX compiles anew for every sequence
length); the causal mask keeps the zero padding out of every real
position, and a test holds it to ``ref_greedy`` itself.
"""
import ast
import asyncio
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cordum_tpu.models import llama as jl
from cordum_tpu.serving.backend import LlamaServingBackend as JaxBackend
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.serving.backend import LlamaServingBackend, StepEntry
from cordum_tpu_torch.serving.engine import GenRequest, ServingEngine
from cordum_tpu_torch.worker.handlers import make_serving_engine

from .test_serving import ref_greedy, run_blocking
from .test_speculative import _oracle_cut_drafter

REPO = Path(__file__).resolve().parents[1]
N_NEW = 10
PROMPTS = [
    [5, 9, 17, 3],
    [7, 3, 11, 19, 2, 5, 23, 1, 13],
    [100, 42],
    [5, 9, 2, 9, 2, 9, 2, 9, 2, 9],  # repetitive: the n-gram drafter fires
]


ORACLE_LEN = 64


def _jax_greedy(jcfg, jparams):
    fwd = jax.jit(lambda p, t: jl.forward(p, t, jcfg))

    def greedy(prompt, n_new):
        toks, out = list(prompt), []
        for _ in range(n_new):
            buf = np.zeros((1, ORACLE_LEN), np.int32)
            buf[0, :len(toks)] = toks
            nxt = int(jnp.argmax(fwd(jparams, jnp.asarray(buf))[0, len(toks) - 1]))
            out.append(nxt)
            toks.append(nxt)
        return out

    return greedy


@pytest.fixture(scope="module")
def env():
    kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128)
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    oracle = _jax_greedy(jcfg, jparams)
    refs = {tuple(p): oracle(p, N_NEW) for p in PROMPTS}
    return jcfg, tcfg, jparams, tparams, refs, oracle


def test_padded_oracle_is_ref_greedy(env):
    jcfg, _, jparams, _, refs, _ = env
    p = PROMPTS[2]
    assert ref_greedy(jcfg, jparams, p, 2) == refs[tuple(p)][:2]


def _port_backend(tcfg, tparams, page_size=8):
    return LlamaServingBackend(tcfg, num_pages=64, page_size=page_size,
                               params_provider=lambda: tparams, device="cpu")


@pytest.mark.parametrize("speculative", [False, True])
async def test_engine_matches_jax_oracle(env, speculative):
    _, tcfg, _, tparams, refs, _ = env
    eng = make_serving_engine(tcfg, tparams, device="cpu",
                              speculative=speculative, max_new_tokens=N_NEW)
    assert eng.speculative is speculative
    results = await asyncio.gather(*[
        eng.submit(GenRequest(prompt=p, max_new_tokens=N_NEW, stream=False),
                   job_id=f"g{i}")
        for i, p in enumerate(PROMPTS)
    ])
    stats = eng.stats
    eng.allocator.check_consistency()
    await eng.stop()
    for p, r in zip(PROMPTS, results):
        assert r["tokens"] == refs[tuple(p)], p
    assert eng.backend.compiled_programs() == 1
    if speculative:
        assert stats.drafted_tokens > 0
    else:
        assert stats.drafted_tokens == 0


async def test_speculative_oracle_cut_matches_jax_oracle(env):
    _, tcfg, _, tparams, refs, _ = env
    prompts = PROMPTS[:3]
    seqs = [p + refs[tuple(p)] for p in prompts]
    eng = ServingEngine(_port_backend(tcfg, tparams), run_blocking=run_blocking,
                        max_new_tokens_cap=N_NEW, speculative=True, draft_k=4,
                        drafter=_oracle_cut_drafter(seqs, random.Random(7)))
    results = await asyncio.gather(*[
        eng.submit(GenRequest(prompt=p, max_new_tokens=N_NEW, stream=False),
                   job_id=f"s{i}")
        for i, p in enumerate(prompts)
    ])
    stats = eng.stats
    await eng.stop()
    for p, r in zip(prompts, results):
        assert r["tokens"] == refs[tuple(p)], p
    assert stats.accepted_tokens > 0 and stats.rolled_back_tokens > 0


async def test_cow_prefix_sharing_matches_jax_oracle(env):
    _, tcfg, _, tparams, _, oracle = env
    system = [7, 3, 11, 19, 2, 5, 23, 1]  # exactly one 8-slot page
    p1, p2, p3 = system + [13, 4], system, system + [9, 2, 6]
    eng = ServingEngine(_port_backend(tcfg, tparams), run_blocking=run_blocking,
                        max_new_tokens_cap=N_NEW)
    assert eng.prefix is not None  # the port backend carries copy_page
    outs = []
    for i, p in enumerate((p1, p2, p3)):
        r = await eng.submit(GenRequest(prompt=p, max_new_tokens=N_NEW, stream=False),
                             job_id=f"c{i}")
        outs.append(r["tokens"])
    stats = eng.stats
    eng.allocator.check_consistency()
    await eng.stop()
    assert stats.prefix_hits >= 2 and stats.cow_copies >= 1
    for p, out in zip((p1, p2, p3), outs):
        assert out == oracle(p, N_NEW), p


def _continue(backend, prompt, done, pages, n):
    """Decode to ``n`` tokens from a state whose K/V covers
    ``prompt + done[:-1]``."""
    out = list(done)
    while len(out) < n:
        (nxt,) = backend.decode([(out[-1], len(prompt) + len(out) - 1, pages)])
        out.append(int(nxt))
    return out


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_kv_migration_between_packages(env, direction):
    jcfg, tcfg, jparams, tparams, refs, _ = env
    prompt = PROMPTS[1]
    want = refs[tuple(prompt)]
    jax_be = JaxBackend(jcfg, num_pages=64, page_size=8,
                        params_provider=lambda: jparams)
    port_be = _port_backend(tcfg, tparams)
    src, dst = (jax_be, port_be) if direction == "jax_to_torch" else (port_be, jax_be)
    src_pages, dst_pages = [3, 9, 4], [12, 5, 30]
    half = _continue(src, prompt, [src.prefill(prompt, src_pages)], src_pages, 4)
    written = len(prompt) + len(half) - 1  # the last token is not fed yet
    records = src.export_kv(src_pages, 0, written)
    assert [r["used"] for r in records] == [8, 4]
    dst.import_kv(dst_pages, records)
    assert _continue(dst, prompt, half, dst_pages, N_NEW) == want
    # the destination exports the imported pages back byte for byte
    again = dst.export_kv(dst_pages, 0, written)
    assert [(r["i"], r["used"], r["shape"], r["k"], r["v"]) for r in again] == [
        (r["i"], r["used"], r["shape"], r["k"], r["v"]) for r in records]


def test_backend_rejects_out_of_arena_pages(env):
    _, tcfg, _, tparams, _, _ = env
    be = _port_backend(tcfg, tparams)
    with pytest.raises(ValueError, match="outside the arena"):
        be.step([StepEntry(tokens=[1, 2], start=0, pages=[64])])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every import statement of the port, ``chip_smoke.py`` and
    ``chip_ab.py``, lazy ones inside functions included: no JAX, nothing of
    the JAX package and no ``msgpack`` (the port carries its own codec)."""
    files = sorted((REPO / "cordum_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_ab.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cordum_tpu", "flax", "optax", "msgpack"), (f, mod)


def test_port_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import cordum_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cordum_tpu_torch.__path__, 'cordum_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
import chip_smoke, chip_ab
assert not any(k.split('.')[0] in ('jax', 'cordum_tpu', 'msgpack') for k in sys.modules)
print(len(mods))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10


#: the gateway slice's modules: each must exist in the port and be reached
#: by both scans above
GATEWAY_SLICE = (
    "infra.secrets", "infra.locks", "infra.dlq", "infra.artifacts", "infra.schemareg",
    "obs.assembler", "obs.collector", "obs.slo", "obs.fleet", "workflow.models",
    "workflow.eval", "workflow.store", "workflow.engine", "context.service",
    "controlplane.workflowengine.service", "cmd.workflow_engine", "controlplane.gateway.auth",
    "controlplane.gateway.admission", "controlplane.gateway.app", "cmd.gateway", "packs",
    "controlplane.safetykernel.bundles")


@pytest.mark.parametrize("name", GATEWAY_SLICE)
def test_gateway_slice_module_is_scanned(name):
    """Each module of the gateway slice is a file of the port (so the AST
    scan reads it), imports nothing of JAX, the JAX package or ``msgpack``
    (lazy imports included) and nothing of ``torch`` either: the gateway,
    the workflow engine and the context service are host code, and their
    binaries start without loading the device stack."""
    path = REPO / "cordum_tpu_torch" / (name.replace(".", "/") + ".py")
    assert path.is_file(), path
    tops = {mod.split(".")[0] for mod in _imports(path)}
    assert not tops & {"jax", "jaxlib", "cordum_tpu", "flax", "optax", "msgpack", "torch"}, tops
    if name.startswith("cmd."):
        code = f"""
import sys
class Block:
    def find_spec(self, n, path=None, target=None):
        if n.split('.')[0] in ('jax', 'jaxlib', 'cordum_tpu', 'msgpack', 'torch'):
            raise ImportError('blocked: ' + n)
sys.meta_path.insert(0, Block())
import cordum_tpu_torch.{name}
"""
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_a_card(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg, _, tparams, _, _ = env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_engine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_kv_pages(tcfg, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_params(tcfg, generator=torch.Generator())
