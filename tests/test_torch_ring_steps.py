"""Ring attention's steps (``cordum_tpu_torch/ops/ring_attention.py``) and
B9's ring entries (``ops/dense_attention.py``: "D only", "D given"), the
merge (B6, ``csrc/ring_attention.cu``) and the ring's hop
(``parallel/mesh.py`` ``TrainMesh.shift``), without JAX.

On the CPU, each plain version against autograd of ``gqa_attention`` on the
whole row: a row's keys cut into chunks, the chunks' forward pairs merged
equal the whole's ``(out, lse)``; the "D only" partials sum to the whole
row's ``D``; "D given" over the chunks sums to the whole gradient.  The
hop turns the right way at sp 2, 3 and 4 and does not hang; a ring step of
the Llama family makes the launches and hops the design gives (per layer,
rank ``r`` of sp ``n``: ``r + 1`` forward chunks, merges, "D given" and, in
bf16, "D only"; ``2n - 1`` hops, ``3n - 2`` in bf16) and no all-gather or
reduce-scatter.

Tolerances: fp32 1e-6 of the largest ``|value|`` where only the sum order
differs (a merge of two chunks, partial sums of D over 64 keys), 1e-5 for
gradients (sums over chunks in another order than autograd's).

The ``gpu``-marked tests hold the kernels against the plain versions on the
card (fp32: 1e-5 absolute on outputs, 1e-4 of the largest value on
gradients and D; bf16: ``chip_smoke``'s row gate against the exact result;
the merge 2^-20 of the largest value) and count each launch.  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_ring_steps.py``.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.ops import dense_attention as da
from cordum_tpu_torch.ops import ring_attention as ra
from cordum_tpu_torch.parallel.mesh import MeshSpec, in_process_meshes

CPU = torch.device("cpu")
TIMEOUT_S = 60.0
MERGE_REL = 1e-6
GRAD_REL = 1e-5


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _case(b, t, kvh, rep, hd, dtype=torch.float32, *, seed=0):
    rng = np.random.default_rng(seed)
    h = kvh * rep
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((b, t, h, hd), (b, t, kvh, hd), (b, t, kvh, hd), (b, t, h, hd))]


def _whole(q, k, v, do, pos):
    """Autograd of ``gqa_attention`` on the whole row: out and (dq, dk, dv)."""
    return chip_smoke.dense_grads(torch, da.dense_attention_reference, q, k, v, pos, do)


def _chunks(t, sp, rank):
    """``(owner, positions)`` of rank ``rank``'s live chunks, ring order."""
    tq = t // sp
    live = [(o, ra.chunk_positions(rank, o, 2, tq, tq, True, CPU))
            for o in ((rank - s) % sp for s in range(sp))]
    return [(o, p) for o, p in live if p is not None]


def run_mesh(dp, tp, sp, body):
    """``body(mesh)`` on every rank of a dp × tp × sp mesh, one thread a
    rank; the results in rank order, the first error re-raised."""
    world = dp * tp * sp
    meshes = in_process_meshes(MeshSpec(dp=dp, tp=tp, sp=sp), world, CPU, timeout_s=TIMEOUT_S)
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


# ---------------------------------------------------------------------------
# the plain chunk steps against the whole row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_forward_is_the_dense_reference_with_its_lse(dtype):
    """``dense_attention_fwd_reference``'s output is the plain version's bit
    for bit and its ``lse`` the masked scores' log-sum-exp; a row with no
    live key (a negative position) is uniform with ``lse = log(Tk)``, as
    the kernels make it."""
    q, k, v, _ = _case(2, 9, 2, 2, 16, dtype, seed=1)
    pos = torch.arange(-1, 8, dtype=torch.int32).expand(2, 9).contiguous()
    out, lse = da.dense_attention_fwd_reference(q, k, v, pos)
    assert torch.equal(out, da.dense_attention_reference(q, k, v, pos))
    scores, _ = da._masked_scores(q, k, True, pos)
    assert _rel(lse[:, :, 1:], torch.logsumexp(scores, -1)[:, :, 1:]) <= 1e-7
    assert torch.allclose(lse[:, :, 0], torch.full_like(lse[:, :, 0], float(np.log(9))))
    assert _rel(out[:, 0].float(), v.float().mean(1).repeat_interleave(2, 1)) <= 1e-2


@pytest.mark.parametrize("sp, rank", [(2, 1), (4, 3), (4, 2)])
def test_two_or_more_chunks_merged_equal_the_whole(sp, rank):
    """A rank's live chunks (ring order), each through the plain forward,
    merged (``ring_merge_reference``): the whole row's output and ``lse``."""
    t = 8 * sp
    q, k, v, _ = _case(2, t, 2, 2, 16, seed=sp + rank)
    tq = t // sp
    qr = q[:, rank * tq:(rank + 1) * tq].contiguous()
    pos = torch.arange(rank * tq, (rank + 1) * tq, dtype=torch.int32).expand(2, tq).contiguous()
    want_out, want_lse = da.dense_attention_fwd_reference(qr, k, v, pos)
    acc = lse = None
    for o, p in _chunks(t, sp, rank):
        acc, lse = ra.ring_merge_reference(acc, lse, *da.dense_attention_fwd_reference(
            qr, k[:, o * tq:(o + 1) * tq], v[:, o * tq:(o + 1) * tq], p))
    assert _rel(acc, want_out) <= MERGE_REL
    assert _rel(lse, want_lse) <= MERGE_REL


def test_merge_of_minus_inf_terms():
    """A term whose ``lse`` is ``-inf`` weighs 0; two give 0 and ``-inf``."""
    out_c = torch.randn(1, 3, 2, 16)
    lse_c = torch.tensor([[[0.5, -np.inf, 1.0], [-np.inf, -np.inf, 2.0]]], dtype=torch.float32)
    acc, lse = torch.randn(1, 3, 2, 16), torch.tensor(
        [[[-np.inf, -np.inf, 1.0], [0.0, -np.inf, -np.inf]]], dtype=torch.float32)
    a0 = acc.clone()
    acc, lse = ra.ring_merge_reference(acc, lse, out_c, lse_c)
    assert torch.isfinite(acc).all()
    assert torch.equal(acc[0, 0, 0], out_c[0, 0, 0]) and lse[0, 0, 0] == 0.5
    assert torch.equal(acc[0, 1, 0], torch.zeros(16)) and lse[0, 0, 1] == -np.inf
    assert torch.equal(acc[0, 0, 1], a0[0, 0, 1]) and lse[0, 1, 0] == 0.0
    assert torch.equal(acc[0, 2, 1], out_c[0, 2, 1]) and lse[0, 1, 2] == 2.0
    assert _rel(lse[0, 0, 2:], torch.tensor([1.0 + np.log(2.0)])) <= 1e-7


@pytest.mark.parametrize("sp, rank", [(2, 1), (4, 3), (4, 1)])
def test_d_partials_sum_to_the_whole_rows_d(sp, rank):
    """``sum_k P dP`` over each live chunk under the row's ``lse``, summed
    over the ring: the whole row's ``rowsum(dO * out)`` in fp32 (the two
    are equal in exact arithmetic); in bf16 the chunks' "D only" partials
    (``dense_attention_d_reference``) sum to the whole row's."""
    t = 16 * sp
    tq = t // sp
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _case(2, t, 2, 2, 16, dtype, seed=7 + sp + rank)
        qr, dor = (x[:, rank * tq:(rank + 1) * tq].contiguous() for x in (q, do))
        pos = torch.arange(rank * tq, (rank + 1) * tq, dtype=torch.int32).expand(2, tq).contiguous()
        out, lse = da.dense_attention_fwd_reference(qr, k, v, pos)
        parts = [(k[:, o * tq:(o + 1) * tq], v[:, o * tq:(o + 1) * tq], p)
                 for o, p in _chunks(t, sp, rank)]
        if dtype == torch.float32:
            total = sum(da.d_from_weights(qr, kc, vc, p, lse, dor) for kc, vc, p in parts)
            assert _rel(total, (dor * out).sum(-1).transpose(1, 2)) <= GRAD_REL
        else:
            total = sum(da.dense_attention_d_reference(qr, kc, vc, p, out, lse, dor)
                        for kc, vc, p in parts)
            whole = da.dense_attention_d_reference(qr, k, v, pos, out, lse, dor)
            assert _rel(total, whole) <= MERGE_REL


@pytest.mark.parametrize("sp, rank", [(2, 1), (4, 3), (4, 0)])
def test_d_given_over_the_chunks_sums_to_the_whole_gradient(sp, rank):
    """fp32: with the row's ``D`` and ``lse``, "D given" on each live chunk
    (``dense_attention_bwd_reference(..., d=D)``): dq summed over the
    chunks, and each chunk's dk and dv, are autograd's on the whole row."""
    t = 8 * sp
    tq = t // sp
    q, k, v, do = _case(2, t, 2, 2, 16, seed=20 + sp + rank)
    qr, dor = (x[:, rank * tq:(rank + 1) * tq].contiguous() for x in (q, do))
    pos = torch.arange(rank * tq, (rank + 1) * tq, dtype=torch.int32).expand(2, tq).contiguous()
    out, dq, dk, dv = _whole(qr, k, v, dor, pos)
    _, lse = da.dense_attention_fwd_reference(qr, k, v, pos)
    d = da.dense_attention_d_reference(qr, k, v, pos, out, lse, dor)
    got_dq = torch.zeros_like(dq)
    got_dk, got_dv = torch.zeros_like(dk), torch.zeros_like(dv)
    for o, p in _chunks(t, sp, rank):
        sl = slice(o * tq, (o + 1) * tq)
        gq, gk, gv = da.dense_attention_bwd_reference(qr, k[:, sl], v[:, sl], p, out, lse, dor,
                                                      d=d)
        got_dq += gq
        got_dk[:, sl], got_dv[:, sl] = gk, gv
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        assert _rel(got, want) <= GRAD_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_backward_without_d_is_autograd(dtype):
    """``dense_attention_bwd_reference`` with its own D: fp32 autograd's
    gradients within 1e-5 of their max; bf16 within the row gate's reach
    (2e-2 of the max, a few bf16 roundings at other places)."""
    q, k, v, do = _case(2, 33, 2, 2, 16, dtype, seed=4)
    pos = torch.arange(33, dtype=torch.int32).expand(2, 33).contiguous()
    out, *want = _whole(q, k, v, do, pos)
    _, lse = da.dense_attention_fwd_reference(q, k, v, pos)
    got = da.dense_attention_bwd_reference(q, k, v, pos, out, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel(g.float(), w.float()) <= (GRAD_REL if dtype == torch.float32 else 2e-2)


def test_whole_ring_by_chunks_passes_the_gate_on_the_cpu():
    """``chip_smoke.check_ring_whole`` (13.1's whole-ring gate) on the
    plain steps, both dtypes, both ranks of sp 2: the plain ring against
    the plain version on the whole row."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _case(1, 256, 1, 2, 64, dtype, seed=9)
        for rank in (0, 1):
            qr, dor = (x[:, rank * 128:(rank + 1) * 128].contiguous() for x in (q, do))
            chip_smoke.check_ring_whole(torch, ra.PLAIN_STEPS, qr, k, v, dor, sp=2, rank=rank,
                                        what=f"plain ring rank {rank}")


# ---------------------------------------------------------------------------
# the hop and the ring over gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_shift_turns_the_ring_the_right_way(sp):
    """A hop sends to the next sp rank and receives from the previous one,
    tensors of three dtypes packed as one exchange; ``sp`` hops bring a
    rank's own tensors back; counted as p2p calls."""
    def body(mesh):
        r = mesh.sp_rank
        mine = [torch.full((3, 5), float(r)), torch.full((7,), r, dtype=torch.bfloat16),
                torch.full((2, 2), r, dtype=torch.int32)]
        one = mesh.shift(mine)
        back = mine
        for _ in range(sp):
            back = mesh.shift(back)
        return r, one, back, mine, mesh.calls["p2p"]

    for r, one, back, mine, calls in run_mesh(1, 1, sp, body):
        prev = (r - 1) % sp
        assert [x.dtype for x in one] == [torch.float32, torch.bfloat16, torch.int32]
        assert all(bool((x == prev).all()) for x in one)
        assert all(torch.equal(a, b) for a, b in zip(back, mine))
        assert calls == sp + 1


def _counting_steps(counts):
    """The plain steps, each call counted in ``counts[thread][step]``."""
    def counted(step, fn):
        def call(*a, **kw):
            tally = counts.setdefault(threading.get_ident(), dict.fromkeys(
                ("fwd", "merge", "d", "bwd"), 0))
            tally[step] += 1
            return fn(*a, **kw)
        return call

    return ra.ChunkSteps(**{f.name: counted(f.name, getattr(ra.PLAIN_STEPS, f.name))
                            for f in dataclasses.fields(ra.ChunkSteps)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tp, sp", [(1, 4), (2, 2), (1, 3)])
def test_ring_step_makes_the_designs_launches_and_hops(monkeypatch, tp, sp, dtype):
    """One gradient of the Llama ring at tp × sp: per layer, rank ``r``
    runs ``r + 1`` forward chunks, merges and "D given", ``r + 1`` "D only"
    in bf16 (one in fp32), ``2 sp - 1`` hops (``3 sp - 2`` in bf16), and no
    all-gather or reduce-scatter (``chip_smoke.ring_design``)."""
    counts: dict = {}
    monkeypatch.setattr(ra, "PLAIN_STEPS", _counting_steps(counts))
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=dtype, use_ring_attention=True)
    params = tl.init_params(cfg, generator=torch.Generator().manual_seed(2), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 6 * sp)).astype(
        np.int32))
    job = chip_smoke.mesh_job("llama", 1, 1, tp=tp, sp=sp, widths="tiny", layers=cfg.n_layers,
                              dtype=str(dtype).split(".")[-1], batch=2, seq=6 * sp, steps=1,
                              device="cpu", ring=True)

    def body(mesh):
        mine = {k: v for k, v in tl.shard_params(params, cfg, mesh.tp_rank, mesh.tp).items()}
        mine = tl.optim.tree_map(lambda t: t.clone().requires_grad_(), mine)
        tl.make_mesh_grad(cfg, mesh)(mine, toks)
        return mesh.sp_rank, dict(mesh.calls), dict(counts[threading.get_ident()])

    for sp_rank, calls, tally in run_mesh(1, tp, sp, body):
        want = chip_smoke.ring_design(job, sp_rank)
        layers = cfg.n_layers
        assert tally == {"fwd": layers * want["fwd"], "merge": layers * want["merge"],
                         "d": layers * want["d"], "bwd": layers * want["given"]}
        assert tally["fwd"] == layers * (sp_rank + 1)
        assert calls["p2p"] == layers * (2 * sp - 1 + (sp - 1 if dtype == torch.bfloat16 else 0))
        assert calls["p2p"] == layers * want["p2p"]
        assert calls["all_gather"] == 0 and calls["reduce_scatter"] == 0


def test_ring_attention_refuses_chunks_of_other_lengths():
    q, k, v, _ = _case(1, 8, 1, 2, 16)
    with pytest.raises(ValueError, match="chunks of one length"):
        ra.ring_attention(q, k[:, :4], v[:, :4], None)


def test_ring_of_one_rank_is_dense_attention():
    """Without a mesh (or with sp 1) the ring is one step: the diagonal
    chunk, the plain version's output and gradients."""
    q, k, v, do = _case(2, 12, 2, 2, 16, seed=6)
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12).contiguous()
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = ra.ring_attention(qr, kr, vr, None)
    got = [out.detach(), *torch.autograd.grad(out, (qr, kr, vr), do)]
    for g, w in zip(got, _whole(q, k, v, do, pos)):
        assert _rel(g, w) <= GRAD_REL


def test_kernel_entries_raise_on_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: no fallback."""
    q, k, v, do = _case(1, 8, 1, 2, 16)
    pos = torch.arange(8, dtype=torch.int32)[None].contiguous()
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_attention_d(q, k, v, pos, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_attention_bwd(q, k, v, pos, q, lse, do, d=lse.clone())
    with pytest.raises(ValueError, match="CUDA"):
        ra.ring_merge(None, None, q, lse)
    with pytest.raises(ValueError, match="ring_merge kernel"):
        ra.ring_merge(torch.zeros(1, 8, 2, 8), lse, q[..., :8].contiguous(), lse)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", da.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_ring_entries_and_merge_match_plain_on_card(rank, hd, dtype):
    """Rank ``rank`` of sp 4 over T 512 built chunk by chunk on the card
    (``chip_smoke.check_ring_whole``: B9's forward, "D only", "D given" and
    the merge on each live chunk) against the plain version on the whole
    row, by 7.1's gates; each entry counted once a live chunk."""
    dev = _need_card()
    sp, t = 4, 512
    tq = t // sp
    q, k, v, do = (x.to(dev) for x in _case(2, t, 2, 2, hd, dtype, seed=rank + hd))
    qr, dor = (x[:, rank * tq:(rank + 1) * tq].contiguous() for x in (q, do))
    before = chip_smoke.read_launches()
    chip_smoke.check_ring_whole(torch, ra.KERNEL_STEPS, qr, k, v, dor, sp=sp, rank=rank,
                                what=f"ring rank {rank} on card")
    torch.cuda.synchronize()
    n = {key: chip_smoke.read_launches()[key] - before[key] for key in before}
    live = rank + 1
    assert n["dense_attention_fwd"] == live and n["ring_merge"] == live
    assert n["dense_attention_bwd_given"] == live and n["dense_attention_bwd"] == 0
    assert n["dense_attention_d"] == (live if dtype == torch.bfloat16 else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_merge_kernel_matches_plain_on_card(dtype):
    """The merge kernel against its plain version on three chunks' pairs,
    ``-inf`` terms included: within 2^-20 of the largest value, and the
    ``-inf`` rows exactly as the plain version makes them."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(1)
    pairs = [(torch.randn((2, 70, 4, 64), generator=g, device=dev).to(dtype),
              torch.randn((2, 4, 70), generator=g, device=dev) * 4) for _ in range(3)]
    pairs[1][1][0, 0, :5] = -float("inf")
    pairs[0][1][0, 0, :3] = -float("inf")
    acc = lse = p_acc = p_lse = None
    for out_c, lse_c in pairs:
        acc, lse = ra.ring_merge(acc, lse, out_c, lse_c)
        p_acc, p_lse = ra.ring_merge_reference(p_acc, p_lse, out_c, lse_c)
    torch.cuda.synchronize()
    fin = torch.isfinite(p_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert _rel(acc.cpu(), p_acc.cpu()) <= chip_smoke.RING_MERGE_REL
    assert _rel(lse[fin].cpu(), p_lse[fin].cpu()) <= chip_smoke.RING_MERGE_REL
