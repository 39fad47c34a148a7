"""Tensor-parallel serving gangs of the port (``cordum_tpu_torch.serving.
shard``, ``parallel/mesh.py``'s ``TPGroup``, the sharded ``ragged_step``)
against the JAX package's ``cordum_tpu.serving.shard``.

* The per-rank record helpers and the entry wire codec equal the
  reference's byte for byte on ``hypothesis``-drawn records and entries.
* ``param_specs`` names the reference's split axes; ``shard_params``
  slices concatenate back to the full weights, and ``init_params(shard=)``
  draws exactly those slices.
* A tp 2 ``ServingGangGroup`` (two threads, two in-process gloo groups,
  real slices and real all-reduces) on the reference's fp32 weights
  (``params_from_jax``) emits the reference gang's tokens and the JAX
  oracle's, greedy and speculative; each rank keeps one step shape; the
  follower samples nothing and holds no lm_head.
* A gang's per-rank export merges to the reference gang's records within
  ``arena_rel`` of each record's largest value, and imports across the two
  packages in both directions, decoding on to the same tokens.
* A session drains from a port gang to a single-rank port engine.
* The rank group: backend choice, a ``TCPStore`` rendezvous, and a peer
  that closes its group ending a collective at once.

Token identity is the oracle for tokens.  The arena tolerance: a tp 2
rank sums half of each row-parallel product, and the all-reduce adds the
two halves, so the ``wo`` and ``w_down`` outputs are fp32 sums over
``h * hd`` and ``d_ff`` terms in another order than one rank's.  Such a sum
differs by at most about ``n 2^-24`` of the sum of its terms' magnitudes;
the next layer's K/V carry that difference through one RMSNorm and one
projection.  So a merged record must lie within ``arena_rel(cfg) = d_ff *
2^-24`` (the longest sum; 7.6e-6 at the tiny config's 128, 8.5e-4 at
Llama-3-8B's 14336) of the record's largest |value|.  The tiny config
reads about 6e-7; a record that lost or swapped a head (differences of the
order of the values themselves) stays far outside.  ``chip_smoke.py``'s
phase 10.2 holds the card's gang to the same rule at 8B widths.
"""
from __future__ import annotations

import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cordum_tpu.models import llama as jl
from cordum_tpu.serving import shard as jshard
from cordum_tpu.serving.backend import LlamaServingBackend as JaxBackend
from cordum_tpu.serving.backend import StepEntry as JaxStepEntry
from cordum_tpu.serving.pager import PageAllocator as JaxPageAllocator
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.ops import paged_attention as pa
from cordum_tpu_torch.parallel import mesh as tmesh
from cordum_tpu_torch.serving import shard as tshard
from cordum_tpu_torch.serving.backend import LlamaServingBackend, StepEntry
from cordum_tpu_torch.serving.engine import GenRequest, ServingEngine, SessionMigrated
from cordum_tpu_torch.serving.pager import PageAllocator

from .test_torch_serving import _jax_greedy

N_NEW = 7
PROMPT = [7, 3, 11, 19, 2, 5, 23, 1, 13]
KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128, max_seq_len=128)


@pytest.fixture(scope="module")
def env():
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **KW)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **KW)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams, _jax_greedy(jcfg, jparams)


def _port_gang(tcfg, tparams, tp=2, **kw):
    return tshard.ServingGangGroup(tcfg, tp=tp, num_pages=32, page_size=8,
                                   params_provider=lambda: tparams, device="cpu", **kw)


def _port_single(tcfg, tparams):
    return LlamaServingBackend(tcfg, num_pages=32, page_size=8,
                               params_provider=lambda: tparams, device="cpu")


def drive_backend(be, prompt, n_new, alloc_cls=PageAllocator, reserve=5):
    """prefill + n_new-1 decode steps; returns (tokens, pages, next
    position) as ``tests/test_sharded_serving.py`` drives a backend."""
    alloc = alloc_cls(be.num_pages, be.page_size)
    pages = alloc.alloc("s0", alloc.pages_for(len(prompt) + n_new + reserve))
    first = be.prefill(prompt, pages)
    out, pos, last = [first], len(prompt), first
    for _ in range(n_new - 1):
        (nxt,) = be.decode([(last, pos, pages)])
        pos, last = pos + 1, int(nxt)
        out.append(last)
    return out, pages, pos


def continue_decode(be, last, pos, pages, n):
    out = []
    for _ in range(n):
        (nxt,) = be.decode([(last, pos, pages)])
        last, pos = int(nxt), pos + 1
        out.append(last)
    return out


def arena_rel(cfg):
    return cfg.d_ff * 2.0**-24


def assert_records_close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["i"], g["used"], g["shape"]) == (w["i"], w["used"], w["shape"])
        for fld in ("k", "v"):
            a = np.frombuffer(g[fld], np.float32)
            b = np.frombuffer(w[fld], np.float32)
            assert np.abs(a - b).max() <= rel * np.abs(b).max(), fld


# ---------------------------------------------------------------------------
# the per-rank record format and the wire codec, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv_heads, tp", [(8, 4), (2, 1), (8, 2), (2, 2), (6, 4), (8, 3)])
def test_heads_for_rank_matches_reference(n_kv_heads, tp):
    for rank in range(-1, tp + 1):
        try:
            want = jshard.heads_for_rank(n_kv_heads, tp, rank)
        except ValueError:
            with pytest.raises(ValueError):
                tshard.heads_for_rank(n_kv_heads, tp, rank)
        else:
            assert tshard.heads_for_rank(n_kv_heads, tp, rank) == want


@st.composite
def page_records(draw):
    layers = draw(st.integers(1, 3))
    used = draw(st.integers(1, 16))
    kvh = draw(st.sampled_from([2, 4, 8]))
    hd = draw(st.sampled_from([4, 16]))
    tp = draw(st.sampled_from([t for t in (1, 2, 4, 8) if kvh % t == 0]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((layers, used, kvh, hd)).astype(np.float32) for _ in range(2))
    rec = {"i": draw(st.integers(0, 63)), "used": used, "k": k.tobytes(), "v": v.tobytes(),
           "shape": [layers, used, kvh, hd]}
    order = draw(st.permutations(list(range(tp))))
    return rec, tp, order


@settings(max_examples=40, deadline=None)
@given(page_records())
def test_slice_and_merge_match_reference_byte_for_byte(case):
    rec, tp, order = case
    kvh = rec["shape"][2]
    ours = [tshard.slice_rank_record(rec, r, tp, *tshard.heads_for_rank(kvh, tp, r))
            for r in range(tp)]
    theirs = [jshard.slice_rank_record(rec, r, tp, *jshard.heads_for_rank(kvh, tp, r))
              for r in range(tp)]
    assert ours == theirs
    plain = {**rec, "i": rec["i"] + 64}
    mixed = [plain] + [ours[r] for r in order]
    merged = tshard.merge_rank_records(mixed)
    assert merged == jshard.merge_rank_records(mixed)
    got = next(m for m in merged if m["i"] == rec["i"])
    assert got["k"] == rec["k"] and got["v"] == rec["v"] and got["shape"] == rec["shape"]
    if tp > 1:
        for bad in (ours[:-1], ours + ours[:1]):
            with pytest.raises(ValueError):
                jshard.merge_rank_records(bad)
            with pytest.raises(ValueError):
                tshard.merge_rank_records(bad)


entries = st.builds(
    dict,
    tokens=st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=8),
    start=st.integers(0, 4096), pages=st.lists(st.integers(0, 1024), max_size=6),
    sample=st.booleans(), phase=st.sampled_from(["prefill", "decode"]),
    key=st.text(max_size=8), draft=st.integers(0, 8),
)


@settings(max_examples=60, deadline=None)
@given(entries)
def test_entry_wire_codec_matches_reference(fields):
    ours = tshard.entry_to_wire(StepEntry(**fields))
    theirs = jshard.entry_to_wire(JaxStepEntry(**fields))
    assert ours == theirs
    back = tshard.entry_from_wire(theirs)
    assert back == StepEntry(**fields)
    assert vars(jshard.entry_from_wire(ours)) == vars(back)


# ---------------------------------------------------------------------------
# the weights' layout
# ---------------------------------------------------------------------------


def test_param_specs_match_the_reference_layout(env):
    jcfg, tcfg, *_ = env

    def axis(spec):
        hit = [i for i, name in enumerate(tuple(spec)) if name == "tp"]
        return hit[0] if hit else None

    ref = jl.param_specs(jcfg)
    ours = tl.param_specs(tcfg)
    assert ours["embed"] == axis(ref["embed"]) and ours["lm_head"] == axis(ref["lm_head"])
    assert ours["final_norm"] is axis(ref["final_norm"]) is None
    for a, b in zip(ours["layers"], ref["layers"]):
        assert a == {k: axis(s) for k, s in b.items()}


@pytest.mark.parametrize("tp", [1, 2])
def test_shard_params_concatenate_back(env, tp):
    _, tcfg, _, tparams, _ = env
    shards = [tl.shard_params(tparams, tcfg, r, tp) for r in range(tp)]
    specs = tl.param_specs(tcfg)["layers"][0]
    for li, layer in enumerate(tparams["layers"]):
        for name, full in layer.items():
            parts = [s["layers"][li][name] for s in shards]
            if specs[name] is None:
                assert all(p is full for p in parts)
            else:
                assert all(p.shape[specs[name]] == full.shape[specs[name]] // tp for p in parts)
                assert torch.equal(torch.cat(parts, specs[name]), full)
    for name in ("embed", "lm_head", "final_norm"):  # whole on every rank
        assert all(s[name] is tparams[name] for s in shards)
    # a rank's serving state: the same slices, from the given weights or
    # drawn from a generator, and empty arenas on its KV heads
    for r in range(tp):
        given, k, v = tl.shard_serving_state(tcfg, r, tp, num_pages=6, page_size=4,
                                             params=tparams, lm_head=r == 0, device="cpu")
        drawn, *_ = tl.shard_serving_state(
            tcfg, r, tp, num_pages=6, page_size=4, lm_head=r == 0, device="cpu",
            generator=torch.Generator().manual_seed(0))
        want = tl.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
                              shard=(r, tp), lm_head=r == 0)
        for got, ref in ((given, shards[r]), (drawn, want)):
            assert all(torch.equal(a[n], b[n]) for a, b in zip(got["layers"], ref["layers"])
                       for n in a)
        assert (given["lm_head"] is None) == (drawn["lm_head"] is None) == (r > 0)
        for arena in (k, v):
            assert arena.shape == (2, 6, 4, tcfg.n_kv_heads // tp, tcfg.head_dim)
            assert not arena.any()
    with pytest.raises(ValueError):
        tl.shard_params(tparams, tcfg, 0, 4)  # 2 KV heads over 4 ranks


def test_init_params_shard_draws_the_slices_of_the_full_draw(env):
    _, tcfg, *_ = env
    full = tl.init_params(tcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for rank in range(2):
        part = tl.init_params(tcfg, generator=torch.Generator().manual_seed(3), device="cpu",
                              shard=(rank, 2), lm_head=rank == 0)
        want = tl.shard_params(full, tcfg, rank, 2)
        for a, b in zip(part["layers"], want["layers"]):
            assert all(torch.equal(a[k], b[k]) for k in b)
        assert torch.equal(part["embed"], full["embed"])
        assert (part["lm_head"] is None) == (rank == 1)


# ---------------------------------------------------------------------------
# the gang against the reference gang and the oracle
# ---------------------------------------------------------------------------


def test_tp2_gang_matches_reference_gang_and_oracle(env):
    """Tokens equal the reference gang's and the oracle's; one step shape a
    rank; the gang's merged export equals the reference gang's within
    ``arena_rel``; the follower holds its slices only and no lm_head."""
    jcfg, tcfg, jparams, tparams, oracle = env
    jgang = jshard.ServingGangGroup(jcfg, tp=2, num_pages=32, page_size=8,
                                    params_provider=lambda: jparams)
    gang = _port_gang(tcfg, tparams)
    try:
        jt, jpages, jend = drive_backend(jgang, PROMPT, N_NEW, JaxPageAllocator)
        tt, tpages, tend = drive_backend(gang, PROMPT, N_NEW)
        assert tt == jt == oracle(PROMPT, N_NEW)
        assert gang.compiled_per_rank() == [1, 1]
        assert (jpages, jend) == (tpages, tend)
        exp = gang.export_kv(tpages, 0, tend)
        assert sorted(r["heads"] for r in exp) == [[0, 1]] * 2 + [[1, 2]] * 2
        assert_records_close(tshard.merge_rank_records(exp),
                             jshard.merge_rank_records(jgang.export_kv(jpages, 0, jend)),
                             arena_rel(tcfg))
        lead, follow = gang.ranks
        assert lead.sample_output and not follow.sample_output
        assert follow._params["lm_head"] is None and lead._params["lm_head"] is not None
        assert follow._k_pages.shape[3] == tcfg.n_kv_heads // 2
        assert follow._params["layers"][0]["wq"].shape[1] == tcfg.d_model // 2
    finally:
        gang.close()


def test_follower_returns_the_zero_buffer(env):
    """Both ranks step on the same entry; the leader's result is the
    oracle's token, the follower's the zero buffer (no lm_head)."""
    _, tcfg, _, tparams, oracle = env
    gang = _port_gang(tcfg, tparams)
    try:
        entry = [StepEntry(tokens=[9, 2, 7, 4], start=0, pages=[1, 2], sample=True,
                           phase="prefill")]
        follower = gang._pool.submit(gang.ranks[1].step, entry)
        (tok,) = gang.ranks[0].step(entry)
        (zero,) = follower.result(timeout=30)
        assert tok == oracle([9, 2, 7, 4], 1)[0] and zero == 0
    finally:
        gang.close()


def test_gang_export_imports_across_packages(env):
    """A port gang's per-rank export imports into the reference's single
    backend and a reference gang's into a port gang; every importer then
    decodes the tokens the exporter decodes."""
    jcfg, tcfg, jparams, tparams, _ = env
    gang = _port_gang(tcfg, tparams)
    gang_b = _port_gang(tcfg, tparams)
    jgang = jshard.ServingGangGroup(jcfg, tp=2, num_pages=32, page_size=8,
                                    params_provider=lambda: jparams)
    try:
        toks, pages, end = drive_backend(gang, PROMPT, N_NEW)
        exp = gang.export_kv(pages, 0, end)
        ref = JaxBackend(jcfg, num_pages=32, page_size=8, params_provider=lambda: jparams)
        ref_pages = JaxPageAllocator(32, 8).alloc("s0", len(pages))
        ref.import_kv(ref_pages, exp)
        assert continue_decode(ref, toks[-1], end, ref_pages, 5) == \
            continue_decode(gang, toks[-1], end, pages, 5)

        jtoks, jpages, jend = drive_backend(jgang, PROMPT, N_NEW, JaxPageAllocator)
        jexp = jgang.export_kv(jpages, 0, jend)
        mine = PageAllocator(32, 8).alloc("s0", len(jpages))
        gang_b.import_kv(mine, jexp)
        single = _port_single(tcfg, tparams)
        single.import_kv(mine, jexp)
        want = continue_decode(jgang, jtoks[-1], jend, jpages, 5)
        assert continue_decode(gang_b, jtoks[-1], jend, mine, 5) == want
        assert continue_decode(single, jtoks[-1], jend, mine, 5) == want
        # the port's own round trip: a gang export re-exported by a single
        # rank is the merged records, byte for byte
        fresh = _port_single(tcfg, tparams)
        fresh.import_kv(mine, exp)
        assert fresh.export_kv(mine, 0, end) == tshard.merge_rank_records(exp)
    finally:
        gang.close()
        gang_b.close()


async def _serve(eng, prompts, n_new):
    return await asyncio.gather(*[
        asyncio.wait_for(eng.submit(GenRequest(prompt=p, max_new_tokens=n_new, stream=False),
                                    job_id=f"g{i}"), timeout=120)
        for i, p in enumerate(prompts)])


@pytest.mark.parametrize("speculative", [False, True])
async def test_tp2_engine_matches_oracle(env, speculative):
    _, tcfg, _, tparams, oracle = env
    gang = _port_gang(tcfg, tparams)
    eng = ServingEngine(gang, run_blocking=asyncio.to_thread, max_new_tokens_cap=32,
                        prefix_cache=False, speculative=speculative, draft_k=4)
    prompts = [PROMPT, [42, 9, 77, 5, 31], [5, 9, 5, 9, 5, 9, 5, 9, 5, 9]]
    try:
        outs = await _serve(eng, prompts, 10)
        for p, out in zip(prompts, outs):
            assert out["tokens"] == oracle(p, 10), p
        assert gang.compiled_per_rank() == [1, 1]
        assert (eng.stats.drafted_tokens > 0) is speculative
    finally:
        await eng.stop()
        gang.close()


async def test_drain_from_a_gang_member_to_a_single_rank_engine(env):
    """A session decoding on a port gang live-migrates mid-decode to a
    single-rank port engine: per-rank records on the wire, merged by the
    receiver; the finished stream equals the oracle's."""
    from cordum_tpu_torch.serving.migration import MigrationServer, migrate_session

    from .test_serving_failover import install_into, wait_until

    _, tcfg, _, tparams, oracle = env
    gang = _port_gang(tcfg, tparams)
    a = ServingEngine(gang, run_blocking=asyncio.to_thread, max_new_tokens_cap=64,
                      prefix_cache=False)
    b = ServingEngine(_port_single(tcfg, tparams), run_blocking=asyncio.to_thread,
                      max_new_tokens_cap=64)
    results: dict = {}
    srv = MigrationServer(install_into(b, results))
    await srv.start()
    try:
        src = asyncio.ensure_future(a.submit(
            GenRequest(prompt=PROMPT, max_new_tokens=20, stream=False), job_id="gm1"))
        await wait_until(lambda: (a.export_state("gm1") or {}).get("pos", 0) >= 12,
                         timeout_s=60, msg="gang session mid-decode")
        assert await migrate_session(a, "gm1", srv.host, srv.port) is True
        with pytest.raises(SessionMigrated):
            await asyncio.wait_for(src, timeout=30)
        await wait_until(lambda: "gm1" in results, timeout_s=60, msg="peer finished")
        assert results["gm1"] == oracle(PROMPT, 20)
        assert a.allocator.used_pages == 0
    finally:
        await a.stop()
        await b.stop()
        await srv.stop()
        gang.close()


def test_sharded_step_without_group_is_refused(env):
    _, tcfg, _, tparams, _ = env
    with pytest.raises(ValueError, match="rank group"):
        tshard.ShardedServingBackend(tcfg, rank=1, tp=2, device="cpu",
                                     params_provider=lambda: tparams)
    one = tshard.ShardedServingBackend(tcfg, rank=0, tp=1, device="cpu", num_pages=32,
                                       page_size=8, params_provider=lambda: tparams)
    assert drive_backend(one, PROMPT, 3)[0] == drive_backend(
        _port_single(tcfg, tparams), PROMPT, 3)[0]


# ---------------------------------------------------------------------------
# B1 at a rank's heads
# ---------------------------------------------------------------------------


def _rank_case(h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    num_pages, ps, p_cols = 40, 16, 8
    tables = np.zeros((4, p_cols), np.int32)
    free = rng.permutation(np.arange(1, num_pages)).tolist()
    rows = [(3, 1), (40, 1), (100, 6)]
    t = 10
    pos = np.zeros(t, np.int32)
    seq = np.full(t, 3, np.int32)
    ti = 0
    for s, (start, n) in enumerate(rows):
        need = (start + n - 1) // ps + 1
        tables[s, :need] = [free.pop() for _ in range(need)]
        pos[ti:ti + n] = np.arange(start, start + n)
        seq[ti:ti + n] = s
        ti += n
    q = rng.standard_normal((t, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, tables, seq, pos


@pytest.mark.parametrize("h, kvh, hd", [(2, 1, 16), (16, 4, 128)], ids=["tiny-tp2", "8b-tp2"])
def test_rank_heads_attend_as_the_full_heads_slice(h, kvh, hd):
    """The paged attention of a rank's heads is the rank's slice of the
    full heads' attention (the plain version, and the plan built for the
    rank's head counts)."""
    q, k, v, tables, seq, pos = (torch.from_numpy(a) for a in _rank_case(2 * h, 2 * kvh, hd))
    full = pa.paged_attention_reference(q, k, v, tables, seq, pos)
    for rank in range(2):
        qs, ks, vs = q[:, rank * h:(rank + 1) * h], k[:, :, rank * kvh:(rank + 1) * kvh], \
            v[:, :, rank * kvh:(rank + 1) * kvh]
        part = pa.paged_attention_reference(qs.contiguous(), ks.contiguous(), vs.contiguous(),
                                            tables, seq, pos)
        torch.testing.assert_close(part, full[:, rank * h:(rank + 1) * h], rtol=0, atol=1e-6)
        plan = pa.build_plan(seq, pos, page_size=16, pages_per_seq=tables.shape[1],
                             n_heads=h, n_kv_heads=kvh, dtype=torch.float32)
        planned = pa.paged_attention_planned(qs.contiguous(), ks.contiguous(), vs.contiguous(),
                                             tables, pos, plan)
        torch.testing.assert_close(planned, part, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the rank group
# ---------------------------------------------------------------------------


def test_backend_choice():
    assert tmesh.choose_backend(["cpu", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["cuda:a", "cuda:a"]) == "gloo"  # two ranks, one card
    assert tmesh.choose_backend(["cuda:a", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["cuda:a", "cuda:b"]) == "nccl"


def _join_all(addr_store, size, timeout_s=20.0):
    store, addr = addr_store
    groups: list = [None] * size
    errors: list = []

    def join(rank):
        try:
            st = store if rank == 0 else tmesh.connect_store(addr, size, timeout_s=timeout_s)
            groups[rank] = tmesh.TPGroup.join(st, rank, size, torch.device("cpu"),
                                              timeout_s=timeout_s)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=join, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 10)
    assert not errors and all(g is not None for g in groups), errors
    return groups


def test_tcpstore_rendezvous_all_reduce_and_teardown():
    """Three ranks meet at rank 0's TCPStore on an ephemeral port, choose
    gloo, sum in place; peers that close their groups (as every member does
    on an abort) end a rank's pending collective at once, not at the
    timeout."""
    groups = _join_all(tmesh.open_store(3, timeout_s=20.0), 3)
    try:
        assert {g.backend for g in groups} == {"gloo"}
        outs: list = [None] * 3

        def reduce(r):
            t = torch.full((5,), float(r + 1), dtype=torch.bfloat16)
            outs[r] = groups[r].all_reduce(t)

        threads = [threading.Thread(target=reduce, args=(r,)) for r in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert all(torch.equal(o, torch.full((5,), 6.0, dtype=torch.bfloat16)) for o in outs)

        failed: list = []

        def blocked():
            t0 = time.monotonic()
            try:
                groups[0].all_reduce(torch.ones(3))
            except RuntimeError:
                failed.append(time.monotonic() - t0)

        th = threading.Thread(target=blocked)
        th.start()
        time.sleep(0.3)
        groups[1].close()
        groups[2].close()
        th.join(15)
        assert failed and failed[0] < 10.0, failed  # the group's timeout is 20 s
        with pytest.raises(RuntimeError, match="closed"):
            groups[1].all_reduce(torch.ones(3))
    finally:
        for g in groups:
            g.close()


def test_group_timeout_bounds_a_silent_peer():
    groups = tmesh.in_process_groups(2, torch.device("cpu"), timeout_s=1.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            groups[0].all_reduce(torch.ones(2))  # rank 1 never joins the collective
        assert time.monotonic() - t0 < 10.0
    finally:
        for g in groups:
            g.close()
