"""``chip_smoke.py``'s phase 14 rehearsed on the CPU, and the planted faults
its gates must refuse.

14.2's legs run with the ranks as threads over in-process gloo groups
(``MoEConfig.tiny()`` experts on ``LlamaConfig.tiny()``, 2 layers, fp32, B
4, T 16, 2 steps, capacity factor ``chip_smoke.MOE_MESH_CF`` and router
skew ``chip_smoke.MOE_MESH_SKEW``: the oracle checks that layer 0 drops
slots): the one-process oracle, every rank's ``chip_smoke.train_rank``,
then ``check_mesh_ranks`` (each rank's loss within 1e-6 relative of the
one-process step's, its first gradients within 1e-4 of their max, its
params within 2 lr a step; the CPU counts no kernel launch, so each rank's
launches are set to what its layers and steps give).  Refused there: a
dp-local capacity, a route with no prefix (every dp rank's pairs at the
head of the queue), an aux loss from the rank's own counts, gradients
summed over ep, and the combine's output not summed over ep.

14.1's gate (``check_room_route``) runs at a small N and D with the
kernel wrappers replaced by stand-ins that compute what each kernel does
from the plain versions (the route calls its room function, as the
kernels' does between its two launches); a route that ignores its room is
refused.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from cordum_tpu_torch.models import llama as tl
from cordum_tpu_torch.models import moe as tm
from cordum_tpu_torch.ops import moe_dispatch as md
from cordum_tpu_torch.parallel import collectives as coll

from .test_torch_moe_mesh import run_mesh

CPU = torch.device("cpu")
LAYERS, STEPS = 2, 2


def _rehearse(tmp_path, monkeypatch, *, dp=2, tp=1, ep=2):
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    job = chip_smoke.mesh_job("moe", dp, 1, tp=tp, ep=ep, widths="tiny", layers=LAYERS,
                              dtype="float32", batch=4, seq=16, steps=STEPS, device="cpu",
                              cf=chip_smoke.MOE_MESH_CF, skew=chip_smoke.MOE_MESH_SKEW)
    chip_smoke.mesh_oracle(torch, CPU, "cpu", job, str(tmp_path))
    docs = run_mesh(dp, tp, ep, lambda mesh: chip_smoke.train_rank(job, mesh.rank, mesh=mesh))
    n = LAYERS * STEPS
    for d in docs:
        d["launches"] = [n, n]
        d["chunk_launches"] = [0, 0]
        d["moe_launches"] = {**dict.fromkeys(chip_smoke.MOE_KERNELS, n),
                             chip_smoke.ROOM_ROW: n if dp > 1 else 0}
    return job, docs, chip_smoke.check_mesh_ranks("cpu", job, docs, collective="gloo",
                                                  falling=True)


@pytest.mark.parametrize("dp, tp, ep", [(2, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_chip_smoke_moe_gates_pass_on_the_cpu(tmp_path, monkeypatch, dp, tp, ep):
    """14.2's tiny legs pass phase 12's gates and the launch gate; the B7
    sums over the ranks are layers × steps a rank, the route with a room's
    only where dp is above 1."""
    job, docs, launches = _rehearse(tmp_path, monkeypatch, dp=dp, tp=tp, ep=ep)
    world = dp * tp * ep
    assert launches == [LAYERS * STEPS * world] * 2
    sums = chip_smoke.moe_mesh_launches(docs)
    assert sums["moe_route"] == LAYERS * STEPS * world
    assert sums[chip_smoke.ROOM_ROW] == (LAYERS * STEPS * world if dp > 1 else 0)
    assert {d["coords"]["ep"] for d in docs} == set(range(ep))


def test_chip_smoke_moe_launch_gate_refuses_a_missing_room(tmp_path, monkeypatch):
    """A dp 2 rank whose routes took no room (its route launches counted,
    its room launches not) fails the launch gate."""
    job, docs, _ = _rehearse(tmp_path, monkeypatch)
    docs[1]["moe_launches"][chip_smoke.ROOM_ROW] = 0
    with pytest.raises(AssertionError, match="B7 launches"):
        chip_smoke.mesh_launches(job, docs)


def _faulty_route(kind):
    """``moe._mesh_route`` with a planted fault."""
    def route(route_fn, probs, cfg, mesh):
        n = probs.shape[0]
        if kind == "local capacity":  # each dp rank's rows routed as a whole batch
            r = route_fn(probs, cfg.top_k, tm.capacity(cfg, n))
            return r, coll.exchange_counts(r.counts, mesh)[1]
        if kind == "no prefix":  # the global capacity, every rank at the head of the queue
            r = route_fn(probs, cfg.top_k, tm.capacity(cfg, n * mesh.dp))
            return r, coll.exchange_counts(r.counts, mesh)[1]
        r, _ = real(route_fn, probs, cfg, mesh)  # the aux loss from the rank's own counts
        return r, r.counts

    real = tm._mesh_route
    return route


@pytest.mark.parametrize("kind", ["local capacity", "no prefix", "local counts"])
def test_chip_smoke_gate_refuses_a_routing_fault(tmp_path, monkeypatch, kind):
    monkeypatch.setattr(tm, "_mesh_route", _faulty_route(kind))
    with pytest.raises(AssertionError, match="against the one-process step"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_gradients_summed_over_ep(tmp_path, monkeypatch):
    """Every gradient also summed over ep: an expert slice's added to
    another rank's experts, the router's and attention's doubled."""
    real = tl._mesh_sum

    def over_ep(value, grads, mesh):
        value, grads = real(value, grads, mesh)
        for g in grads:
            mesh.all_reduce(g, "ep")
        return value, grads

    monkeypatch.setattr(tl, "_mesh_sum", over_ep)
    with pytest.raises(AssertionError, match=r"worst gradient \[([1-9]|0\.[1-9])"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_an_output_not_summed_over_ep(tmp_path, monkeypatch):
    """The combine's output summed over tp alone: each ep rank keeps its
    own experts' share of every token: the ranks of an ep line disagree
    (the first gate), and none matches one process."""
    monkeypatch.setattr(tm, "reduce_from_expert_plane", coll.reduce_from_tp)
    with pytest.raises(AssertionError, match="the ranks' losses"):
        _rehearse(tmp_path, monkeypatch, dp=1, tp=2, ep=2)


# ---------------------------------------------------------------------------
# 14.1 on the CPU
# ---------------------------------------------------------------------------


def _stand_ins(monkeypatch, *, ignore_room=False):
    """The B7 wrappers as the plain versions of what each kernel computes
    (CPU tensors); ``ignore_room``: a route that drops its room."""
    def route(probs, k, cap, room=None):
        return md.moe_route_reference(probs, k, cap, None if ignore_room else room)

    def dispatch_rows(src, r, w=None):
        t = md.dispatch_tensor(r)
        if w is not None:
            t = t * w[..., None, None]
        return torch.einsum("nkec,nd->ecd", t, src.float()).to(src.dtype)

    monkeypatch.setattr(md, "moe_route_kernel", route)
    monkeypatch.setattr(md, "moe_slot_gather", lambda src, r: dispatch_rows(src, r))
    monkeypatch.setattr(md, "moe_slot_gather_scaled", dispatch_rows)
    monkeypatch.setattr(md, "moe_token_gather",
                        lambda src, r, w: md.moe_combine_reference(src, w, r))
    monkeypatch.setattr(md, "moe_token_sum", lambda src, r: md.moe_combine_reference(
        src, r.keep.float(), r))
    monkeypatch.setattr(md, "moe_token_dot", lambda dy, src, r: torch.einsum(
        "nkec,ecd,nd->nk", md.dispatch_tensor(r), src.float(), dy.float()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)


@pytest.mark.parametrize("tag, kind0, kind1", chip_smoke.MOE_ROOM_CASES)
def test_chip_smoke_room_gate_passes_on_the_cpu(monkeypatch, tag, kind0, kind1):
    _stand_ins(monkeypatch)
    _, k, cap, room, errs = chip_smoke.check_room_route(torch, CPU, torch.float32, tag, kind0,
                                                        kind1, n=256, d=16)
    assert cap == int(1.25 * 2 * 256 * k / 8) and set(errs) == set(chip_smoke.MOE_KERNELS)
    if kind0 == "drop":
        assert room.min().item() == 0


def test_chip_smoke_room_gate_refuses_a_route_that_ignores_its_room(monkeypatch):
    _stand_ins(monkeypatch, ignore_room=True)
    with pytest.raises(AssertionError, match="differ from the plain version's"):
        chip_smoke.check_room_route(torch, CPU, torch.float32, "rank 1's room", "random",
                                    "random", n=256, d=16)
