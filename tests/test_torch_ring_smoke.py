"""``chip_smoke.py``'s phase 13 rehearsed on the CPU, and the planted faults
its gates must refuse.

13.2's leg runs with the ranks as threads over in-process gloo groups
(``LlamaConfig.tiny()`` widths, 2 layers, fp32, B 4, T 16, 2 steps, the
ring: ``use_ring_attention``): the one-process oracle, every rank's
``chip_smoke.train_rank``, then ``check_mesh_ranks`` (each rank's loss
within 1e-6 relative of the one-process step's, its first gradients within
1e-4 of their max, its params within 2 lr a step), whose launch gate for a
ring job is ``ring_launches`` (the CPU counts no kernel launch, so each
rank's launches are set to the design's; its hops are the mesh's own
count).  Refused there: a ring that skips a hop, a ring turned the other
way (sp 4; at sp 2 the next rank is the previous one), a later rank's
chunk launched with its negative positions (B9 makes such a row uniform:
a spurious term in the merge).  13.1's whole-ring gate
(``check_ring_whole``, bf16 by the row gate against the exact result)
refuses a bf16 ``D`` taken as ``rowsum(dO * O)`` from the bf16 output.
"""
from __future__ import annotations

import dataclasses
import threading

import pytest
import torch

import chip_smoke
from cordum_tpu_torch.ops import ring_attention as ra
from cordum_tpu_torch.parallel import mesh as tm

from .test_torch_ring_steps import _case, run_mesh

CPU = torch.device("cpu")


def _rehearse(tmp_path, monkeypatch, *, tp=1, sp=4, steps=2):
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    job = chip_smoke.mesh_job("llama", 1, 1, tp=tp, sp=sp, widths="tiny", layers=2,
                              dtype="float32", batch=4, seq=16, steps=steps, device="cpu",
                              ring=True)
    chip_smoke.mesh_oracle(torch, CPU, "cpu", job, str(tmp_path))
    docs = run_mesh(1, tp, sp, lambda mesh: chip_smoke.train_rank(job, mesh.rank, mesh=mesh))
    n = job["layers"] * job["steps"]
    for d in docs:
        want = chip_smoke.ring_design(job, d["coords"]["sp"])
        d["launches"] = [n * want["fwd"], 0]
        d["ring_launches"] = [n * want["d"], n * want["given"], n * want["merge"]]
    return job, docs, chip_smoke.check_mesh_ranks("cpu", job, docs, collective="gloo",
                                                  falling=True)


@pytest.mark.parametrize("tp, sp", [(1, 4), (2, 2)])
def test_chip_smoke_ring_gates_pass_on_the_cpu(tmp_path, monkeypatch, tp, sp):
    """The ring leg passes 12.7's gates and the launch and hop gate: sums
    of forward launches ``layers × steps × sum_r (r + 1)`` over the ranks,
    no backward without D."""
    job, docs, launches = _rehearse(tmp_path, monkeypatch, tp=tp, sp=sp)
    per_line = sum(r + 1 for r in range(sp))
    assert launches == [2 * 2 * per_line * tp, 0]
    assert chip_smoke.ring_launches(job, docs)[2:] == [2 * 2 * sp * tp,
                                                      2 * 2 * per_line * tp,
                                                      2 * 2 * per_line * tp]
    numbers = chip_smoke.ring_versus_gather("cpu", (job, docs), (job, docs), "ring-test")
    assert numbers["ring"]["p2p"] >= 0 and numbers["ring"]["all_gather"] == 0


def test_chip_smoke_ring_launch_gate_refuses_a_gathered_chunk_or_a_missing_launch(
        tmp_path, monkeypatch):
    """``ring_launches`` refuses a rank whose counts differ from the
    design's: a forward launch more (a later rank's chunk launched), or an
    all-gather for attention."""
    job, docs, _ = _rehearse(tmp_path, monkeypatch, tp=1, sp=2)
    docs[1]["launches"][0] += 1
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.ring_launches(job, docs)
    docs[1]["launches"][0] -= 1
    docs[0]["calls"]["all_gather"] = 1
    with pytest.raises(AssertionError, match="all-gathers 1"):
        chip_smoke.ring_launches(job, docs)


def test_chip_smoke_gate_refuses_a_ring_that_skips_a_hop(tmp_path, monkeypatch):
    """Each rank's first hop (layer 0's forward) hands its own chunk back:
    a rank takes its own keys, future ones included, for the previous
    rank's."""
    real, skipped = tm.TrainMesh.shift, set()

    def skipping(self, tensors, over=tm.AXIS_SP):
        if threading.get_ident() not in skipped:
            skipped.add(threading.get_ident())
            return list(tensors)
        return real(self, tensors, over)

    monkeypatch.setattr(tm.TrainMesh, "shift", skipping)
    with pytest.raises(AssertionError, match="against the one-process step"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_a_ring_turned_the_other_way(tmp_path, monkeypatch):
    """At sp 4 every hop sends to the previous rank and receives from the
    next (``sp - 1`` hops the right way): the ranks mask by the wrong
    owner."""
    real = tm.TrainMesh.shift

    def backwards(self, tensors, over=tm.AXIS_SP):
        for _ in range(self.sp - 1):
            tensors = real(self, tensors, over)
        return tensors

    monkeypatch.setattr(tm.TrainMesh, "shift", backwards)
    with pytest.raises(AssertionError, match="against the one-process step"):
        _rehearse(tmp_path, monkeypatch)


def test_chip_smoke_gate_refuses_a_later_chunk_launched(tmp_path, monkeypatch):
    """A later rank's chunk launched with its negative positions: B9 (and
    its plain version) makes those rows uniform over the chunk's keys with
    ``lse = log(Tk)``, a term the merge weighs in."""
    real = ra.chunk_positions

    def launched(rank, owner, b, tq, tk, causal, device):
        if causal and owner > rank:
            first = rank * tq - owner * tk
            return torch.arange(first, first + tq, dtype=torch.int32,
                                device=device).expand(b, tq).contiguous()
        return real(rank, owner, b, tq, tk, causal, device)

    monkeypatch.setattr(ra, "chunk_positions", launched)
    with pytest.raises(AssertionError, match="against the one-process step"):
        _rehearse(tmp_path, monkeypatch)


@pytest.mark.parametrize("rank", [0, 1])
def test_chip_smoke_whole_ring_gate_refuses_d_from_the_bf16_output(rank):
    """13.1's whole-ring gate, bf16, sp 2 over T 1024 (hd 128, two query
    heads a KV head): the plain ring passes; with ``D = rowsum(dO * O)``
    from the bf16 output (each chunk's, summed over the ring, as a ring
    that took B9's old D would) the row gate refuses dq."""
    q, k, v, do = _case(1, 1024, 1, 2, 128, torch.bfloat16, seed=11)
    qr, dor = (x[:, rank * 512:(rank + 1) * 512].contiguous() for x in (q, do))
    chip_smoke.check_ring_whole(torch, ra.PLAIN_STEPS, qr, k, v, dor, sp=2, rank=rank,
                                what="plain ring")

    def d_from_output(q, k, v, pos, out, lse, dout):
        return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()

    faulty = dataclasses.replace(ra.PLAIN_STEPS, d=d_from_output)
    with pytest.raises(AssertionError, match="bf16 row gate"):
        chip_smoke.check_ring_whole(torch, faulty, qr, k, v, dor, sp=2, rank=rank,
                                    what="D from the output")
