"""``chip_smoke.py``'s phase 15 (the driver's entry points at world 1) and
its ``--cards`` dryrun leg (the dry run over rank processes and a worker
that owns several cards) rehearsed on the CPU, each with a planted fault
its gates refuse.

The CPU runs the kernels' plain versions and counts no launch, so the
launch gates expect none (``graft_launches`` and ``graft_embed_launches``
patched); the leg runs at n 2 on gloo CPU rank processes (dense tp 2, MoE
tp 2, pipeline pp 2), the embed fault at n 4 (it stops before any rank
process starts).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import chip_smoke
from cordum_tpu_torch.models import embedder as te
from cordum_tpu_torch.models import llama as tl

CPU = torch.device("cpu")


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


def _cpu_launch_gates(monkeypatch):
    """The CPU runs the kernels' plain versions and counts no launch: the
    launch gates expect none."""
    monkeypatch.setattr(chip_smoke, "graft_launches",
                        lambda *a, **k: dict.fromkeys(chip_smoke.GRAFT_LAUNCH_ROWS, 0))
    monkeypatch.setattr(chip_smoke, "graft_embed_launches", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)


def test_chip_smoke_phase_15_passes_on_the_cpu(tmp_path, monkeypatch):
    _cpu_launch_gates(monkeypatch)
    out = chip_smoke.phase_graft(torch, CPU, "cpu", str(tmp_path))
    assert set(out) == set(chip_smoke.GRAFT_LAUNCH_ROWS)


def test_chip_smoke_phase_15_refuses_a_key_past_the_mask(tmp_path, monkeypatch):
    """A dense attention that lets each query see one key past its
    position fails the entry's gate against the plain path."""
    from cordum_tpu_torch.ops import dense_attention as da

    def leaky(q, k, v, positions):
        return da.dense_attention_reference(q, k, v, positions + 1)

    _cpu_launch_gates(monkeypatch)
    monkeypatch.setattr(tl, "dense_attention", leaky)
    with pytest.raises(AssertionError, match="kernel path against the plain path"):
        chip_smoke.phase_graft(torch, CPU, "cpu", str(tmp_path))


def test_chip_smoke_dryrun_leg_passes_on_the_cpu(monkeypatch):
    """The leg at n 2 (gloo CPU ranks: dense tp 2, MoE tp 2, pipeline pp
    2)."""
    _cpu_launch_gates(monkeypatch)
    launches = chip_smoke.cards_dryrun_leg(torch, CPU, "cpu", n=2)
    assert set(launches) == {*chip_smoke.GRAFT_LAUNCH_ROWS, "embed_attention"}


def test_chip_smoke_dryrun_leg_refuses_replicas_joined_out_of_order(monkeypatch):
    """The replicas' blocks joined in reverse order: rows land on other
    texts' rows; the leg stops at the embed gate, before any rank process
    starts."""
    def reversed_blocks(self, ids, mask):
        b = ids.shape[0]
        pad = -b % self.mesh_size
        ids = np.pad(ids, ((0, pad), (0, 0)))
        mask = np.pad(np.asarray(mask, np.float32), ((0, pad), (0, 0)))
        rows = len(ids) // len(self.replicas)
        with torch.no_grad():
            outs = [te.forward(params, torch.from_numpy(ids[i * rows:(i + 1) * rows]),
                               torch.from_numpy(mask[i * rows:(i + 1) * rows]), self.cfg)
                    for i, (_, params) in enumerate(self.replicas)]
        return torch.cat(outs[::-1]).numpy()[:b]

    _cpu_launch_gates(monkeypatch)
    monkeypatch.setattr(te.Embedder, "embed_tokens", reversed_blocks)
    with pytest.raises(AssertionError, match="same blocks max error"):
        chip_smoke.cards_dryrun_leg(torch, CPU, "cpu", n=4)


def test_loss_gates_refuse_a_rank_loss_off_by_more_than_the_bound():
    oracle = {"dense dp×tp×sp": 6.0}
    results = {"dense dp×tp×sp": {"loss": 6.0 * (1 + 2e-5), "mesh": {}}}
    with pytest.raises(AssertionError, match="against one process's"):
        chip_smoke.check_graft_losses(results, oracle, "t", "cpu")
    results["dense dp×tp×sp"]["loss"] = 6.0 * (1 + 5e-6)
    chip_smoke.check_graft_losses(results, oracle, "t", "cpu")
    assert math.isclose(results["dense dp×tp×sp"]["loss"], 6.0, rel_tol=1e-5)
