"""The rank launcher (``cordum_tpu_torch/parallel/launch.py``) on the CPU.

Each test that starts processes starts gloo CPU rank processes
(``device="cpu"``) running a target of this module, bounds the run with a
deadline and leaves no process behind (``run_ranks`` stops every rank on
every path).  This module imports no JAX, so the ranks import it cheaply.

* 4 ranks join a dp 2 × tp 2 mesh and return their coordinates in rank
  order; the job reaches each rank with the launcher's paths added.
* A rank that raises fails the call within seconds (its peer, still
  sleeping, is stopped at once), with every rank's log tail.
* A rank that hangs is killed at a short deadline.
* The caller reads rank 0's progress records whole, each once (the
  cancel across ranks is held by ``tests/test_torch_train_local_mesh.py``'s
  ``train`` job).
* There is no fallback: ranks beyond the host's cards, or no card and no
  device, raise before any process starts.
"""
from __future__ import annotations

import os
import subprocess
import time

import pytest
import torch

from cordum_tpu_torch.parallel import launch
from cordum_tpu_torch.parallel.mesh import MeshSpec, mesh_coords

HERE = "tests.test_torch_launch"


# -- rank targets (run inside the rank processes) ---------------------------

def coords_rank(job, mesh):
    return {"rank": mesh.rank, "coords": mesh.coords, "collective": mesh.backend,
            "device": str(mesh.device), "tag": job["tag"], "launch": sorted(job["launch"])}


def failing_rank(job, mesh):
    if mesh.rank == job["bad"]:
        print("rank about to fail", flush=True)
        raise RuntimeError("a planted failure")
    time.sleep(120)
    return {}


def hanging_rank(job, mesh):
    time.sleep(600)
    return {}


# -- the tests ------------------------------------------------------------------

def test_four_cpu_ranks_return_their_mesh_coordinates():
    spec = MeshSpec(dp=-1, tp=2)
    got = launch.run_ranks(f"{HERE}:coords_rank", {"tag": "x"}, world=4, spec=spec,
                           device="cpu", timeout_s=120)
    sizes = spec.resolve(4)
    assert [d["rank"] for d in got] == [0, 1, 2, 3]
    assert [d["coords"] for d in got] == [mesh_coords(sizes, r) for r in range(4)]
    assert {d["collective"] for d in got} == {"gloo"} and {d["device"] for d in got} == {"cpu"}
    assert all(d["tag"] == "x" and d["launch"] == ["cancel", "progress"] for d in got)


def test_a_rank_that_raises_fails_the_call_within_seconds_with_its_log(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(launch.RankError) as info:
        launch.run_ranks(f"{HERE}:failing_rank", {"bad": 1}, world=2, spec=MeshSpec(),
                         device="cpu", timeout_s=120, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60  # the peer sleeps 120 s: it was stopped
    err = info.value
    assert err.codes[1] == 1 and err.codes[0] != 0
    assert "a planted failure" in err.tails[1] and "rank about to fail" in err.tails[1]
    assert "a planted failure" in str(err) and "--- rank 0" in str(err)
    assert (tmp_path / "rank1.log").is_file() and not (tmp_path / "rank1.json").exists()


def test_a_rank_that_hangs_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="outlived its 8 s deadline") as info:
        launch.run_ranks(f"{HERE}:hanging_rank", {}, world=2, spec=MeshSpec(), device="cpu",
                         timeout_s=8, peer_timeout_s=60)
    assert time.monotonic() - t0 < 8 + launch.STOP_GRACE_S + 10
    assert all(c != 0 for c in info.value.codes)


def test_the_progress_reader_waits_for_a_whole_line(tmp_path):
    path = tmp_path / "progress.jsonl"
    seen = []
    reader = launch._ProgressReader(str(path), seen.append)
    reader.poll()  # no file yet
    path.write_bytes(b'{"a": 1}\n{"b"')
    reader.poll()
    assert seen == [{"a": 1}]
    with open(path, "ab") as f:
        f.write(b': 2}\n')
    reader.poll()
    reader.poll()
    assert seen == [{"a": 1}, {"b": 2}]


def _no_process(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a process was started")

    monkeypatch.setattr(subprocess, "Popen", refuse)


def test_more_ranks_than_cards_raise_before_any_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _no_process(monkeypatch)
    assert launch.rank_devices(2) == ["cuda:0", "cuda:1"]
    assert launch.rank_devices(2, "cuda") == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="4 ranks need 4 cards, this host has 2"):
        launch.rank_devices(4)
    with pytest.raises(ValueError, match="4 ranks need 4 cards"):
        launch.run_ranks(f"{HERE}:coords_rank", {}, world=4, spec=MeshSpec(), timeout_s=10)


def test_a_named_device_puts_every_rank_on_it():
    assert launch.rank_devices(3, "cpu") == ["cpu"] * 3
    assert launch.rank_devices(2, "cuda:0") == ["cuda:0"] * 2


def test_no_card_and_no_device_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_process(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(f"{HERE}:coords_rank", {}, world=2, spec=MeshSpec(), timeout_s=10)


def test_a_mesh_the_world_cannot_hold_raises_before_any_process(monkeypatch):
    _no_process(monkeypatch)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        launch.run_ranks(f"{HERE}:coords_rank", {}, world=2, spec=MeshSpec(dp=1, tp=4),
                         device="cpu", timeout_s=10)


def test_stop_and_report_outside_a_rank_do_nothing(tmp_path):
    class One:
        rank, device = 0, torch.device("cpu")

    assert launch.stop_requested({}, One()) is False
    launch.report({}, One(), {"step": 1})
    assert not os.listdir(tmp_path)
