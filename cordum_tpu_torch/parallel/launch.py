"""Rank processes on one host: start ``world`` processes, one a card (or
gloo CPU ranks when asked), join them into a :class:`.mesh.TrainMesh` and
collect their results.

The reference needs no such piece: one JAX process owns every local
device and GSPMD places the arrays.  Torch runs one process a card, so a
job that spans a host's cards runs as rank processes::

    results = run_ranks("pkg.module:function", job, world=4,
                        spec=MeshSpec(dp=-1, tp=2), timeout_s=600)

:func:`run_ranks` opens the rendezvous store (:func:`.mesh.open_store`) in
the caller's process, writes the job to a file and starts ``python -m
cordum_tpu_torch.parallel.launch --rank R --job PATH`` once a rank.  Rank
``r`` runs on ``cuda:r`` (NCCL), or on the CPU when the caller passes
``device="cpu"`` (gloo); a caller that names one card puts every rank on
it (gloo stages the tensors through host memory).  There is no fallback:
on a host with cards, ``world`` above ``torch.cuda.device_count()``
raises, and no rank is moved to the CPU.  Each rank joins the mesh of
``spec`` (``TrainMesh.join``; a list of specs joins one mesh each),
imports ``target`` by its ``"module:function"`` name (nothing is pickled),
calls ``target(job, mesh)`` and writes what it returns as JSON; the call
returns the ranks' results in rank order.

A rank that exits non-zero stops the others at once (they would wait for
it until their collectives time out), and a run that outlives
``timeout_s`` is killed whole; either way the caller gets a
:class:`RankError` with every rank's exit code and the tail of its log.

Progress and cancel: the job a rank receives carries the paths of a
progress file and a cancel marker (``job["launch"]``).  Rank 0 appends
records with :func:`report`; the caller's thread passes each to its
``progress`` callback while it waits.  The caller's ``cancelled``
callable is polled there too and, once true, the marker is written; a
rank's loop asks :func:`stop_requested` before each step, which sums
every rank's reading of the marker over the world, so every rank stops
at the same step and no collective is left waiting for a peer.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Union

import torch

from ..device import DeviceLike, resolve_device
from .mesh import MeshSpec, TrainMesh, connect_store, open_store

#: how long a rank that is asked to stop gets before it is killed
STOP_GRACE_S = 5.0
#: how often the caller looks at the ranks, their progress and the cancel
POLL_S = 0.05
#: the bytes of each rank's log a failure report carries
LOG_TAIL = 3000
#: the directory that holds the ``cordum_tpu_torch`` package: on every
#: rank's import path
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankError(RuntimeError):
    """A run of rank processes failed: ``codes`` holds each rank's exit
    code (None: killed at the deadline), ``tails`` the end of each rank's
    log."""

    def __init__(self, message: str, codes: list, tails: list[str]):
        super().__init__(message + "".join(
            f"\n--- rank {r} (exit {c}) ---\n{t}" for r, (c, t) in enumerate(zip(codes, tails))))
        self.codes = codes
        self.tails = tails


def rank_devices(world: int, device: DeviceLike = None) -> list[str]:
    """The device of each of ``world`` ranks: ``cuda:r`` for rank ``r``
    when ``device`` is None or ``"cuda"`` (``RuntimeError`` without a card,
    ``ValueError`` when the host has fewer cards than ranks); the CPU for
    every rank with ``device="cpu"``; the one named card for every rank
    when ``device`` names one (``"cuda:0"``)."""
    if world < 1:
        raise ValueError(f"a run needs at least one rank, got {world}")
    dev = resolve_device(device)
    if device is None or (dev.type == "cuda" and dev.index is None):
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(f"{world} ranks need {world} cards, this host has {n}")
        return [f"cuda:{r}" for r in range(world)]
    return [str(dev)] * world


def _specs(spec: Union[MeshSpec, Sequence[MeshSpec]]) -> list[MeshSpec]:
    return [spec] if isinstance(spec, MeshSpec) else list(spec)


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - LOG_TAIL))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def _stop(procs: list[subprocess.Popen]) -> list[Optional[int]]:
    """Terminate every rank still running, kill it after
    :data:`STOP_GRACE_S`; each rank's exit code."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


class _ProgressReader:
    """The caller's side of the progress file: the records appended since
    the last read, each once."""

    def __init__(self, path: str, callback: Optional[Callable[[dict], Any]]):
        self.path, self.callback, self.offset = path, callback, 0

    def poll(self) -> None:
        if self.callback is None or not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read()
        end = data.rfind(b"\n") + 1  # a line still being written waits for the next poll
        self.offset += end
        for line in data[:end].splitlines():
            self.callback(json.loads(line))


def run_ranks(target: str, job: dict, *, world: int,
              spec: Union[MeshSpec, Sequence[MeshSpec]], device: DeviceLike = None,
              timeout_s: float, peer_timeout_s: Optional[float] = None,
              progress: Optional[Callable[[dict], Any]] = None,
              cancelled: Optional[Callable[[], bool]] = None,
              workdir: Optional[str] = None) -> list:
    """Run ``target(job, mesh)`` on ``world`` rank processes and return
    what each returned (JSON), in rank order.

    ``target``: ``"module:function"``, importable on the ranks (the
    caller's working directory and this package's root are on their import
    path).  ``job``: JSON-able; each rank gets a copy with ``"launch"``
    added (the progress and cancel paths).  ``spec``: the mesh the ranks
    join, or a list of specs, in which case ``target`` gets a list of
    meshes.  ``device``: see :func:`rank_devices`.  ``timeout_s`` bounds
    the whole run; ``peer_timeout_s`` (default ``timeout_s``) bounds each
    collective of the ranks and their rendezvous.  ``progress`` gets each
    record rank 0 reports; ``cancelled`` is polled while the ranks run.
    ``workdir``: where the run's files go (the job, each rank's log and
    result), kept; by default a temporary directory, removed.  Raises :class:`RankError` when a rank fails or the run outlives
    ``timeout_s``."""
    devices = rank_devices(world, device)
    specs = _specs(spec)
    for s in specs:
        s.resolve(world)  # a mesh the world cannot hold fails here, before any process starts
    peer_timeout_s = timeout_s if peer_timeout_s is None else peer_timeout_s
    keep = workdir is not None
    workdir = workdir if keep else tempfile.mkdtemp(prefix="cordum-ranks-")
    store, addr = open_store(world + 1, timeout_s=peer_timeout_s)
    paths = {"progress": os.path.join(workdir, "progress.jsonl"),
             "cancel": os.path.join(workdir, "cancel")}
    for path in paths.values():  # an earlier run's, in a kept directory
        if os.path.exists(path):
            os.remove(path)
    run = {"target": target, "job": {**job, "launch": paths}, "world": world,
           "specs": [dataclasses.asdict(s) for s in specs], "devices": devices, "addr": addr,
           "timeout_s": peer_timeout_s, "out": workdir}
    job_path = os.path.join(workdir, "job.json")
    with open(job_path, "w") as f:
        json.dump(run, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, os.getcwd(), env.get("PYTHONPATH", "")) if p)
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs: list[subprocess.Popen] = []
    reader = _ProgressReader(paths["progress"], progress)
    timed_out = False
    try:
        for r in range(world):
            with open(logs[r], "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "cordum_tpu_torch.parallel.launch", "--rank", str(r),
                     "--job", job_path], stdout=log_f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            reader.poll()
            if cancelled is not None and not os.path.exists(paths["cancel"]) and cancelled():
                with open(paths["cancel"], "w"):
                    pass
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(POLL_S)
        codes = _stop(procs)
        reader.poll()
        if timed_out or any(codes):
            why = f"outlived its {timeout_s:g} s deadline" if timed_out else "failed"
            raise RankError(f"{target} on {world} ranks {why}: exit codes {codes}", codes,
                            [_tail(p) for p in logs])
        results = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        _stop(procs)
        del store
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# inside a rank
# ---------------------------------------------------------------------------


def report(job: dict, mesh: TrainMesh, record: dict) -> None:
    """Append ``record`` to the run's progress file, from world rank 0 (the
    other ranks' calls do nothing).  Outside a rank process (no
    ``job["launch"]``) nothing is written."""
    paths = job.get("launch")
    if paths and mesh.rank == 0:
        with open(paths["progress"], "a") as f:
            f.write(json.dumps(record) + "\n")


def stop_requested(job: dict, mesh: TrainMesh) -> bool:
    """Whether the caller asked the run to stop: every rank reads the
    cancel marker and the readings are summed over the world, so all ranks
    give the same answer at the same step.  Every rank must call it at the
    same point of its program.  False outside a rank process."""
    paths = job.get("launch")
    if not paths:
        return False
    flag = torch.tensor([float(os.path.exists(paths["cancel"]))], device=mesh.device)
    return mesh.all_reduce(flag, "world").item() > 0


def _import(target: str) -> Callable[..., Any]:
    module, _, name = target.partition(":")
    if not module or not name:
        raise ValueError(f"target {target!r} is not 'module:function'")
    return getattr(importlib.import_module(module), name)


def rank_main(rank: int, job_path: str) -> int:
    """One rank of :func:`run_ranks`: join the meshes, run the target,
    write its result."""
    with open(job_path) as f:
        run = json.load(f)
    dev = torch.device(run["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # CPU ranks share the host's cores: one thread each, not all of them each
        torch.set_num_threads(1)
    store = connect_store(run["addr"], run["world"] + 1, timeout_s=run["timeout_s"])
    fn = _import(run["target"])
    meshes = [TrainMesh.join(torch.distributed.PrefixStore(f"mesh{i}", store), rank,
                             run["world"], dev, spec=MeshSpec(**s), timeout_s=run["timeout_s"])
              for i, s in enumerate(run["specs"])]
    try:
        result = fn(run["job"], meshes[0] if len(meshes) == 1 else meshes)
        tmp = os.path.join(run["out"], f".rank{rank}.json")
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, os.path.join(run["out"], f"rank{rank}.json"))
    finally:
        for m in meshes:
            m.close()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="one rank process of run_ranks")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--job", required=True)
    a = ap.parse_args(argv)
    try:
        return rank_main(a.rank, a.job)
    except Exception:  # noqa: BLE001 - the rank's failure goes to its log and exit code
        traceback.print_exc()
        sys.stdout.flush()
        return 1


if __name__ == "__main__":
    sys.exit(main())
