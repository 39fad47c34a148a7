"""Long-running training jobs on a worker's cards: checkpoint/resume +
progress + cooperative cancel.  The PyTorch counterpart of
``cordum_tpu/worker/training.py``.

A job runs a multi-step training loop for a registered model family and
saves a checkpoint every ``checkpoint_every`` steps, so a re-dispatched job
(worker crash, preemption, reconciler timeout → DLQ retry) resumes from the
latest step instead of restarting.

Job payload (the reference's keys, and ``dtype``)::

    {"op": "train", "model": "llama-tiny", "steps": 100,
     "batch": 8, "seq": 64, "checkpoint_every": 20,
     "run_name": "exp1", "seed": 0, "fixed_batch": false,
     "mesh": {"tp": 1, "sp": 1}, "microbatches": 2, "dtype": "float32"}

Families: ``llama-tiny`` is ``LlamaConfig.tiny()``, ``llama`` is
``LlamaConfig()``, ``moe`` and ``moe-tiny`` are both ``MoEConfig.tiny()``,
``pipeline*`` is ``PipelineConfig(base=LlamaConfig.tiny(), n_stages=pp,
n_microbatches=microbatches)`` (as the reference builds them); an unknown
family raises ``ValueError``.  ``dtype`` (``float32`` or ``bfloat16``; not
a reference key) replaces the config's weight dtype.

Every family trains over all the worker's cards, as the reference's
resolves onto all local devices: ``llama`` on ``MeshSpec(dp=-1, tp, sp)``,
``moe`` on ``MeshSpec(dp=-1, tp, ep)``, ``pipeline`` on ``MeshSpec(dp=-1,
pp)`` with pp 2 on an even number of cards unless asked; an asked size
that does not divide the cards is 1 (the reference's ``safe``).  On one
card every axis is 1 and the loop runs in this process (the pipeline runs
its microbatched schedule on the card); on more, one rank process a card
runs it over a :class:`~..parallel.mesh.TrainMesh`
(:func:`~..parallel.launch.run_ranks`), each rank drawing the whole batch
and its family's step taking the rank's part.  The batch is rounded up to
``dp × microbatches`` and, for the pipeline, microbatched before the step.

Where the port departs from the reference on purpose:

  * batches come from a ``torch.Generator`` on the runner's device seeded
    ``1000`` (``fixed_batch``) or ``1000 + step``: the same seeds as the
    reference's ``jax.random`` keys, other numbers;
  * checkpoints are ``torch.save`` files, not orbax: one directory per step
    under ``ckpt_root/run_name/``, written under a temporary name and
    renamed (a cut run never leaves half a checkpoint), the newest
    :data:`MAX_TO_KEEP` kept.  Neither package reads the other's.  Like
    the reference's global orbax arrays, a checkpoint holds the whole tree
    in the one-card layout whatever the mesh: the ranks gather their
    slices over tp, ep and pp and rank 0 writes it, and each rank restores
    its slices of it, so a run resumes on any number of cards.

Also :func:`profile_trace`: a call under ``torch.profiler`` with a Chrome
trace written into ``trace_dir``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..device import DeviceLike, local_world, resolve_device
from ..infra import logging as logx
from ..models import llama, moe, pipeline
from ..optim import tree_map
from ..parallel.launch import report, run_ranks, stop_requested
from ..parallel.mesh import MeshSpec, TrainMesh

#: checkpoints kept per run (the reference's orbax ``max_to_keep``)
MAX_TO_KEEP = 3
_STATE_FILE = "state.pt"


def default_ckpt_root() -> str:
    """``$CORDUM_CKPT_DIR``, else ``cordum-ckpt`` in the temporary
    directory."""
    return os.environ.get("CORDUM_CKPT_DIR") or os.path.join(tempfile.gettempdir(),
                                                             "cordum-ckpt")


class CheckpointDir:
    """The checkpoints of one run: ``<path>/<step>/state.pt``, each a
    ``torch.save`` of ``{"params", "opt_state"}``."""

    def __init__(self, path: str, *, max_to_keep: int = MAX_TO_KEEP):
        self.path = Path(path)
        self.max_to_keep = max_to_keep
        self.path.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list[int]:
        """The saved steps, oldest first (temporary directories, whose
        names start with a dot, are not steps)."""
        return sorted(int(p.name) for p in self.path.iterdir()
                      if p.name.isdigit() and (p / _STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` as step ``step``: into a temporary directory,
        renamed into place once the file is complete; then drop all but
        the newest ``max_to_keep`` steps."""
        tmp = self.path / f".{step}.{os.getpid()}.{threading.get_ident()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / _STATE_FILE)
        final = self.path / str(step)
        shutil.rmtree(final, ignore_errors=True)  # a step saved again after a failed restore
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path / str(old), ignore_errors=True)

    def restore(self, step: int, device: torch.device) -> dict:
        return torch.load(self.path / str(step) / _STATE_FILE, map_location=device,
                          weights_only=True)


def _restored_like(template: Any, value: Any) -> Any:
    """``value`` in ``template``'s structure, shapes, dtypes and device,
    with ``requires_grad`` as the template has it; raises ``ValueError``
    where they differ, so nothing is replaced from a checkpoint of another
    model."""
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != template.shape \
                or value.dtype != template.dtype:
            raise ValueError("checkpoint does not match the model")
        return value.detach().to(template.device).requires_grad_(template.requires_grad)
    if isinstance(template, dict):
        if not isinstance(value, dict) or set(value) != set(template):
            raise ValueError("checkpoint does not match the model")
        return {k: _restored_like(template[k], value[k]) for k in template}
    if not isinstance(value, (list, tuple)) or len(value) != len(template):
        raise ValueError("checkpoint does not match the model")
    return [_restored_like(t, v) for t, v in zip(template, value)]


#: the run deadline of a job's rank processes (none: a training job runs
#: as long as it takes) and the most a rank waits for a peer in a collective
RANK_PEER_TIMEOUT_S = 300.0
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(model: str, *, pp: int = 1, microbatches: int = 2, dtype: Optional[str] = None
                 ) -> "llama.LlamaConfig | moe.MoEConfig | pipeline.PipelineConfig":
    """The configuration of a model family (``pp`` and ``microbatches``: a
    pipeline's stages and microbatches; ``dtype``, ``"float32"`` or
    ``"bfloat16"``, the weights' dtype in place of the config's);
    ``ValueError`` for an unknown family or dtype."""
    if dtype is not None and dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}: float32 or bfloat16")

    def base(cfg: llama.LlamaConfig) -> llama.LlamaConfig:
        return cfg if dtype is None else dataclasses.replace(cfg, dtype=_DTYPES[dtype])

    if model.startswith("llama"):
        return base(llama.LlamaConfig.tiny() if "tiny" in model else llama.LlamaConfig())
    if model.startswith("moe"):
        return dataclasses.replace(moe.MoEConfig.tiny(), base=base(llama.LlamaConfig.tiny()))
    if model.startswith("pipeline"):
        return pipeline.PipelineConfig(base=base(llama.LlamaConfig.tiny()), n_stages=pp,
                                       n_microbatches=microbatches)
    raise ValueError(f"unknown model family {model!r}")


def _tree_fn(fn: Callable[[Any], Any]) -> Callable[[dict], Optional[dict]]:
    """``fn`` of a params tree applied to a checkpoint's ``{"params",
    "opt_state"}`` (the AdamW moments have the params' structure; the
    count is a scalar every rank holds); None where ``fn`` gives None."""
    def apply(state: dict) -> Optional[dict]:
        opt = state["opt_state"]
        params, mu, nu = fn(state["params"]), fn(opt["mu"]), fn(opt["nu"])
        if params is None:
            return None
        return {"params": params, "opt_state": {"count": opt["count"], "mu": mu, "nu": nu}}

    return apply


def _slices(cfg: Any, mesh: Optional[TrainMesh]) -> Callable[[dict], Optional[dict]]:
    """A checkpoint (the whole tree, one-card layout) → this rank's
    slices of it: ``shard_params`` of its family, the pipeline's
    ``stage_slice`` of the tree restacked to the config's stages."""
    if isinstance(cfg, pipeline.PipelineConfig):
        def fn(t):
            t = pipeline.restack(t, cfg.n_stages)
            if mesh is None or mesh.pp == 1:
                return t
            return tree_map(torch.clone, pipeline.stage_slice(t, cfg, mesh.pp_rank))
    elif mesh is None:
        def fn(t):
            return t
    elif isinstance(cfg, moe.MoEConfig):
        def fn(t):
            return moe.shard_params(t, cfg, (mesh.coords, mesh.sizes))
    else:
        def fn(t):
            return llama.shard_params(t, cfg, mesh.tp_rank, mesh.tp)
    return _tree_fn(fn)


def _whole(cfg: Any, mesh: Optional[TrainMesh]) -> Callable[[dict], Optional[dict]]:
    """This rank's state → the whole tree in the one-card layout (the
    inverse of :func:`_slices`, gathered over tp, ep and pp: a collective
    every rank calls); None on a rank that does not get it (a pipeline's
    later stages)."""
    if isinstance(cfg, pipeline.PipelineConfig):
        def fn(t):
            whole = pipeline.gather_stages(t, cfg, mesh)
            return None if whole is None else pipeline.restack(whole, 1)
    elif isinstance(cfg, moe.MoEConfig):
        def fn(t):
            return moe.gather_params(t, cfg, mesh)
    else:
        def fn(t):
            return llama.gather_params(t, cfg, mesh)
    return _tree_fn(fn)


def _agree(ok: bool, mesh: Optional[TrainMesh]) -> bool:
    """Whether ``ok`` holds on every rank of the mesh (one all-reduce)."""
    if mesh is None or mesh.size == 1:
        return ok
    flag = torch.tensor([float(not ok)], device=mesh.device)
    return mesh.all_reduce(flag, "world").item() == 0


class TrainRunner:
    """Builds and runs checkpointed training loops (one per model family)
    on the cards a worker owns: ``device`` (``None``: the current CUDA
    card; raises without one) and, on a card, every card the process sees
    unless ``ranks`` says how many (the reference's ``len(jax.devices())``;
    on the CPU, ``ranks`` CPU ranks, one by default).  One card trains in
    this process; more run the loop as rank processes of one
    :class:`~..parallel.mesh.TrainMesh` (:func:`..parallel.launch.run_ranks`),
    one a card over NCCL (gloo CPU ranks on the CPU)."""

    def __init__(self, *, ckpt_root: Optional[str] = None, device: DeviceLike = None,
                 ranks: Optional[int] = None):
        self.ckpt_root = ckpt_root or default_ckpt_root()
        self.device = resolve_device(device)
        self.world = local_world(self.device, ranks)

    # -- model family registry ------------------------------------------
    def _family(self, payload: dict) -> tuple[str, Any, MeshSpec]:
        """``(model, cfg, spec)`` of the job over this runner's world: the
        reference's axes, each asked size kept where it divides the world
        (its ``safe``), the pipeline's pp 2 on an even world unless asked."""
        model = str(payload.get("model", "llama-tiny"))
        mesh_req = payload.get("mesh") or {}
        n_dev = self.world

        def safe(n):
            n = int(n)
            return n if n > 0 and n_dev % n == 0 else 1

        tp, sp, ep, pp = (safe(mesh_req.get(k, 1)) for k in ("tp", "sp", "ep", "pp"))
        if model.startswith("pipeline"):
            pp = pp if pp > 1 else (2 if n_dev % 2 == 0 else 1)
        dtype = payload.get("dtype")
        cfg = model_config(model, pp=pp, microbatches=int(payload.get("microbatches", 2)),
                           dtype=None if dtype is None else str(dtype))
        if isinstance(cfg, pipeline.PipelineConfig):
            spec = MeshSpec(dp=-1, pp=pp)
        elif isinstance(cfg, moe.MoEConfig):
            spec = MeshSpec(dp=-1, tp=tp, ep=ep)
        else:
            spec = MeshSpec(dp=-1, tp=tp, sp=sp)
        return model, cfg, spec

    def _build(self, payload: dict, mesh: Optional[TrainMesh] = None):
        """``(init, step, mesh, vocab, model, microbatches)`` of the job's
        family, ``mesh`` its resolved axis sizes; ``microbatches`` is the
        pipeline's count, ``None`` for a family whose step takes the batch
        whole.  With a rank's ``mesh``, the rank's step."""
        model, cfg, spec = self._family(payload)
        sizes = spec.resolve(self.world) if mesh is None else dict(mesh.sizes)
        if isinstance(cfg, pipeline.PipelineConfig):
            init, step = pipeline.make_train_step(cfg, device=self.device, mesh=mesh)
            return init, step, sizes, cfg.base.vocab_size, model, cfg.n_microbatches
        if isinstance(cfg, moe.MoEConfig):
            init, step = moe.make_train_step(cfg, device=self.device, mesh=mesh)
            return init, step, sizes, cfg.base.vocab_size, model, None
        init, step = llama.make_train_step(cfg, device=self.device, mesh=mesh)
        return init, step, sizes, cfg.vocab_size, model, None

    # -- the loop --------------------------------------------------------
    def train(self, payload: dict, *, cancelled: Optional[Callable[[], bool]] = None,
              progress: Optional[Callable[[float, str], Any]] = None) -> dict:
        """Runs synchronously (call from the worker executor thread).
        ``cancelled``: callable → bool, checked before each step;
        ``progress``: callable(frac, msg), called after each step.  Over
        more than one card the ranks run the loop and every rank stops at
        the same step on a cancel; the result is rank 0's (every rank's
        losses are the global ones)."""
        if self.world == 1:
            return self._loop(payload, self._build(payload), None, cancelled, progress)
        _, _, spec = self._family(payload)  # an unknown family fails here, before any rank
        results = run_ranks(
            "cordum_tpu_torch.worker.training:train_rank",
            {"payload": payload, "ckpt_root": self.ckpt_root}, world=self.world, spec=spec,
            device=None if self.device.type == "cuda" else self.device,
            timeout_s=math.inf, peer_timeout_s=RANK_PEER_TIMEOUT_S,
            progress=None if progress is None else (lambda r: progress(r["frac"], r["msg"])),
            cancelled=cancelled)
        keys = ("steps_done", "final_loss", "loss_first", "mesh")
        for r, doc in enumerate(results):
            if any(doc[k] != results[0][k] for k in keys):
                raise RuntimeError(f"rank {r} ended the run otherwise than rank 0: "
                                   f"{ {k: doc[k] for k in keys} } against "
                                   f"{ {k: results[0][k] for k in keys} }")
        return results[0]

    def _loop(self, payload: dict, built: tuple, mesh: Optional[TrainMesh],
              cancelled: Optional[Callable[[], bool]],
              progress: Optional[Callable[[float, str], Any]]) -> dict:
        """The training loop of one process: this runner's card, or one
        rank of a mesh (each rank draws the whole batch, its step takes its
        part; checkpoints hold the whole tree in the one-card layout,
        written by rank 0, and every rank restores its slices of them)."""
        init, step, sizes, vocab, model, mb = built
        _, cfg, _ = self._family(payload)
        steps = int(payload.get("steps", 10))
        dp = sizes["dp"]
        batch = int(payload.get("batch", max(2, dp * 2)))
        # batch must divide dp (and microbatches for pipeline): round up
        quantum = dp * (mb or 1)
        batch = max(quantum, ((batch + quantum - 1) // quantum) * quantum)
        seq = int(payload.get("seq", 32))
        ckpt_every = int(payload.get("checkpoint_every", 0))
        run_name = str(payload.get("run_name", "default"))
        writer = mesh is None or mesh.rank == 0

        params, opt_state = init(int(payload.get("seed", 0)))
        start_step = 0
        ckpt = None
        if ckpt_every > 0:
            ckpt = CheckpointDir(os.path.join(self.ckpt_root, run_name))
            latest = ckpt.latest_step()
            if latest is not None:
                try:
                    local = _slices(cfg, mesh)(ckpt.restore(latest, torch.device("cpu")))
                    new_params = _restored_like(params, local["params"])
                    new_state = _restored_like(opt_state, local["opt_state"])
                    ok = True
                except Exception:  # any unreadable checkpoint: the run starts fresh
                    ok = False
                if _agree(ok, mesh):
                    params, opt_state, start_step = new_params, new_state, latest
                    logx.info("resumed from checkpoint", run=run_name, step=latest)
                else:
                    logx.warn("checkpoint restore failed; starting fresh", run=run_name)

        losses: list[float] = []
        t0 = time.monotonic()
        fixed_batch = bool(payload.get("fixed_batch", False))
        for i in range(start_step, steps):
            if cancelled is not None and cancelled():
                break
            gen = torch.Generator(device=self.device).manual_seed(
                1000 if fixed_batch else 1000 + i)
            tokens = torch.randint(0, vocab, (batch, seq), generator=gen, device=self.device,
                                   dtype=torch.int32)
            if mb is not None:
                tokens = pipeline.microbatch(tokens, mb)
            params, opt_state, loss = step(params, opt_state, tokens)
            losses.append(float(loss))
            if ckpt is not None and (i + 1) % ckpt_every == 0:
                whole = _whole(cfg, mesh)({"params": tree_map(torch.Tensor.detach, params),
                                           "opt_state": tree_map(torch.Tensor.detach,
                                                                 opt_state)})
                if writer:
                    ckpt.save(i + 1, whole)
            if progress is not None:
                progress((i + 1) / steps, f"step {i + 1}/{steps} loss={losses[-1]:.4f}")
        done = start_step + len(losses)
        return {
            "model": model,
            "mesh": {k: int(v) for k, v in sizes.items()},
            "resumed_from": start_step,
            "steps_done": done,
            "completed": done >= steps,
            "final_loss": losses[-1] if losses else None,
            "loss_first": losses[0] if losses else None,
            "seconds": round(time.monotonic() - t0, 3),
            "checkpointed": ckpt is not None,
        }


def train_rank(job: dict, mesh: TrainMesh) -> dict:
    """One rank process of a multi-card ``train`` job (:func:`run_ranks`'s
    target): the loop of ``job["payload"]`` on the rank's card and mesh,
    progress from rank 0 and the cancel agreed over the world."""
    runner = TrainRunner(ckpt_root=job["ckpt_root"], device=mesh.device, ranks=mesh.size)
    payload = job["payload"]
    return runner._loop(
        payload, runner._build(payload, mesh), mesh,
        cancelled=lambda: stop_requested(job, mesh),
        progress=lambda frac, msg: report(job, mesh, {"frac": frac, "msg": msg}))


def profile_trace(fn: Callable[..., Any], *args: Any, trace_dir: Optional[str] = None):
    """Run ``fn(*args)`` under ``torch.profiler`` (host, and the card when
    there is one) and write its Chrome trace into ``trace_dir`` (default:
    ``cordum-torch-trace`` in the temporary directory); returns ``(result,
    trace_dir)``.  The directory can be uploaded as an artifact for offline
    inspection (``chrome://tracing``, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "cordum-torch-trace")
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    return out, trace_dir
