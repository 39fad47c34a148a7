"""Long-running training jobs on a worker that owns one CUDA card:
checkpoint/resume + progress + cooperative cancel.  The PyTorch
counterpart of ``cordum_tpu/worker/training.py``.

A job runs a multi-step training loop for a registered model family and
saves a checkpoint every ``checkpoint_every`` steps, so a re-dispatched job
(worker crash, preemption, reconciler timeout → DLQ retry) resumes from the
latest step instead of restarting.

Job payload (the reference's keys)::

    {"op": "train", "model": "llama-tiny", "steps": 100,
     "batch": 8, "seq": 64, "checkpoint_every": 20,
     "run_name": "exp1", "seed": 0, "fixed_batch": false,
     "mesh": {"tp": 1, "sp": 1}, "microbatches": 2}

Families: ``llama-tiny`` is ``LlamaConfig.tiny()``, ``llama`` is
``LlamaConfig()``, ``moe`` and ``moe-tiny`` are both ``MoEConfig.tiny()``,
``pipeline*`` is ``PipelineConfig(base=LlamaConfig.tiny(), n_stages=pp,
n_microbatches=microbatches)`` (as the reference builds them); an unknown
family raises ``ValueError``.  One card, so every mesh axis resolves to 1
(``tp``, ``sp``, for MoE ``ep`` and for the pipeline ``pp``, through the
reference's ``safe``): the pipeline runs its microbatched schedule on the
card.  Its batch is rounded up to ``dp × microbatches`` and microbatched
before the step.

Where the port departs from the reference on purpose:

  * batches come from a ``torch.Generator`` on the runner's device seeded
    ``1000`` (``fixed_batch``) or ``1000 + step``: the same seeds as the
    reference's ``jax.random`` keys, other numbers;
  * checkpoints are ``torch.save`` files, not orbax: one directory per step
    under ``ckpt_root/run_name/``, written under a temporary name and
    renamed (a cut run never leaves half a checkpoint), the newest
    :data:`MAX_TO_KEEP` kept.  Neither package reads the other's.

Also :func:`profile_trace`: a call under ``torch.profiler`` with a Chrome
trace written into ``trace_dir``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..infra import logging as logx
from ..models import llama, moe, pipeline
from ..optim import tree_map
from ..parallel.mesh import MeshSpec

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


def model_config(model: str, *, pp: int = 1, microbatches: int = 2
                 ) -> "llama.LlamaConfig | moe.MoEConfig | pipeline.PipelineConfig":
    """The configuration of a model family (``pp`` and ``microbatches``: a
    pipeline's stages and microbatches); ``ValueError`` for an unknown
    family."""
    if model.startswith("llama"):
        return llama.LlamaConfig.tiny() if "tiny" in model else llama.LlamaConfig()
    if model.startswith("moe"):
        return moe.MoEConfig.tiny()
    if model.startswith("pipeline"):
        return pipeline.PipelineConfig(base=llama.LlamaConfig.tiny(), n_stages=pp,
                                       n_microbatches=microbatches)
    raise ValueError(f"unknown model family {model!r}")


class TrainRunner:
    """Builds and runs checkpointed training loops (one per model family)
    on ``device`` (``None``: the current CUDA card; raises without one)."""

    def __init__(self, *, ckpt_root: Optional[str] = None, device: DeviceLike = None):
        self.ckpt_root = ckpt_root or default_ckpt_root()
        self.device = resolve_device(device)

    # -- model family registry ------------------------------------------
    def _build(self, payload: dict):
        """``(init, step, mesh, vocab, model, microbatches)`` of the job's
        family; ``microbatches`` is the pipeline's count, ``None`` for a
        family whose step takes the batch whole."""
        model = str(payload.get("model", "llama-tiny"))
        mesh_req = payload.get("mesh") or {}
        n_dev = 1  # one card

        def safe(n):
            n = int(n)
            return n if n > 0 and n_dev % n == 0 else 1

        tp, sp, ep, pp = (safe(mesh_req.get(k, 1)) for k in ("tp", "sp", "ep", "pp"))
        cfg = model_config(model, pp=pp, microbatches=int(payload.get("microbatches", 2)))
        if isinstance(cfg, pipeline.PipelineConfig):
            mesh = MeshSpec(dp=-1, pp=pp).resolve(n_dev)
            init, step = pipeline.make_train_step(cfg, device=self.device)
            return init, step, mesh, cfg.base.vocab_size, model, cfg.n_microbatches
        if isinstance(cfg, moe.MoEConfig):
            mesh = MeshSpec(dp=-1, tp=tp, ep=ep).resolve(n_dev)
            init, step = moe.make_train_step(cfg, device=self.device)
            return init, step, mesh, cfg.base.vocab_size, model, None
        mesh = MeshSpec(dp=-1, tp=tp, sp=sp).resolve(n_dev)
        init, step = llama.make_train_step(cfg, device=self.device)
        return init, step, mesh, cfg.vocab_size, model, None

    # -- the loop --------------------------------------------------------
    def train(self, payload: dict, *, cancelled: Optional[Callable[[], bool]] = None,
              progress: Optional[Callable[[float, str], Any]] = None) -> dict:
        """Runs synchronously (call from the worker executor thread).
        ``cancelled``: callable → bool, checked before each step;
        ``progress``: callable(frac, msg), called after each step."""
        init, step, mesh, vocab, model, mb = self._build(payload)
        steps = int(payload.get("steps", 10))
        dp = mesh["dp"]
        batch = int(payload.get("batch", max(2, dp * 2)))
        # batch must divide dp (and microbatches for pipeline): round up
        quantum = dp * (mb or 1)
        batch = max(quantum, ((batch + quantum - 1) // quantum) * quantum)
        seq = int(payload.get("seq", 32))
        ckpt_every = int(payload.get("checkpoint_every", 0))
        run_name = str(payload.get("run_name", "default"))

        params, opt_state = init(int(payload.get("seed", 0)))
        start_step = 0
        ckpt = None
        if ckpt_every > 0:
            ckpt = CheckpointDir(os.path.join(self.ckpt_root, run_name))
            latest = ckpt.latest_step()
            if latest is not None:
                try:
                    restored = ckpt.restore(latest, self.device)
                    new_params = _restored_like(params, restored["params"])
                    new_state = _restored_like(opt_state, restored["opt_state"])
                except Exception:  # any unreadable checkpoint: the run starts fresh
                    logx.warn("checkpoint restore failed; starting fresh", run=run_name)
                else:
                    params, opt_state, start_step = new_params, new_state, latest
                    logx.info("resumed from checkpoint", run=run_name, step=latest)

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
                ckpt.save(i + 1, {"params": tree_map(torch.Tensor.detach, params),
                                  "opt_state": tree_map(torch.Tensor.detach, opt_state)})
            if progress is not None:
                progress((i + 1) / steps, f"step {i + 1}/{steps} loss={losses[-1]:.4f}")
        done = start_step + len(losses)
        return {
            "model": model,
            "mesh": {k: int(v) for k, v in mesh.items()},
            "resumed_from": start_step,
            "steps_done": done,
            "completed": done >= steps,
            "final_loss": losses[-1] if losses else None,
            "loss_first": losses[0] if losses else None,
            "seconds": round(time.monotonic() - t0, 3),
            "checkpointed": ckpt is not None,
        }


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
