"""Built-in job handlers for a worker that owns CUDA cards: the PyTorch
counterpart of ``cordum_tpu/worker/handlers.py``.

Job payloads arrive via context pointers as JSON: ``{"op": ..., ...}``.
Each op maps a control-plane job onto device work:

  * ``echo``          — the hello-pack contract: return the context payload
  * ``matmul``        — batched bf16 matmul chain (a GEMM benchmark op)
  * ``embed``         — batch text embedding (context-engine compute path)
  * ``infer``         — Llama forward step (greedy next-token scoring)
  * ``llm.generate``  — continuous-batching serving (the worker routes it to
                        the serving engine before the op table)
  * ``train``         — a checkpointed training job (:class:`.training.TrainRunner`)

Handlers are async wrappers that push the device work onto the worker's
executor threads (each pinned to the worker's device) so heartbeats and
cancels keep flowing while the card computes.

:func:`attach_default_gpu_worker` wires the op table, the micro-batcher and
the serving engine onto a :class:`Worker`; :func:`make_serving_engine` also
keeps its bare form, which builds a serving engine over given weights
without a worker.
"""
from __future__ import annotations

import asyncio
import contextlib
import functools
import threading
import time
from typing import Any, Awaitable, Callable, Optional

import numpy as np
import torch

from ..batching.buckets import bucket_for, pow2_buckets
from ..batching.engine import BatchParts, MicroBatcher
from ..device import DeviceLike, local_devices, local_world, resolve_device
from ..models import llama as llama_mod
from ..models.embedder import Embedder, EmbedderConfig, batch_tokenize, token_count
from ..serving.backend import LlamaServingBackend
from ..serving.engine import ServingEngine
from ..serving.tiering import StatebusColdTier
from .runtime import JobContext, Worker
from .training import TrainRunner, model_config


class HandlerError(Exception):
    pass


def _maybe_timer(timer, **attrs: str):
    """``ctx.device_timer`` when the caller passed one, else a no-op CM —
    GPUCompute stays usable outside a traced JobContext (bench, tests)."""
    if timer is not None:
        return timer("device", **attrs)
    return contextlib.nullcontext()


def matmul_chain(x: torch.Tensor, y: torch.Tensor, y_back: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """The ``matmul`` op's computation: ``acc = tanh((acc @ y) @ y_back)``
    ``iters`` times from ``x`` (the carry keeps its ``[b, n, k]`` shape),
    then ``acc @ y``."""
    acc = x
    for _ in range(iters):
        acc = torch.tanh((acc @ y) @ y_back)
    return acc @ y


# ---------------------------------------------------------------------------


class GPUCompute:
    """The device state shared by the op handlers of a worker: the
    counterpart of ``TPUCompute``.

    Holds the embedder and one copy of the Llama params (shared with the
    serving engine through :meth:`llama_params`).  Either set of params may
    be injected (``llama_params=``, ``embedder_params=``, e.g. from
    ``params_from_jax``); otherwise each is drawn from a torch generator
    seeded with ``seed`` on first use.  ``device=None`` is the current CUDA
    card and raises without one.

    The worker's local mesh: ``chips`` cards (default: every card the
    process sees; on the CPU, ``chips`` CPU "cards", one by default,
    :func:`~..device.local_world`) with ``tp`` the width of the
    reference's ``simple_mesh(tp)`` over them (``WORKER_TP``; a tp that
    does not divide the cards is 1, as the reference's).  As in the
    reference only the embedder uses it: the batch splits over ``dp =
    chips / tp`` replicas of its params, one a card.  ``infer``,
    ``matmul`` and serving run on ``device``, the first card, where the
    reference runs them unsharded; ``train`` jobs run over all ``chips``
    (:class:`.training.TrainRunner`)."""

    def __init__(
        self,
        *,
        embedder_cfg: Optional[EmbedderConfig] = None,
        llama_cfg: Optional[llama_mod.LlamaConfig] = None,
        seed: int = 0,
        device: DeviceLike = None,
        llama_params: Optional[llama_mod.Params] = None,
        embedder_params: Optional[dict] = None,
        ckpt_root: Optional[str] = None,
        tp: int = 1,
        chips: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.ckpt_root = ckpt_root
        self.chips = local_world(self.device, chips)
        width = min(max(1, tp), self.chips)
        self.tp = width if self.chips % width == 0 else 1
        self.embedder = Embedder(embedder_cfg, seed=seed, device=self.device,
                                 params=embedder_params,
                                 devices=local_devices(self.device, self.chips), tp=self.tp)
        self.llama_cfg = llama_cfg or llama_mod.LlamaConfig.tiny()
        self._llama_params = llama_params
        self._llama_lock = threading.Lock()
        self._batch_shapes: set[tuple] = set()  # compile_cached span attr
        self._seed = seed

    def _seen(self, shape: tuple) -> bool:
        """Whether ``shape`` ran before (the ``compile_cached`` span attr:
        the first call of a shape carries its set-up)."""
        seen = shape in self._batch_shapes
        self._batch_shapes.add(shape)
        return seen

    def trainer(self) -> TrainRunner:
        """A runner of ``train`` jobs over this worker's cards."""
        return TrainRunner(ckpt_root=self.ckpt_root, device=self.device, ranks=self.chips)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- matmul -----------------------------------------------------------
    def matmul(self, b: int, n: int, k: int, m: int, iters: int = 1, dtype: str = "bfloat16",
               timer=None):
        """The matmul chain on inputs drawn from a fresh generator seeded
        with ``seed`` (never one shared across executor threads)."""
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        compiled = self._seen(("matmul", b, n, k, m, iters, dtype))
        gen = torch.Generator(device=self.device).manual_seed(self._seed)

        def normal(shape):
            return torch.randn(shape, generator=gen, device=self.device).to(dt)

        x, y, y_back = normal((b, n, k)), normal((k, m)), normal((m, k))
        with _maybe_timer(timer, op="matmul", compile_cached=str(compiled).lower(),
                          items=str(b), bucket=f"{n}x{k}x{m}"):
            with torch.no_grad():
                out = matmul_chain(x, y, y_back, iters)
            self._sync()
        return {
            "shape": list(out.shape),
            "checksum": float(out.float().sum()),
            "flops": 2.0 * b * n * k * m * (2 * iters + 1),
        }

    # -- llama ------------------------------------------------------------
    def llama_params(self) -> llama_mod.Params:
        """The worker's one copy of the Llama params (the serving engine's
        ``params_provider``), initialised from ``seed`` on first use unless
        they were injected."""
        with self._llama_lock:
            if self._llama_params is None:
                gen = torch.Generator(device=self.device).manual_seed(self._seed)
                self._llama_params = llama_mod.init_params(
                    self.llama_cfg, generator=gen, device=self.device)
            return self._llama_params

    def _next_tokens(self, batch: np.ndarray, lens: np.ndarray) -> list[int]:
        """Greedy next token of each row, scored at ITS last real token
        (causal attention makes this invariant to right-padding, so per-job
        and micro-batched inference agree)."""
        params = self.llama_params()
        with torch.no_grad():
            tokens = torch.from_numpy(batch).to(self.device)
            logits = llama_mod.forward(params, tokens, self.llama_cfg)
            rows = torch.arange(len(batch), device=self.device)
            last = logits[rows, torch.from_numpy(lens - 1).to(self.device).long()]
            return torch.argmax(last, dim=-1).cpu().tolist()

    def infer(self, tokens: list[list[int]], max_len: Optional[int] = None, timer=None):
        cfg = self.llama_cfg
        t = max(len(r) for r in tokens)
        t = min(max_len or cfg.max_seq_len, max(t, 1))
        batch = np.zeros((len(tokens), t), np.int32)
        lens = np.ones((len(tokens),), np.int64)
        for i, row in enumerate(tokens):
            row = [min(x, cfg.vocab_size - 1) for x in row[:t]]
            batch[i, : len(row)] = row
            lens[i] = max(1, len(row))
        compiled = self._seen(("infer_job", len(tokens), t))
        with _maybe_timer(timer, op="infer", compile_cached=str(compiled).lower(),
                          items=str(len(tokens)), bucket=str(t)):
            next_tokens = self._next_tokens(batch, lens)
        return {"next_tokens": next_tokens, "seq_len": t}

    # -- micro-batch entry points -----------------------------------------
    def embed_batch(self, texts: list[str], *, seq_len: int = 0,
                    batch_buckets=None, timer=None):
        """One padded device call embedding many jobs' texts: sequence dim
        trimmed to the queue's length bucket, batch dim padded up to a
        power-of-two bucket, so the call shapes stay a small fixed set."""
        cfg = self.embedder.cfg
        ids, mask = batch_tokenize(texts, cfg, max_len=seq_len or cfg.max_len)
        b = len(texts)
        bpad = bucket_for(b, batch_buckets or pow2_buckets(1, 256))
        if bpad > b:
            ids = np.pad(ids, ((0, bpad - b), (0, 0)))
            mask = np.pad(mask, ((0, bpad - b), (0, 0)))
        compiled = self._seen(("embed", bpad, ids.shape[1]))
        with _maybe_timer(timer, op="embed_batch", compile_cached=str(compiled).lower(),
                          items=str(b), bucket=str(ids.shape[1])):
            out = self.embedder.embed_tokens(ids, mask)
        return out[:b]

    def infer_batch(self, rows: list[list[int]], *, seq_len: int = 0,
                    batch_buckets=None, timer=None):
        """One padded device call scoring many jobs' rows; each row's next
        token is gathered at its own last real position.  Returns
        (next_tokens, seq_len)."""
        cfg = self.llama_cfg
        t = min(max(1, seq_len or max((len(r) for r in rows), default=1)), cfg.max_seq_len)
        b = len(rows)
        bpad = bucket_for(b, batch_buckets or pow2_buckets(1, 256))
        batch = np.zeros((bpad, t), np.int32)
        lens = np.ones((bpad,), np.int64)
        for i, row in enumerate(rows):
            row = [min(x, cfg.vocab_size - 1) for x in row[:t]]
            batch[i, : len(row)] = row
            lens[i] = max(1, len(row))
        compiled = self._seen(("infer", bpad, t))
        with _maybe_timer(timer, op="infer_batch", compile_cached=str(compiled).lower(),
                          items=str(b), bucket=str(t)):
            next_tokens = self._next_tokens(batch, lens)[:b]
        return next_tokens, t


def make_gpu_handlers(compute: GPUCompute):
    """Build the op-dispatching default handler backed by ``compute``."""

    async def handler(ctx: JobContext) -> Any:
        payload = ctx.payload or {}
        if not isinstance(payload, dict):
            raise HandlerError(f"payload must be a JSON object, got {type(payload).__name__}")
        op = payload.get("op", "echo")
        ctx.check_cancelled()
        if op == "echo":
            return {"echo": payload, "worker": ctx.worker.worker_id}
        if op == "matmul":
            return await ctx.worker.run_in_executor(
                functools.partial(
                    compute.matmul,
                    int(payload.get("b", 8)),
                    int(payload.get("n", 512)),
                    int(payload.get("k", 512)),
                    int(payload.get("m", 512)),
                    int(payload.get("iters", 1)),
                    str(payload.get("dtype", "bfloat16")),
                    timer=ctx.device_timer,
                )
            )
        if op == "embed":
            texts = payload.get("texts")
            if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
                raise HandlerError("embed op requires texts: list[str]")

            def _embed():
                with ctx.device_timer("device", op="embed", items=str(len(texts))):
                    return compute.embedder.embed(texts)

            vecs = await ctx.worker.run_in_executor(_embed)
            return {"embeddings": np.asarray(vecs).tolist(), "dim": int(vecs.shape[1])}
        if op == "infer":
            tokens = payload.get("tokens")
            if not isinstance(tokens, list):
                raise HandlerError("infer op requires tokens: list[list[int]]")
            return await ctx.worker.run_in_executor(
                functools.partial(
                    compute.infer, tokens, payload.get("max_len"), timer=ctx.device_timer
                )
            )
        if op == "llm.generate":
            # serving jobs route through the worker's serving engine BEFORE
            # the handler path (runtime._on_job); landing here means the
            # engine is not attached or the payload shape is invalid
            if ctx.worker.serving is None:
                raise HandlerError(
                    "llm.generate requires the serving engine (attach it with serving=True)"
                )
            raise HandlerError(
                "llm.generate requires tokens: non-empty list[int] "
                "(plus optional session_id/max_new_tokens/eos_token/stream)"
            )
        if op == "train":
            try:  # an unknown family fails here, not on the executor
                model_config(str(payload.get("model", "llama-tiny")))
            except ValueError as e:
                raise HandlerError(f"train: {e}") from None
            # the runner's loop runs on the worker's executor (threads pinned
            # to the worker's device); progress goes back to the loop, and
            # the cancel event is read before each step
            loop = asyncio.get_running_loop()

            def report(frac: float, msg: str) -> None:
                asyncio.run_coroutine_threadsafe(ctx.progress(100 * frac, msg), loop)

            return await ctx.worker.run_in_executor(
                functools.partial(
                    compute.trainer().train, payload, cancelled=ctx.cancelled.is_set,
                    progress=report,
                )
            )
        raise HandlerError(f"unknown op {op!r}")

    return handler


def make_micro_batcher(
    compute: GPUCompute,
    worker: Worker,
    *,
    max_batch_rows: int = 32,
    max_wait_ms: float = 25.0,
    metrics=None,
):
    """Build the worker's micro-batcher over ``compute``'s batch entry
    points: payload decomposition (``parts_fn``) + the padded device flush.
    Invalid payload shapes decompose to None so they keep the per-job
    handler path and fail with the op's own pointed error."""
    ecfg = compute.embedder.cfg
    lcfg = compute.llama_cfg

    def parts_fn(payload) -> "BatchParts | None":
        if not isinstance(payload, dict):
            return None
        op = payload.get("op")
        if op == "embed":
            texts = payload.get("texts")
            if isinstance(texts, list) and texts and all(isinstance(t, str) for t in texts):
                return BatchParts(
                    "embed", texts, len(texts),
                    max(token_count(t, ecfg) for t in texts),
                )
        elif op == "infer":
            tokens = payload.get("tokens")
            if payload.get("max_len"):
                return None  # explicit padding request: keep per-job semantics
            if (
                isinstance(tokens, list) and tokens
                and all(isinstance(r, list) and r
                        and all(isinstance(x, int) for x in r) for r in tokens)
            ):
                length = min(max(len(r) for r in tokens), lcfg.max_seq_len)
                return BatchParts("infer", tokens, len(tokens), length)
        return None

    async def flush_fn(op, bucket, items):
        if op == "embed":
            texts = [t for it in items for t in it.rows]

            def run_embed():
                return compute.embed_batch(texts, seq_len=bucket)

            t0 = time.perf_counter()
            vecs = await worker.run_in_executor(run_embed)
            # one flush = one coalesced device call delivering len(texts)
            # items at this length bucket — the capacity matrix's
            # batched-embed row
            worker.capacity.observe(
                "embed", device_s=time.perf_counter() - t0,
                bucket=str(bucket), items=len(texts),
            )
            out, i = [], 0
            for it in items:
                out.append({
                    "embeddings": np.asarray(vecs[i:i + it.n_rows]).tolist(),
                    "dim": int(vecs.shape[1]),
                    "batched": True,
                })
                i += it.n_rows
            return out
        if op == "infer":
            rows = [r for it in items for r in it.rows]

            def run_infer():
                return compute.infer_batch(rows, seq_len=bucket)

            t0 = time.perf_counter()
            toks, t = await worker.run_in_executor(run_infer)
            worker.capacity.observe(
                "infer", device_s=time.perf_counter() - t0,
                bucket=str(bucket), items=len(rows),
            )
            out, i = [], 0
            for it in items:
                out.append({
                    "next_tokens": toks[i:i + it.n_rows],
                    "seq_len": t,
                    "batched": True,
                })
                i += it.n_rows
            return out
        raise HandlerError(f"unbatchable op {op!r}")

    seq_cap = max(ecfg.max_len, min(lcfg.max_seq_len, 512))
    return MicroBatcher(
        flush_fn,
        parts_fn=parts_fn,
        max_batch_rows=max_batch_rows,
        max_wait_ms=max_wait_ms,
        len_buckets=pow2_buckets(16, seq_cap),
        metrics=metrics,
        tracer=worker.tracer,
    )


async def _run_in_default_executor(fn: Callable[..., Any], *args: Any) -> Any:
    """Blocking device calls go to the event loop's thread-pool executor."""
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def make_serving_engine(
    compute_or_cfg: Any,
    worker_or_params: Any,
    *,
    run_blocking: Optional[Callable[..., Awaitable[Any]]] = None,
    device: DeviceLike = None,
    cache_pages: int = 128,
    page_size: int = 16,
    max_sessions: int = 8,
    max_new_tokens: int = 64,
    max_concurrent_prefills: int = 2,
    prefill_budget: int = 16,
    handoff_tokens: int = 0,
    prefix_cache: bool = True,
    hibernate_after_s: float = 0.0,
    speculative: bool = True,
    draft_k: int = 0,
    cold_tier: str = "",
    metrics: Any = None,
) -> ServingEngine:
    """Build a continuous-batching serving engine over a paged Llama
    backend, in one of two forms:

    * ``make_serving_engine(compute, worker)`` — the worker's engine, as
      the reference builds it: the backend shares ``compute``'s one copy of
      the Llama params (:meth:`GPUCompute.llama_params`), blocking device
      calls run in the worker's executor, spans and capacity go to the
      worker's tracer and profiler, on ``compute``'s device;
    * ``make_serving_engine(llama_cfg, params)`` — the bare engine over the
      given weights (already on ``device``); ``run_blocking=None`` sends
      device calls to the event loop's default executor, and
      ``device=None`` is the current CUDA card and raises without one.

    The backend's static ragged-step shapes are sized here: ``max_sessions``
    sequence rows over a flat token buffer of ``max_sessions +
    prefill_budget`` slots, so a full decode set always fits and prefill
    chunks ride the remaining ``prefill_budget`` tokens per step.
    ``cold_tier="statebus"`` (the worker form only) journals hibernated
    sessions through the worker's store KV (:class:`StatebusColdTier`);
    the worker binary awaits its ``load()`` after ``start()``."""
    tracer = capacity = None
    if isinstance(compute_or_cfg, GPUCompute):
        compute, worker = compute_or_cfg, worker_or_params
        llama_cfg, params_provider = compute.llama_cfg, compute.llama_params
        run_blocking, device = worker.run_in_executor, compute.device
        tracer, capacity = worker.tracer, worker.capacity
    else:
        llama_cfg, params = compute_or_cfg, worker_or_params
        params_provider = lambda: params  # noqa: E731
    backend = LlamaServingBackend(
        llama_cfg,
        num_pages=cache_pages,
        page_size=page_size,
        max_seqs=max_sessions,
        max_batch_tokens=max_sessions + max(1, prefill_budget),
        params_provider=params_provider,
        metrics=metrics,
        device=device,
    )
    engine = ServingEngine(
        backend,
        run_blocking=run_blocking or _run_in_default_executor,
        max_sessions=max_sessions,
        max_new_tokens_cap=max_new_tokens,
        max_concurrent_prefills=max_concurrent_prefills,
        handoff_threshold_tokens=handoff_tokens,
        prefix_cache=prefix_cache,
        hibernate_after_s=hibernate_after_s,
        speculative=speculative,
        # draft_k == 0 means "engine default" so config files can omit it
        **({"draft_k": draft_k} if draft_k > 0 else {}),
        metrics=metrics,
        tracer=tracer,
        capacity=capacity,
    )
    if cold_tier == "statebus" and engine.tiering is not None:
        if tracer is None:
            raise ValueError("cold_tier='statebus' needs the worker form "
                             "make_serving_engine(compute, worker)")
        engine.tiering.arena = StatebusColdTier(
            worker_or_params.store.kv, worker_id=worker_or_params.worker_id)
    return engine


def attach_default_gpu_worker(
    worker: Worker,
    *,
    batching: bool = True,
    max_batch_rows: int = 32,
    max_batch_wait_ms: float = 25.0,
    serving: bool = True,
    serving_cache_pages: int = 128,
    serving_page_size: int = 16,
    serving_max_sessions: int = 8,
    serving_max_new_tokens: int = 64,
    serving_prefill_budget: int = 16,
    serving_handoff_tokens: int = 0,
    serving_prefix_cache: bool = True,
    serving_hibernate_after_s: float = 0.0,
    serving_speculative: bool = True,
    serving_draft_k: int = 0,
    serving_cold_tier: str = "",
    gang: bool = True,
    gang_rendezvous_timeout_s: float = 10.0,
    gang_peer_timeout_s: float = 30.0,
    gang_addr: str = "",
    metrics=None,
    **kw,
) -> GPUCompute:
    """Wire the standard op handlers (and, by default, the micro-batcher
    over the batchable ops, the llm.generate serving engine and the gang
    runner for gang member jobs, advertising ``gang_addr`` for a serving
    gang's rendezvous store when set) onto a worker, on the worker's
    device.  ``kw`` goes to :class:`GPUCompute` (configs, ``seed``, injected
    params)."""
    compute = GPUCompute(device=worker.device, chips=worker.chips, **kw)
    worker.register_default(make_gpu_handlers(compute))
    if batching:
        worker.attach_batcher(make_micro_batcher(
            compute, worker,
            max_batch_rows=max_batch_rows, max_wait_ms=max_batch_wait_ms,
            metrics=metrics,
        ))
    if serving:
        worker.attach_serving(make_serving_engine(
            compute, worker,
            cache_pages=serving_cache_pages, page_size=serving_page_size,
            max_sessions=serving_max_sessions,
            max_new_tokens=serving_max_new_tokens,
            prefill_budget=serving_prefill_budget,
            handoff_tokens=serving_handoff_tokens,
            prefix_cache=serving_prefix_cache,
            hibernate_after_s=serving_hibernate_after_s,
            speculative=serving_speculative,
            draft_k=serving_draft_k,
            cold_tier=serving_cold_tier,
            metrics=metrics,
        ))
    if gang:
        from .gang import GangRunner

        worker.attach_gang(GangRunner(
            worker,
            trainer=compute.trainer(),
            rendezvous_timeout_s=gang_rendezvous_timeout_s,
            peer_timeout_s=gang_peer_timeout_s,
            store_host=gang_addr,
        ), metrics=metrics)
    return compute
