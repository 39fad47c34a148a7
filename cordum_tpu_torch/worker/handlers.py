"""Worker-side wiring of the serving path: the PyTorch counterpart of
``make_serving_engine`` in ``cordum_tpu/worker/handlers.py``.

:func:`make_serving_engine` is the entry point of this package's serving
slice: it builds the continuous-batching :class:`ServingEngine` over a
paged :class:`LlamaServingBackend` that serves the given weights, and
callers submit :class:`GenRequest` s to it.
"""
from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, Optional

from ..device import DeviceLike
from ..models.llama import LlamaConfig, Params
from ..serving.backend import LlamaServingBackend
from ..serving.engine import ServingEngine


async def _run_in_default_executor(fn: Callable[..., Any], *args: Any) -> Any:
    """Blocking device calls go to the event loop's thread-pool executor."""
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def make_serving_engine(
    llama_cfg: LlamaConfig,
    params: Params,
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
    metrics: Any = None,
) -> ServingEngine:
    """Build a continuous-batching serving engine over a paged Llama
    backend that serves ``params`` (already on ``device``; one copy of the
    weights per process — the KV page arena is the serving addition).

    The backend's static ragged-step shapes are sized here: ``max_sessions``
    sequence rows over a flat token buffer of ``max_sessions +
    prefill_budget`` slots, so a full decode set always fits and prefill
    chunks ride the remaining ``prefill_budget`` tokens per step.
    ``run_blocking`` runs the blocking device calls; ``None`` sends them
    to the event loop's thread-pool executor.  ``device=None`` is the
    current CUDA card and raises without one."""
    backend = LlamaServingBackend(
        llama_cfg,
        num_pages=cache_pages,
        page_size=page_size,
        max_seqs=max_sessions,
        max_batch_tokens=max_sessions + max(1, prefill_budget),
        params_provider=lambda: params,
        metrics=metrics,
        device=device,
    )
    return ServingEngine(
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
    )
