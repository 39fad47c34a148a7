"""GPU worker binary: ``python -m cordum_tpu_torch.cmd.worker``, the port's
counterpart of ``python -m cordum_tpu.cmd.worker``: a worker that owns the
CUDA cards it sees and takes jobs from the control plane over the statebus
(``CORDUM_STATEBUS_URL``: its KV holds the job payloads and results, its
bus carries dispatches, results, heartbeats and telemetry).

It serves what the reference binary serves: ``LlamaConfig.tiny()`` for
``infer`` and ``llm.generate`` (``WORKER_LLAMA_DTYPE`` = float32 | bfloat16
overrides its dtype) and the default ``EmbedderConfig()`` for ``embed``,
with weights drawn from a seeded generator on the card.  It runs on the
current CUDA card and raises without one; ``CORDUM_FORCE_CPU=1`` runs it on
the CPU instead (the tests do).  It owns every card the process sees
(``CUDA_VISIBLE_DEVICES`` limits them): ``infer``, ``matmul`` and serving
run on the first, ``train`` jobs over all of them (one rank process a
card), and the embedder over WORKER_TP, the width of the reference's local
``simple_mesh(tp)``: the batch splits over ``cards / tp`` replicas of its
weights, one a card (a tp that does not divide the cards is 1).  The
heartbeat's ``chip_count`` is the number of cards.

Env, as the reference reads it: WORKER_ID, WORKER_POOL, WORKER_TOPICS
(comma), WORKER_CAPABILITIES, WORKER_MAX_PARALLEL, WORKER_HEARTBEAT_INTERVAL,
WORKER_REGION; micro-batching WORKER_BATCHING (0 disables),
WORKER_MAX_BATCH_SIZE, WORKER_BATCH_WAIT_MS; serving WORKER_SERVING (0
disables), WORKER_SERVING_CACHE_PAGES, _PAGE_SIZE, _MAX_SESSIONS,
_MAX_NEW_TOKENS, _PREFILL_BUDGET, _ROLE, _HANDOFF_TOKENS, _PREFIX_CACHE,
_HIBERNATE_AFTER, _SPECULATIVE, _DRAFT_K, _COLD_TIER (statebus journals
hibernated sessions through the statebus KV and restores them at boot).
Each limit falls back to the worker's pool stanza in the pools file
(POOL_CONFIG_PATH), then to the built-in default; an unreadable pools file
warns and uses the defaults.

SIGTERM drains (unless WORKER_DRAIN_ON_TERM=0): stop admitting, hand
serving sessions to peers or back to the scheduler, finish per-job work
(WORKER_DRAIN_TIMEOUT, default 30 s), then exit; SIGINT stops at once.
The last log line, ``worker stopped``, gives ``cancelled_sessions``, the
serving steps and each hand-written kernel's launches in this process.

Gang members (WORKER_GANG, on unless ``0``): jobs carrying the scheduler's
gang labels run on the gang runner (``worker/gang.py``) — the barrier, the
SPMD train leg, MPMD pipeline gangs and tensor-parallel serving gangs over
a ``torch.distributed`` group; WORKER_GANG_RENDEZVOUS_TIMEOUT (default 10 s)
bounds the barrier and WORKER_GANG_PEER_TIMEOUT (default 30 s) the rank
group's join, every collective and every wait for a peer's stage tensor.
WORKER_GANG_ADDR is the address this worker advertises for the rendezvous
store when it leads a serving gang (default ``127.0.0.1``: the gang's
members share a host); set it to an address the other members can route
to when they live on other hosts.  The store listens on every interface.
NCCL and gloo pick their own interface for the group's traffic, from
NCCL_SOCKET_IFNAME and GLOO_SOCKET_IFNAME, which torch reads itself; this
worker sets neither.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import signal

import torch

from ..device import resolve_device
from ..infra import logging as logx
from ..infra.memstore import MemoryStore
from ..infra.metrics import Metrics
from ..models import llama
from ..obs.profiler import RuntimeProfiler
from ..obs.telemetry import TelemetryExporter
from ..worker.handlers import attach_default_gpu_worker
from ..worker.runtime import Worker
from . import _boot


def _gang_options(env) -> dict:
    """``attach_default_gpu_worker``'s gang keywords: the runner on unless
    WORKER_GANG is ``0``, its two timeouts and the store address it
    advertises (WORKER_GANG_ADDR; empty: ``127.0.0.1``)."""
    return {
        "gang": env.get("WORKER_GANG", "1") != "0",
        "gang_rendezvous_timeout_s": _boot.env_float("WORKER_GANG_RENDEZVOUS_TIMEOUT", 10.0),
        "gang_peer_timeout_s": _boot.env_float("WORKER_GANG_PEER_TIMEOUT", 30.0),
        "gang_addr": env.get("WORKER_GANG_ADDR", "").strip(),
    }


def _device() -> str | None:
    """``cpu`` under CORDUM_FORCE_CPU=1, else None: the current CUDA card
    (the worker raises when there is none)."""
    return "cpu" if os.environ.get("CORDUM_FORCE_CPU") == "1" else None


def _pool_limits(cfg, pool_name: str):
    """This worker's pool stanza from the pools file (None = defaults).
    A missing or invalid pool file must not stop a worker from booting."""
    try:
        from ..infra.config import load_pool_config

        return load_pool_config(cfg.pool_config_path).pools.get(pool_name)
    except Exception as e:  # noqa: BLE001 - batching/serving config is best-effort
        logx.warn("pool config unreadable; using built-in worker defaults",
                  path=cfg.pool_config_path, err=str(e))
        return None


def _llama_cfg(env) -> llama.LlamaConfig:
    cfg = llama.LlamaConfig.tiny()
    name = env.get("WORKER_LLAMA_DTYPE", "")
    if name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, name))
    return cfg


async def main() -> None:
    env = os.environ
    cfg = _boot.setup()
    device = resolve_device(_device())  # raises here, before any connection, without a card
    kv, bus, conn = await _boot.connect_statebus(cfg)
    pool_name = env.get("WORKER_POOL", "gpu-default")
    pool = _pool_limits(cfg, pool_name)
    worker = Worker(
        bus=bus,
        store=MemoryStore(kv),
        worker_id=env.get("WORKER_ID", f"gpu-worker-{os.getpid()}"),
        pool=pool_name,
        topics=[t for t in env.get("WORKER_TOPICS", "job.gpu.>").split(",") if t],
        capabilities=[c for c in env.get("WORKER_CAPABILITIES", "gpu,echo").split(",") if c],
        max_parallel_jobs=_boot.env_int("WORKER_MAX_PARALLEL", 4),
        heartbeat_interval_s=_boot.env_float("WORKER_HEARTBEAT_INTERVAL", 10.0),
        region=env.get("WORKER_REGION", ""),
        serving_role=env.get("WORKER_SERVING_ROLE", "")
        or (pool.serving_role if pool else "") or "mixed",
        device=device,
    )
    # one registry shared by the batcher, the serving engine and the fleet
    # telemetry exporter, so worker-side metrics reach the aggregator
    metrics = Metrics()
    compute = attach_default_gpu_worker(
        worker,
        metrics=metrics,
        llama_cfg=_llama_cfg(env),
        tp=_boot.env_int("WORKER_TP", 1),
        batching=env.get("WORKER_BATCHING", "1") != "0",
        max_batch_rows=_boot.env_int("WORKER_MAX_BATCH_SIZE", 0)
        or (pool.max_batch_size if pool else 0) or 32,
        max_batch_wait_ms=_boot.env_float("WORKER_BATCH_WAIT_MS", 0.0)
        or (pool.max_batch_wait_ms if pool else 0.0) or 25.0,
        serving=env.get("WORKER_SERVING", "1") != "0",
        serving_cache_pages=_boot.env_int("WORKER_SERVING_CACHE_PAGES", 0)
        or (pool.serving_cache_pages if pool else 0) or 128,
        serving_page_size=_boot.env_int("WORKER_SERVING_PAGE_SIZE", 0)
        or (pool.serving_page_size if pool else 0) or 16,
        serving_max_sessions=_boot.env_int("WORKER_SERVING_MAX_SESSIONS", 0)
        or (pool.serving_max_sessions if pool else 0) or 8,
        serving_max_new_tokens=_boot.env_int("WORKER_SERVING_MAX_NEW_TOKENS", 0)
        or (pool.serving_max_new_tokens if pool else 0) or 64,
        serving_prefill_budget=_boot.env_int("WORKER_SERVING_PREFILL_BUDGET", 0)
        or (pool.serving_prefill_budget if pool else 0) or 16,
        serving_handoff_tokens=_boot.env_int("WORKER_SERVING_HANDOFF_TOKENS", 0)
        or (pool.serving_handoff_tokens if pool else 0),
        serving_prefix_cache=(
            env["WORKER_SERVING_PREFIX_CACHE"] != "0"
            if "WORKER_SERVING_PREFIX_CACHE" in env
            else (pool.serving_prefix_cache if pool else True)
        ),
        serving_hibernate_after_s=_boot.env_float("WORKER_SERVING_HIBERNATE_AFTER", 0.0)
        or (pool.serving_hibernate_after_s if pool else 0.0),
        serving_speculative=(
            env["WORKER_SERVING_SPECULATIVE"] != "0"
            if "WORKER_SERVING_SPECULATIVE" in env
            else (pool.serving_speculative if pool else True)
        ),
        serving_draft_k=_boot.env_int("WORKER_SERVING_DRAFT_K", 0)
        or (pool.serving_draft_k if pool else 0),
        serving_cold_tier=env.get("WORKER_SERVING_COLD_TIER", "")
        or (pool.serving_cold_tier if pool else ""),
        **_gang_options(env),
    )
    profiler = RuntimeProfiler(metrics, service="worker")
    telemetry = TelemetryExporter(
        "worker", bus, metrics, instance_id=worker.worker_id,
        health_fn=lambda: {**worker.telemetry_health(), **profiler.health()},
    )
    await worker.start()
    # statebus-backed cold tier: re-populate the mirror from the journal so
    # sessions hibernated before a restart are restorable here
    tiering = getattr(worker.serving, "tiering", None)
    arena = getattr(tiering, "arena", None)
    if callable(getattr(arena, "load", None)):
        await arena.load()
    await telemetry.start()
    await profiler.start()
    logx.info("worker ready", worker_id=worker.worker_id, device=str(worker.device),
              chips=worker.chips, tp=compute.tp,
              llama_dtype=str(compute.llama_cfg.dtype).split(".")[-1])
    stop = asyncio.Event()
    drain_timeout = _boot.env_float("WORKER_DRAIN_TIMEOUT", 30.0)

    def _on_term() -> None:
        if env.get("WORKER_DRAIN_ON_TERM", "1") != "0":
            asyncio.ensure_future(worker.drain(timeout_s=drain_timeout))
        else:
            stop.set()

    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, _on_term)
        loop.add_signal_handler(signal.SIGINT, stop.set)
    except NotImplementedError:  # pragma: no cover - non-unix
        pass
    try:
        stop_w = asyncio.ensure_future(stop.wait())
        drained_w = asyncio.ensure_future(worker.wait_drained())
        _, pending = await asyncio.wait({stop_w, drained_w}, return_when=asyncio.FIRST_COMPLETED)
        for t in pending:
            t.cancel()
    finally:
        await profiler.stop()
        await telemetry.stop()
        await worker.stop()
        await conn.close()
        serving = worker.serving
        logx.info("worker stopped", worker_id=worker.worker_id, drained=worker.draining,
                  cancelled_sessions=serving.stats.cancelled if serving is not None else 0,
                  serving_steps=serving.stats.steps if serving is not None else 0,
                  kernel_launches=_kernel_launches())


def _kernel_launches() -> dict:
    """How often this process launched each hand-written kernel (the
    wrappers' counts; the CPU runs their plain versions and counts none)."""
    from ..ops import dense_attention, embed_attention, paged_attention

    return {"paged_attention": paged_attention.paged_attention.launches,
            "embed_attention": embed_attention.embed_attention.launches,
            "dense_attention_fwd": dense_attention.dense_attention_fwd.launches,
            "dense_attention_bwd": dense_attention.dense_attention_bwd.launches}


if __name__ == "__main__":
    asyncio.run(main())
