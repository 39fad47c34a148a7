"""Scheduler service binary (reference ``cmd/cordum-scheduler/main.go:24-179``):
statebus connection → job store → safety client (remote kernel or embedded)
→ pool config + overlay bootstrap/watch → engine + reconciler + pending
replayer + worker-snapshot writer → shutdown on signal.

Keyspace sharding: run N copies with ``--shard-index i --shard-count n``
(or SCHEDULER_SHARD_INDEX / SCHEDULER_SHARD_COUNT, or ``scheduler.shards``
in pools.yaml for the count); shard i owns every job whose
``partition_of(job_id, n) == i`` and consumes ``sys.job.submit.<i>`` /
``result.<i>`` / ``cancel.<i>`` with no cross-shard locks."""
from __future__ import annotations

import argparse
import asyncio
import os

import yaml

from ..controlplane.safetykernel.kernel import SafetyKernel
from ..controlplane.safetykernel.service import remote_check
from ..controlplane.scheduler.engine import Engine
from ..controlplane.scheduler.overlay import ConfigOverlay, WorkerSnapshotWriter
from ..controlplane.scheduler.reconciler import (
    PendingReplayer,
    Reconciler,
    WorkerFailover,
)
from ..controlplane.scheduler.safety_client import SafetyClient
from ..controlplane.scheduler.strategy import (
    LeastLoadedStrategy,
    ThroughputAwareStrategy,
)
from ..infra import logging as logx
from ..infra.configsvc import ConfigService
from ..infra.jobstore import JobStore
from ..infra.metrics import Metrics
from ..infra.registry import WorkerRegistry
from ..infra.config import load_pool_config, load_timeouts
from . import _boot


def _shard_args() -> tuple[int, int]:
    """CLI flags > env vars > pools.yaml ``scheduler.shards`` (count only)."""
    ap = argparse.ArgumentParser(description="cordum scheduler shard")
    ap.add_argument("--shard-index", type=int,
                    default=_boot.env_int("SCHEDULER_SHARD_INDEX", 0))
    ap.add_argument("--shard-count", type=int,
                    default=_boot.env_int("SCHEDULER_SHARD_COUNT", 0))
    ns, _ = ap.parse_known_args()
    return ns.shard_index, ns.shard_count


async def main() -> None:
    cfg = _boot.setup()
    shard_index, shard_count = _shard_args()
    kv, bus, conn = await _boot.connect_statebus(cfg)
    job_store = JobStore(kv)
    configsvc = ConfigService(kv)
    # SCHEDULER_REGISTRY_TTL bounds dead-worker detection: a worker whose
    # heartbeats stop for this long is expired and its in-flight jobs fail
    # over (WorkerFailover)
    registry = WorkerRegistry(
        ttl_s=_boot.env_float("SCHEDULER_REGISTRY_TTL", 30.0)
    )

    pool_cfg = load_pool_config(cfg.pool_config_path)
    timeouts = load_timeouts(cfg.timeout_config_path)
    # one registry shared by strategy (session-affinity counters) and engine
    metrics = Metrics()
    # capacity-aware routing (docs/ADMISSION.md §Routing) is the default:
    # the strategy consumes the workers' capacity beacons and degrades to
    # exact LeastLoaded behavior while the matrix is cold/stale.
    # SCHEDULER_STRATEGY=least_loaded opts out.
    capacity_view = None
    rebalancer = None
    if os.environ.get("SCHEDULER_STRATEGY", "throughput") == "least_loaded":
        strategy = LeastLoadedStrategy(registry, pool_cfg, metrics=metrics)
    else:
        from ..controlplane.scheduler.placer import (
            DecodeRebalancer,
            ServingPlacer,
        )
        from ..obs.capacity import CapacityView

        capacity_view = CapacityView()
        # disaggregated serving placement (docs/SERVING.md §Disaggregation):
        # new llm.generate sessions route by measured prefill tokens/s
        # headroom; the decode rebalancer migrates sessions off skewed
        # workers (SCHEDULER_REBALANCER=0 / rebalancer.enabled opt out)
        strategy = ThroughputAwareStrategy(
            registry, pool_cfg, capacity=capacity_view,
            placer=ServingPlacer(capacity_view, metrics=metrics),
            metrics=metrics,
        )
        if os.environ.get("SCHEDULER_REBALANCER", "1") != "0":
            rebalancer = DecodeRebalancer.from_config(
                bus, capacity_view, registry, pool_cfg.rebalancer,
                metrics=metrics,
            )
    if shard_count <= 0:  # flag/env unset: pools.yaml scheduler.shards
        shard_count = pool_cfg.scheduler_shards

    kernel_addr = cfg.safety_kernel_addr
    if kernel_addr:
        # remote kernel: span context rides the RPC headers; the kernel
        # service emits its own evaluate spans
        check_fn = remote_check(kernel_addr)
    else:  # embedded kernel (single-binary deployments)
        from ..obs.tracer import Tracer

        kernel = SafetyKernel(policy_path=cfg.safety_policy_path, configsvc=configsvc,
                              tracer=Tracer("safety-kernel", bus))
        await kernel.reload()
        check_fn = kernel.check
    safety = SafetyClient(check_fn)

    engine = Engine(
        bus=bus, job_store=job_store, safety=safety, strategy=strategy,
        registry=registry, configsvc=configsvc, metrics=metrics,
        instance_id=os.environ.get(
            "SCHEDULER_ID",
            f"scheduler-{shard_index}" if shard_count > 1 else "scheduler-0",
        ),
        tenant_concurrency_limit=_boot.env_int("TENANT_CONCURRENCY_LIMIT", 0),
        shard_index=shard_index,
        shard_count=max(1, shard_count),
    )
    # gang scheduling (docs/GANG.md): all-or-nothing multi-worker placement
    # for jobs carrying the gateway-stamped cordum.gang_workers label;
    # SCHEDULER_GANG=0 / gang.enabled opts out
    gangs = None
    gang_cfg = pool_cfg.gang
    if (
        os.environ.get("SCHEDULER_GANG", "1") != "0"
        and gang_cfg.get("enabled", True)
    ):
        from ..controlplane.scheduler.gang import GangScheduler

        gangs = GangScheduler(
            engine, pool_cfg,
            rendezvous_timeout_s=float(
                gang_cfg.get("rendezvous_timeout_s", 10.0)),
            queued_timeout_s=float(gang_cfg.get("queued_timeout_s", 300.0)),
        )
    reconciler = Reconciler(job_store, timeouts, instance_id=engine.instance_id)
    replayer = PendingReplayer(engine, job_store, timeouts)
    # serving-session crash failover: dead workers' in-flight jobs are
    # re-dispatched (with the streamed-token resume prefix) instead of
    # waiting out the running timeout (docs/SERVING.md)
    failover = WorkerFailover(engine, job_store, registry, timeouts)

    # fleet telemetry plane (docs/OBSERVABILITY.md §Fleet telemetry): this
    # shard's registry + a health beacon carrying its shard coordinates and
    # live queue depth, plus the runtime profiler feeding loop/GC health
    # into the same registry
    from ..obs.profiler import RuntimeProfiler
    from ..obs.telemetry import TelemetryExporter

    profiler = RuntimeProfiler(metrics, service="scheduler")

    def _telemetry_health() -> dict:
        out = {
            "role": "scheduler",
            "shard_index": engine.shard_index,
            "shard_count": engine.shard_count,
            "queue_depth": engine._inflight,
            "jobs_scheduled": metrics.jobs_dispatched.total(),
            "workers_live": len(registry.snapshot()),
            **profiler.health(),
        }
        if gangs is not None:
            # live gang table (docs/GANG.md): merged fleet-wide by the
            # gateway aggregator into GET /api/v1/gangs
            out["gangs"] = gangs.doc()
            out["gang_queue_depth"] = len(gangs._fifo)
        return out

    telemetry = TelemetryExporter(
        "scheduler", bus, metrics,
        instance_id=engine.instance_id, health_fn=_telemetry_health,
    )
    overlay = ConfigOverlay(
        configsvc, strategy, reconciler,
        interval_s=_boot.env_float("SCHEDULER_CONFIG_RELOAD_INTERVAL", 30.0),
    )
    snapshotter = WorkerSnapshotWriter(kv, registry)

    def _load_yaml(path: str) -> dict:
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return yaml.safe_load(f) or {}

    # config reads happen off the event loop (CL003): startup shares the
    # loop with the bus connection heartbeats
    pools_doc = await asyncio.to_thread(_load_yaml, cfg.pool_config_path)
    timeouts_doc = await asyncio.to_thread(_load_yaml, cfg.timeout_config_path)
    await overlay.bootstrap(pools_doc, timeouts_doc)

    if capacity_view is not None:
        await capacity_view.start(bus)

    # session ownership announcements (docs/SERVING.md §Disaggregation):
    # a migration commit retargets the session's affinity entry so
    # follow-up turns/cancels route to the new page-holding worker
    from ..protocol import subjects as subj

    async def _on_session_moved(subject: str, pkt) -> None:
        mv = pkt.session_moved
        if mv is not None and mv.session_key:
            # reason="hibernated": the session's KV went to the worker's
            # host-RAM cold arena — pin its affinity past the normal TTL so
            # the next turn routes back to the only copy; "restored" (and
            # every migration reason) retargets normally, which unpins
            strategy.retarget_session(
                mv.session_key, mv.to_worker,
                pinned=(mv.reason == "hibernated"),
            )

    moved_sub = await bus.subscribe(subj.SERVING_MOVED, _on_session_moved)
    await engine.start()
    if gangs is not None:
        await gangs.start()
    await reconciler.start()
    await replayer.start()
    await failover.start()
    await overlay.start()
    await snapshotter.start()
    await telemetry.start()
    await profiler.start()
    if rebalancer is not None:
        await rebalancer.start()
    logx.info("scheduler running", instance=engine.instance_id,
              shard=engine.shard_index, shards=engine.shard_count)
    try:
        await _boot.wait_for_shutdown()
    finally:
        if rebalancer is not None:
            await rebalancer.stop()
        moved_sub.unsubscribe()
        if gangs is not None:
            await gangs.stop()
        await profiler.stop()
        await telemetry.stop()
        await snapshotter.stop()
        await overlay.stop()
        await failover.stop()
        await replayer.stop()
        await reconciler.stop()
        await engine.stop()
        if capacity_view is not None:
            await capacity_view.stop()
        await conn.close()


if __name__ == "__main__":
    asyncio.run(main())
