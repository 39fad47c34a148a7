"""Workflow-engine service binary (reference ``cmd/cordum-workflow-engine``)."""
from __future__ import annotations

import asyncio
import os

from ..context.service import BusEmbedder, ContextService
from ..controlplane.workflowengine.service import WorkflowEngineService
from ..infra.configsvc import ConfigService
from ..infra.jobstore import JobStore
from ..infra.memstore import MemoryStore
from ..infra.schemareg import SchemaRegistry
from ..workflow.engine import Engine as WorkflowEngine
from ..workflow.store import WorkflowStore
from . import _boot


async def main() -> None:
    cfg = _boot.setup()
    kv, bus, conn = await _boot.connect_statebus(cfg)
    from ..infra.metrics import Metrics

    mem = MemoryStore(kv)
    # ONE Metrics registry shared between engine and telemetry exporter, so
    # the cordum_workflow_* families actually reach the fleet plane
    metrics = Metrics()
    engine = WorkflowEngine(
        store=WorkflowStore(kv), bus=bus, mem=mem,
        schemas=SchemaRegistry(kv), configsvc=ConfigService(kv),
        metrics=metrics,
        instance_id=os.environ.get("WF_ENGINE_ID", "wf-engine-0"),
        context_svc=ContextService(kv, embedder=BusEmbedder(bus, mem)),
    )
    svc = WorkflowEngineService(
        engine=engine, bus=bus, job_store=JobStore(kv),
        instance_id=os.environ.get("WF_ENGINE_ID", "wf-engine-0"),
        reconcile_interval_s=_boot.env_float("WF_RECONCILE_INTERVAL", 5.0),
    )
    from ..obs.profiler import RuntimeProfiler
    from ..obs.telemetry import TelemetryExporter

    profiler = RuntimeProfiler(metrics, service="workflow-engine")
    telemetry = TelemetryExporter(
        "workflow-engine", bus, metrics,
        instance_id=os.environ.get("WF_ENGINE_ID", "wf-engine-0"),
        health_fn=lambda: {"role": "workflow-engine", **profiler.health()},
    )
    await svc.start()
    await telemetry.start()
    await profiler.start()
    try:
        await _boot.wait_for_shutdown()
    finally:
        await profiler.stop()
        await telemetry.stop()
        await svc.stop()
        await conn.close()


if __name__ == "__main__":
    asyncio.run(main())
