"""API-gateway service binary (reference ``cmd/cordum-api-gateway``).

Runs the HTTP/WS surface against the statebus; the workflow engine is
embedded (the gateway is a second consumer of results in the reference too,
gateway.go:610-651), the safety kernel is embedded or remote."""
from __future__ import annotations

import asyncio
import os

from ..context.service import BusEmbedder, ContextService
from ..controlplane.gateway.app import Gateway
from ..controlplane.gateway.auth import BasicAuthProvider
from ..controlplane.safetykernel.kernel import SafetyKernel
from ..infra.configsvc import ConfigService
from ..infra.jobstore import JobStore
from ..infra.memstore import MemoryStore
from ..infra.registry import WorkerRegistry
from ..infra.schemareg import SchemaRegistry
from ..workflow.engine import Engine as WorkflowEngine
from ..workflow.store import WorkflowStore
from . import _boot


async def main() -> None:
    cfg = _boot.setup()
    kv, bus, conn = await _boot.connect_statebus(cfg)
    configsvc = ConfigService(kv)
    kernel = SafetyKernel(policy_path=cfg.safety_policy_path, configsvc=configsvc)
    await kernel.reload()
    schemas = SchemaRegistry(kv)
    mem = MemoryStore(kv)
    wf_store = WorkflowStore(kv)
    # context.* workflow steps run in-engine; their embeds ride the worker
    # pool as micro-batched embed jobs (BusEmbedder, docs/WORKFLOWS.md)
    context_svc = ContextService(kv, embedder=BusEmbedder(bus, mem))
    from ..infra.metrics import Metrics

    # the embedded engine shares the gateway's registry so cordum_workflow_*
    # families land on the same /metrics surface
    metrics = Metrics()
    wf_engine = WorkflowEngine(store=wf_store, bus=bus, mem=mem, schemas=schemas,
                               configsvc=configsvc, instance_id="gateway-wf",
                               metrics=metrics, context_svc=context_svc)
    # SLO objectives + admission-control config come from the pools.yaml
    # slo:/admission: stanzas; an unreadable pool file must not stop the
    # gateway (it just runs without burn tracking or load shedding)
    try:
        from ..infra.config import load_pool_config

        _pool_cfg = load_pool_config(cfg.pool_config_path)
        slo_config = _pool_cfg.slo
        admission_config = _pool_cfg.admission
    except Exception as e:  # noqa: BLE001 - telemetry config is best-effort
        from ..infra import logging as logx

        logx.warn("pool config unreadable; fleet SLO tracking disabled",
                  path=cfg.pool_config_path, err=str(e))
        slo_config = {}
        admission_config = {}
    admin_keys = [k for k in os.environ.get("CORDUM_ADMIN_KEYS", "").split(",") if k]
    # CORDUM_KEY_TENANTS="key1:tenantA,key2:tenantB" scopes keys to tenants
    key_tenants: dict[str, str] = {}
    for pair in os.environ.get("CORDUM_KEY_TENANTS", "").split(","):
        k, sep, t = pair.partition(":")
        if sep and k and t:
            key_tenants[k] = t
    gw = Gateway(
        kv=kv, bus=bus, job_store=JobStore(kv), mem=mem, kernel=kernel, metrics=metrics,
        wf_store=wf_store, wf_engine=wf_engine, schemas=schemas, configsvc=configsvc,
        registry=WorkerRegistry(), context_svc=context_svc,
        auth=BasicAuthProvider(
            cfg.api_keys, admin_keys=admin_keys,
            default_tenant=os.environ.get("CORDUM_DEFAULT_TENANT", "default"),
            key_tenants=key_tenants,
        ),
        rate_rps=_boot.env_float("API_RATE_LIMIT_RPS", 0.0),
        max_concurrent_runs=_boot.env_int("MAX_CONCURRENT_RUNS", 0),
        scheduler_shards=cfg.scheduler_shards,
        slo_config=slo_config,
        admission_config=admission_config,
        # tail-based trace retention: < 1.0 keeps every slower-than-p95
        # trace and samples the fast rest (docs/OBSERVABILITY.md)
        trace_keep_fraction=_boot.env_float("CORDUM_TRACE_KEEP_FRACTION", 1.0),
    )
    host, _, port = cfg.gateway_http_addr.partition(":")
    await gw.start(host or "127.0.0.1", int(port or 8081))
    try:
        await _boot.wait_for_shutdown()
    finally:
        await gw.stop()
        await conn.close()


if __name__ == "__main__":
    asyncio.run(main())
