"""Safety-kernel service binary (reference ``cmd/cordum-safety-kernel``)."""
from __future__ import annotations

import asyncio
import os

from ..controlplane.safetykernel.kernel import SafetyKernel
from ..controlplane.safetykernel.service import KernelService
from ..infra.configsvc import ConfigService
from . import _boot


async def main() -> None:
    cfg = _boot.setup()
    configsvc = None
    conn = None
    tracer = None
    telemetry = profiler = None
    if cfg.statebus_url:
        kv, bus, conn = await _boot.connect_statebus(cfg)
        configsvc = ConfigService(kv)
        from ..infra.metrics import Metrics
        from ..obs.profiler import RuntimeProfiler
        from ..obs.telemetry import TelemetryExporter
        from ..obs.tracer import Tracer

        tracer = Tracer("safety-kernel", bus)
        metrics = Metrics()
        profiler = RuntimeProfiler(metrics, service="safety-kernel")
        telemetry = TelemetryExporter(
            "safety-kernel", bus, metrics,
            instance_id=os.environ.get("SAFETY_KERNEL_ID", "safety-kernel-0"),
            health_fn=lambda: {"role": "safety-kernel", **profiler.health()},
        )
    kernel = SafetyKernel(policy_path=cfg.safety_policy_path, configsvc=configsvc)
    svc = KernelService(kernel, reload_interval_s=_boot.env_float("SAFETY_RELOAD_INTERVAL", 30.0),
                        tracer=tracer)
    host = os.environ.get("SAFETY_KERNEL_HOST", "127.0.0.1")
    port = _boot.env_int("SAFETY_KERNEL_PORT", 7430)
    await svc.start(host, port)
    if telemetry is not None:
        await telemetry.start()
        await profiler.start()
    try:
        await _boot.wait_for_shutdown()
    finally:
        if telemetry is not None:
            await profiler.stop()
            await telemetry.stop()
        await svc.stop()
        if conn:
            await conn.close()


if __name__ == "__main__":
    asyncio.run(main())
