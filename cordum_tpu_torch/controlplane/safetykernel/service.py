"""Safety kernel as a standalone RPC service.

The reference kernel serves gRPC ``Check/Evaluate/Explain/Simulate/
ListSnapshots`` (kernel.go:56-104).  Here the kernel is a library the
scheduler can embed in-process (lowest latency), and this module makes it a
separate process when deployments want isolation: a minimal aiohttp server
exposing the same five operations, plus :func:`remote_check` — an async
check function suitable for wrapping in the scheduler's circuit-breakered
:class:`~cordum_tpu_torch.controlplane.scheduler.safety_client.SafetyClient`.
"""
from __future__ import annotations

import asyncio
from typing import Optional

import aiohttp
from aiohttp import web

from ...infra import logging as logx
from ...obs.tracer import SPAN_HEADER, TRACE_HEADER, Tracer, trace_headers
from ...protocol.types import PolicyCheckRequest, PolicyCheckResponse
from .kernel import SafetyKernel


class KernelService:
    def __init__(
        self,
        kernel: SafetyKernel,
        *,
        reload_interval_s: float = 30.0,
        tracer: Optional[Tracer] = None,
    ):
        self.kernel = kernel
        self.reload_interval_s = reload_interval_s
        # span ownership: the service wraps each RPC check in an `evaluate`
        # span using the caller's X-Cordum-Trace/Span-Id headers; the wrapped
        # kernel should therefore NOT carry its own tracer
        self.tracer = tracer
        self._runner: Optional[web.AppRunner] = None
        self._reload_task: Optional[asyncio.Task] = None
        app = web.Application()
        app.router.add_post("/v1/check", self._check)
        app.router.add_post("/v1/evaluate", self._evaluate)
        app.router.add_post("/v1/explain", self._explain)
        app.router.add_post("/v1/simulate", self._simulate)
        app.router.add_get("/v1/snapshots", self._snapshots)
        app.router.add_get("/healthz", self._health)
        self.app = app

    async def start(self, host: str = "127.0.0.1", port: int = 7430) -> None:
        await self.kernel.reload()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self._reload_task = asyncio.ensure_future(self._reload_loop())
        logx.info("safety kernel listening", host=host, port=port,
                  snapshot=self.kernel.snapshot_id)

    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        if self._reload_task:
            self._reload_task.cancel()
            self._reload_task = None
        if self._runner:
            await self._runner.cleanup()
            self._runner = None

    async def _reload_loop(self) -> None:
        while True:
            await asyncio.sleep(self.reload_interval_s)
            try:
                await self.kernel.reload()  # hot reload (kernel.go:485-508)
            except Exception:
                logx.error("policy reload failed")

    async def _check(self, request: web.Request) -> web.Response:
        req = PolicyCheckRequest.from_dict(await request.json())
        trace_id = request.headers.get(TRACE_HEADER, "")
        if self.tracer is not None and trace_id:
            async with self.tracer.span(
                "evaluate",
                trace_id=trace_id,
                parent_span_id=request.headers.get(SPAN_HEADER, ""),
                attrs={"topic": req.topic if req else ""},
            ) as sp:
                resp = await self.kernel.check(req)
                sp.attrs["decision"] = resp.decision
        else:
            resp = await self.kernel.check(req)
        return web.json_response(resp.to_dict())

    async def _evaluate(self, request: web.Request) -> web.Response:
        req = PolicyCheckRequest.from_dict(await request.json())
        return web.json_response((await self.kernel.evaluate_raw(req)).to_dict())

    async def _explain(self, request: web.Request) -> web.Response:
        req = PolicyCheckRequest.from_dict(await request.json())
        return web.json_response(await self.kernel.explain(req))

    async def _simulate(self, request: web.Request) -> web.Response:
        doc = await request.json()
        results = await self.kernel.simulate(
            doc.get("policy") or {},
            [PolicyCheckRequest.from_dict(r) for r in (doc.get("requests") or [])],
        )
        return web.json_response({"results": results})

    async def _snapshots(self, request: web.Request) -> web.Response:
        return web.json_response({"snapshots": self.kernel.list_snapshots(),
                                  "current": self.kernel.snapshot_id})

    async def _health(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True, "snapshot": self.kernel.snapshot_id})


def remote_check(base_url: str, *, timeout_s: float = 2.0):
    """Build an async check fn hitting a remote kernel — wrap it in
    SafetyClient for the breaker + fail-closed semantics."""
    session: dict = {}

    async def check(req: PolicyCheckRequest) -> PolicyCheckResponse:
        if "s" not in session:
            session["s"] = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=timeout_s)
            )
        # span context rides HTTP headers (the RPC analogue of
        # BusPacket.span_id) so the kernel-side evaluate span lands in the
        # caller's trace
        async with session["s"].post(
            f"{base_url}/v1/check", json=req.to_dict(), headers=trace_headers()
        ) as r:
            if r.status != 200:
                raise RuntimeError(f"kernel returned HTTP {r.status}")
            return PolicyCheckResponse.from_dict(await r.json())

    async def close() -> None:
        s = session.pop("s", None)
        if s is not None:
            await s.close()

    check.close = close  # type: ignore[attr-defined]
    return check
