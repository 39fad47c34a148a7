"""The port's admission controller against the JAX package's.

The same pressure sequence goes to each package's ``AdmissionController``
(``tests/test_admission.py``'s set-up: an injected clock, an injected
``rng`` drawn from one seeded ``random.Random``, a ``FleetAggregator`` fed
the same telemetry beacons, a scripted SLO tracker, a synchronous
``LoopbackBus`` for the pressure beacons).  The decisions, the tiers, the
pressure beacons, the shed counters and the controller's document must be
equal.  The gateway's 429 paths are then held to each other over HTTP.
"""
from __future__ import annotations

import asyncio
import importlib
import random

import pytest

from tests.test_torch_gateway import PACKAGES, Pkg, both as gateway_both, hdr, norm

SEED = 0


def worker_beacon(T, instance, rows, *, started=1, seq=0):
    return T.TelemetrySnapshot(
        service="worker", instance=instance, seq=seq, started_at_us=started, interval_s=2.0,
        health={"role": "worker", "capacity": {"v": 1, "seq": seq, "full": True,
                                               "device_kind": "cpu", "rows": rows}})


def cap_row(op, items_per_s):
    return {"op": op, "bucket": "-", "n": 100, "items": 100, "items_per_s": items_per_s,
            "tokens_per_s": 0.0}


class FakeSLO:
    """Scripted burn rates (``tests/test_admission.py``'s stand-in)."""

    def __init__(self):
        self.burn_5m, self.state = 0.0, "ok"

    def evaluate(self, aggregator):
        return [{"name": "interactive", "job_class": "INTERACTIVE", "state": self.state,
                 "windows": {"5m": {"burn_rate": self.burn_5m},
                             "1h": {"burn_rate": self.burn_5m}}}]


#: pressure sequences: (config, steps).  A step is ("beacon", instance,
#: {op: items/s}), ("queue", depth), ("offer", op, class, n, dt),
#: ("admit", op, class, tenant, times), ("burn", rate, state), ("tick", dt),
#: ("publish",)
SEQUENCES = {
    "analytic": ({"enabled": True}, [
        ("beacon", "w1", {"chat": 100.0}), ("offer", "chat", "INTERACTIVE", 30, 1.0),
        ("offer", "chat", "BATCH", 150, 1.0), ("admit", "chat", "BATCH", "", 20),
        ("admit", "chat", "INTERACTIVE", "", 5), ("offer", "chat", "INTERACTIVE", 200, 1.0),
        ("admit", "chat", "INTERACTIVE", "", 10), ("offer", "chat", "BATCH", 900, 1.0),
        ("admit", "chat", "BATCH", "", 10), ("tick", 5.0), ("admit", "chat", "BATCH", "", 10)]),
    "proportional": ({"enabled": True, "safety_factor": 0.8, "smoothing_alpha": 0.5}, [
        ("beacon", "w1", {"chat": 60.0, "embed": 400.0}),
        ("beacon", "w2", {"chat": 40.0}), ("offer", "chat", "BATCH", 120, 1.0),
        ("offer", "embed", "BATCH", 500, 1.0), ("admit", "chat", "BATCH", "", 40),
        ("admit", "embed", "BATCH", "", 40), ("offer", "chat", "BATCH", 30, 2.0),
        ("admit", "chat", "BATCH", "", 40), ("admit", "other", "STANDARD", "", 5)]),
    "fallback": ({"enabled": True, "queue_depth_limit": 100, "interactive_queue_bound": 1000}, [
        ("queue", 500), ("offer", "chat", "BATCH", 50, 1.0), ("admit", "chat", "BATCH", "", 5),
        ("admit", "chat", "INTERACTIVE", "", 5), ("queue", 5000), ("tick", 1.0),
        ("admit", "chat", "INTERACTIVE", "", 5), ("queue", 10), ("tick", 1.0),
        ("admit", "chat", "BATCH", "", 5)]),
    "brownout": ({"enabled": True, "best_effort_ops": ["embed"], "queue_depth_limit": 10,
                  "interactive_queue_bound": 100}, [
        ("beacon", "w1", {"chat": 1000.0, "embed": 1000.0}), ("burn", 2.0, "warn"),
        ("offer", "chat", "BATCH", 1, 1.0), ("publish",), ("admit", "chat", "BATCH", "", 3),
        ("admit", "chat", "INTERACTIVE", "", 3), ("burn", 20.0, "page"), ("tick", 1.0),
        ("publish",), ("publish",), ("admit", "embed", "INTERACTIVE", "", 3), ("queue", 5000),
        ("tick", 1.0), ("admit", "chat", "INTERACTIVE", "", 3), ("burn", 0.0, "ok"),
        ("queue", 0), ("tick", 1.0), ("publish",), ("admit", "chat", "BATCH", "", 3)]),
    "tenants": ({"enabled": True, "tenants": {"acme": {"rate_rps": 1.0, "burst": 2},
                                              "default": {"rate_rps": 3.0, "burst": 1}}}, [
        ("admit", "x", "BATCH", "acme", 4), ("admit", "x", "BATCH", "other", 3),
        ("tick", 1.1), ("admit", "x", "BATCH", "acme", 3), ("tick", 0.2),
        ("admit", "x", "BATCH", "other", 3)]),
}


def run_sequence(root, config, steps):
    """One package's controller through ``steps``; returns its trace."""
    pkg = Pkg(root)
    adm = importlib.import_module(f"{root}.controlplane.gateway.admission")
    fleet_mod = importlib.import_module(f"{root}.obs.fleet")
    metrics_mod = importlib.import_module(f"{root}.infra.metrics")
    T = pkg.types

    async def go():
        bus = pkg.bus.LoopbackBus(sync=True)
        beacons = []

        async def tap(subject, pkt):
            beacons.append(norm(pkt.admission_pressure.to_dict()))

        await bus.subscribe(pkg.subj.ADMISSION_PRESSURE, tap)
        fleet = fleet_mod.FleetAggregator(None)
        slo = FakeSLO()
        clock = [0.0]
        rng = random.Random(SEED)
        metrics = metrics_mod.Metrics()
        ctrl = adm.AdmissionController(fleet=fleet, slo_tracker=slo, config=config,
                                       metrics=metrics, bus=bus, clock=lambda: clock[0],
                                       rng=rng.random)
        trace = []
        seqs: dict = {}
        for step in steps:
            kind = step[0]
            if kind == "beacon":
                seqs[step[1]] = seqs.get(step[1], -1) + 1
                fleet.ingest(worker_beacon(T, step[1], {f"{op}|-": cap_row(op, r)
                                                        for op, r in step[2].items()},
                                           seq=seqs[step[1]]))
            elif kind == "queue":
                seqs["s0"] = seqs.get("s0", -1) + 1
                fleet.ingest(T.TelemetrySnapshot(
                    service="scheduler", instance="s0", seq=seqs["s0"], started_at_us=1,
                    interval_s=2.0, health={"role": "scheduler", "queue_depth": step[1]}))
            elif kind == "offer":
                _, op, klass, n, dt = step
                for _ in range(n):
                    ctrl._arrivals[(op, klass)] = ctrl._arrivals.get((op, klass), 0) + 1
                clock[0] += dt
                ctrl.refresh(clock[0])
            elif kind == "tick":
                clock[0] += step[1]
                ctrl.refresh(clock[0])
            elif kind == "burn":
                slo.burn_5m, slo.state = step[1], step[2]
            elif kind == "publish":
                trace.append(("published", await ctrl.publish_pressure(clock[0])))
            elif kind == "admit":
                _, op, klass, tenant, times = step
                for _ in range(times):
                    v = ctrl.admit(op=op, job_class=klass, tenant=tenant, now=clock[0])
                    trace.append(("admit", op, klass, tenant, v.allowed, v.reason, v.mode,
                                  round(v.retry_after_s, 9)))
            trace.append(("tier", ctrl.tier))
        shed = sorted(line for line in metrics.render().splitlines()
                      if line.startswith("cordum_gateway_shed_total"))
        doc = ctrl.doc()
        return {"trace": trace, "beacons": beacons, "shed": shed, "doc": doc,
                "table": adm.render_admission_table(doc)}

    return asyncio.run(go())


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_pressure_same_decisions(name):
    config, steps = SEQUENCES[name]
    ref, port = (run_sequence(root, config, steps) for root in PACKAGES)
    for key in ref:
        assert port[key] == ref[key], key
    verdicts = [t for t in ref["trace"] if t[0] == "admit"]
    assert verdicts and any(not v[4] for v in verdicts), "the sequence never sheds"


def test_disabled_controller_admits_everything():
    ref, port = (run_sequence(root, {}, [("admit", "chat", "BATCH", "t", 3)]) for root in PACKAGES)
    assert port == ref
    assert all(t[4] and t[6] == "disabled" for t in ref["trace"] if t[0] == "admit")


def test_gateway_sheds_with_retry_after_over_http():
    """Tenant quota through ``POST /api/v1/jobs`` and ``jobs:batch``, then
    the controller's document at ``GET /api/v1/admission``."""
    async def scenario(s, rec):
        for _ in range(2):
            await rec.call("post", "/api/v1/jobs", headers=hdr(),
                           json={"topic": "job.work", "priority": "BATCH"})
        r = await s.client.post("/api/v1/jobs:batch", headers=hdr(),
                                json={"jobs": [{"topic": "job.work"}]})
        body = norm(await r.json())
        status, doc = await rec.call("get", "/api/v1/admission", headers=hdr())
        for row in doc.get("ops", {}).values():  # rates over the wall clock
            for k in ("offered", "headroom_interactive", "headroom_batch"):
                row[k] = "<rate>"
        for row in doc.get("tenants", {}).values():  # refilled over the wall clock
            row["tokens"] = "<tokens>"
        shed = s.gw.metrics.gateway_shed.value(reason="tenant_quota", job_class="BATCH")
        return {"bulk": (r.status, body, float(r.headers.get("Retry-After", 0)) > 0),
                "shed": shed}

    t = gateway_both(scenario, gateway_kw={"admission_config": {
        "enabled": True, "tenants": {"default": {"rate_rps": 0.01, "burst": 1}}}})
    assert [r[1] for r in t["requests"]] == [202, 429, 200]
    assert t["requests"][1][2]["reason"] == "tenant_quota"
    assert t["extra"]["bulk"][0] == 400 and t["extra"]["bulk"][2]
    assert t["extra"]["shed"] == 2
