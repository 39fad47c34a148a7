"""The port's workflow engine against the JAX package's, workflow by
workflow.

Each scenario runs the same workflow document through each package's
``Engine`` (``tests/test_workflow.py``'s harness: a synchronous
``LoopbackBus``, a ``MemoryKV``, the submits captured instead of
scheduled), feeds both the same scripted results in the same order, and
compares what came out: the captured job requests with their payloads,
the final run document, the timeline and the spans.  Ids come from a
counter in both (``tests/test_torch_gateway.py`` ``counted_ids``) and
wall-clock values are normalised.  ``context.*`` steps run on a
``ContextService`` with a deterministic embedder (vectors drawn from a
generator seeded by each text's digest).  The last tests run whole stacks:
the scheduler, the workflow engine's service and a scripted worker, with
the gateway's embedded engine as a second consumer of results.
"""
from __future__ import annotations

import asyncio
import hashlib
import importlib

import numpy as np
import pytest

from tests.test_torch_gateway import (PACKAGES, Pkg, close_stack, counted_ids, hdr, make_stack,
                                      metric_lines, norm, settle)

DIM = 16


class HashEmbedder:
    """Sync embedder: a unit vector per text from a generator seeded by the
    text's digest (the same in both packages and every process)."""

    def __init__(self):
        self.calls: list[list[str]] = []

    def embed(self, texts):
        self.calls.append(list(texts))
        out = np.zeros((len(texts), DIM), np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(hashlib.blake2b(t.encode(), digest_size=8).digest(), "little")
            v = np.random.default_rng(seed).standard_normal(DIM).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


class Harness:
    """``tests/test_workflow.py``'s harness over one package."""

    def __init__(self, pkg, *, context=False):
        def m(name):
            return importlib.import_module(f"{pkg.root}.{name}")

        self.pkg = pkg
        self.M = m("workflow.models")
        self.kv = pkg.kv.MemoryKV()
        self.bus = pkg.bus.LoopbackBus(sync=True)
        self.store = pkg.wf_store.WorkflowStore(self.kv)
        self.mem = pkg.memstore.MemoryStore(self.kv)
        self.schemas = pkg.schemareg.SchemaRegistry(self.kv)
        self.engine = pkg.wf_engine.Engine(store=self.store, bus=self.bus, mem=self.mem,
                                           schemas=self.schemas)
        self.embedder = HashEmbedder()
        if context:
            self.engine.context_svc = pkg.context.ContextService(self.kv, embedder=self.embedder)
        self.dispatched: list = []
        self.packets: list = []

    async def setup(self, doc):
        wf = self.M.Workflow.from_dict(doc)
        errs = wf.validate()
        if not errs:
            await self.store.put_workflow(wf)

        async def capture(subject, pkt):
            if pkt.job_request:
                self.dispatched.append(pkt.job_request)

        async def tap(subject, pkt):
            body = pkt.to_dict()
            body.pop("created_at_us", None)
            self.packets.append((subject, norm(body)))

        S = self.pkg.subj
        await self.bus.subscribe(S.SUBMIT, capture)
        # not a wildcard: a listener on the step-result subject would take
        # the in-engine context steps' results off the direct path
        for subject in (S.SUBMIT, S.CANCEL, S.TRACE_SPAN, S.WORKFLOW_EVENT, "sys.alert"):
            await self.bus.subscribe(subject, tap)
        return errs

    async def succeed(self, job_id, output=None):
        T = self.pkg.types
        ptr = await self.mem.put_result(job_id, output) if output is not None else ""
        return await self.engine.handle_job_result(
            T.JobResult(job_id=job_id, status="SUCCEEDED", result_ptr=ptr, worker_id="w"))

    async def fail(self, job_id, msg="boom"):
        T = self.pkg.types
        return await self.engine.handle_job_result(
            T.JobResult(job_id=job_id, status="FAILED", error_message=msg, worker_id="w"))

    async def drain(self, run_id, rounds=20):
        for _ in range(rounds):
            await self.engine.drain_context_steps()
            run = await self.store.get_run(run_id)
            if run.status in self.M.RUN_TERMINAL:
                return run
            await asyncio.sleep(0.01)
        return await self.store.get_run(run_id)

    async def record(self, run_id, extra=None):
        run = await self.store.get_run(run_id)
        reqs = []
        for r in self.dispatched:
            d = r.to_dict()
            d.pop("trace_id", None)
            reqs.append({"request": norm(d), "payload": norm(await self.mem.get_pointer(
                r.context_ptr)) if r.context_ptr else None})
        timeline = norm(await self.store.timeline(run_id))
        for e in timeline:  # a delay's wake time is a wall-clock reading
            if e["event"] == "delay_started":
                e["detail"] = "<t>"
        return {"run": norm(run.to_dict()) if run else None, "timeline": timeline,
                "requests": reqs, "packets": self.packets,
                "embeds": self.embedder.calls,
                "metrics": [line for line in metric_lines(self.engine.metrics.render())
                            if "cordum_workflow" in line],
                "extra": norm(extra)}


def both(scenario, *, context=False):
    """``scenario(harness)`` on each package; the records must be equal."""
    async def one(root):
        pkg = Pkg(root)
        with counted_ids(pkg):
            h = Harness(pkg, context=context)
            return await scenario(h)

    ref, port = (asyncio.run(one(root)) for root in PACKAGES)
    for key in ref:
        assert port[key] == ref[key], key
    return ref


def wf_doc(steps, **kw):
    return {"id": kw.pop("id", "wf1"), "name": "test", "steps": steps, **kw}


# ---------------------------------------------------------------- evaluation


@pytest.mark.parametrize("expr", [
    "input.n", "steps.a.out.1", "input.missing", "'hello'", "42", "true", "input.n == 3",
    "input.n != 3", "input.n > 2", "input.n <= 2", "input.s == 'ok'", "!input.missing",
    "!input.n", "length(steps.a.out)", "first(steps.a.out)", "length(steps.missing)",
    "length(steps.a.out) == 2", "input.f >= 1.5", "input.s"])
def test_evaluate(expr):
    scope = {"input": {"n": 3, "s": "ok", "f": 1.5}, "steps": {"a": {"out": [1, 2]}}}
    got = [importlib.import_module(f"{root}.workflow.eval").evaluate(expr, scope)
           for root in PACKAGES]
    assert got[1] == got[0] and type(got[1]) is type(got[0])


@pytest.mark.parametrize("template", [
    "${input.name}", "${steps.a.v}", "hello ${input.name}!", "a=${steps.a.v}",
    {"x": "${input.n}", "y": ["${input.name}", "${steps.a.v}"]}, "plain", "${missing.path}"])
def test_expand_templates(template):
    scope = {"input": {"name": "world", "n": 2}, "steps": {"a": {"v": [1, 2]}}}
    got = [importlib.import_module(f"{root}.workflow.eval").expand_templates(template, scope)
           for root in PACKAGES]
    assert got[1] == got[0]


@pytest.mark.parametrize("doc", [
    wf_doc({"a": {"topic": "t", "depends_on": ["zzz"]}}),
    wf_doc({"a": {"topic": "t", "depends_on": ["b"]}, "b": {"topic": "t", "depends_on": ["a"]}}),
    wf_doc({}),
    wf_doc({"a": {"type": "delay"}}),
    wf_doc({"a": {"topic": "t", "for_each": "input.x", "max_parallel": -1}}),
    wf_doc({"a": {"topic": "t"}}, slo_class="nonsense"),
    wf_doc({"a": {"topic": "t"}, "b": {"type": "approval", "depends_on": ["a"]}}),
], ids=["missing-dep", "cycle", "empty", "delay-no-time", "fanout", "slo", "ok"])
def test_validate(doc):
    got = []
    for root in PACKAGES:
        M = importlib.import_module(f"{root}.workflow.models")
        wf = M.Workflow.from_dict(doc)
        got.append((wf.validate(), norm(wf.to_dict())))
    assert got[1] == got[0]


# ---------------------------------------------------------------- runs


def test_linear_dag_with_output_path_and_schema():
    async def scenario(h):
        await h.schemas.put("out", {"type": "object", "required": ["score"]})
        await h.setup(wf_doc({
            "a": {"topic": "job.t", "input": {"x": "${input.x}"}},
            "b": {"topic": "job.t", "depends_on": ["a"], "output_path": "results.final",
                  "output_schema_id": "out", "input": {"prev": "${steps.a.v}"}}}))
        run = await h.engine.start_run("wf1", {"x": 7}, labels={"k": "v"})
        await h.succeed(h.dispatched[0].job_id, {"v": [1, 2]})
        await h.succeed(h.dispatched[1].job_id, {"score": 9})
        return await h.record(run.run_id)

    t = both(scenario)
    assert t["run"]["status"] == "SUCCEEDED"
    assert t["run"]["context"]["results"]["final"] == {"score": 9}


def test_schema_violation_fails_the_step():
    async def scenario(h):
        await h.schemas.put("out", {"type": "object", "required": ["score"]})
        await h.setup(wf_doc({"a": {"topic": "job.t", "output_schema_id": "out"}}))
        run = await h.engine.start_run("wf1", {})
        await h.succeed(h.dispatched[0].job_id, {"nope": 1})
        return await h.record(run.run_id)

    assert both(scenario)["run"]["status"] == "FAILED"


def test_branches_condition_gate():
    async def scenario(h):
        await h.setup(wf_doc({
            "check": {"type": "condition", "condition": "input.n > 2"},
            "big": {"topic": "job.big", "depends_on": ["check"], "condition": "input.n > 2"},
            "small": {"topic": "job.small", "depends_on": ["check"], "condition": "input.n <= 2"},
            "after": {"topic": "job.after", "depends_on": ["big"]}}))
        runs = []
        for n in (5, 1):
            run = await h.engine.start_run("wf1", {"n": n})
            for _ in range(3):
                for r in list(h.dispatched):
                    if r.job_id.startswith(run.run_id):
                        await h.succeed(r.job_id, {"n": n})
            runs.append(await h.record(run.run_id))
        return {k: [r[k] for r in runs] for k in runs[0]}

    t = both(scenario)
    assert [r["status"] for r in t["run"]] == ["SUCCEEDED", "SUCCEEDED"]
    assert t["run"][1]["steps"]["big"]["status"] == "SKIPPED"


def test_loop_fanout_with_max_parallel_out_of_order():
    async def scenario(h):
        await h.setup(wf_doc({
            "fan": {"topic": "job.t", "for_each": "input.items", "max_parallel": 2,
                    "input": {"item": "${item}", "i": "${index}"}},
            "sum": {"topic": "job.sum", "depends_on": ["fan"],
                    "input": {"n": "${steps.fan.count}"}}}))
        run = await h.engine.start_run("wf1", {"items": ["a", "b", "c", "d", "e"]})
        done = set()
        for _ in range(10):
            todo = [r for r in h.dispatched if r.job_id not in done]
            for r in reversed(todo):  # children answered last first
                done.add(r.job_id)
                await h.succeed(r.job_id, {"got": r.job_id.split("#")[-1]})
        return await h.record(run.run_id)

    t = both(scenario)
    assert t["run"]["status"] == "SUCCEEDED"
    assert t["run"]["context"]["steps"]["fan"]["count"] == 5


def test_fanout_child_failure_and_on_error_continue():
    async def scenario(h):
        await h.setup(wf_doc({
            "fan": {"topic": "job.t", "for_each": "input.items"},
            "soft": {"topic": "job.soft", "on_error": "continue"},
            "tail": {"topic": "job.tail", "depends_on": ["soft"]}}))
        run = await h.engine.start_run("wf1", {"items": [1, 2, 3]})
        for r in list(h.dispatched):
            if "#1@" in r.job_id or r.topic == "job.soft":
                await h.fail(r.job_id, "child broke")
            else:
                await h.succeed(r.job_id, {"ok": True})
        for r in list(h.dispatched):
            if r.topic == "job.tail":
                await h.succeed(r.job_id, {})
        return await h.record(run.run_id)

    t = both(scenario)
    assert t["run"]["steps"]["fan"]["status"] == "FAILED"


def test_retries_backoff_then_success_and_exhaustion():
    async def scenario(h):
        # backoffs long enough that no stall of a loaded host elapses one
        # between a failure and the early resume_due
        await h.setup(wf_doc({
            "r": {"topic": "job.t",
                  "retry": {"max_retries": 2, "backoff_sec": 0.3, "multiplier": 1.0}},
            "x": {"topic": "job.x", "retry": {"max_retries": 1, "backoff_sec": 0.3}}}))
        run = await h.engine.start_run("wf1", {})
        by_topic = lambda t: [r for r in h.dispatched if r.topic == t]  # noqa: E731
        await h.fail(by_topic("job.t")[0].job_id)
        await h.fail(by_topic("job.x")[0].job_id)
        early = await h.engine.resume_due(run.run_id)
        await asyncio.sleep(0.35)
        late = await h.engine.resume_due(run.run_id)
        await h.succeed(by_topic("job.t")[1].job_id, {"ok": 1})
        await h.fail(by_topic("job.x")[1].job_id)
        # a stale attempt and a duplicate after the end change nothing
        stale = await h.succeed(by_topic("job.t")[0].job_id, {"stale": True})
        dup = await h.succeed(by_topic("job.t")[1].job_id, {"dup": True})
        return await h.record(run.run_id, {"early": early, "late": late, "stale": stale,
                                           "dup": dup})

    t = both(scenario)
    assert t["run"]["steps"]["r"]["status"] == "SUCCEEDED"
    assert t["run"]["steps"]["x"]["status"] == "FAILED" and t["run"]["status"] == "FAILED"


def test_approvals_delay_and_notify():
    async def scenario(h):
        await h.setup(wf_doc({
            "gate": {"type": "approval"},
            "deploy": {"topic": "job.t", "depends_on": ["gate"]},
            "wait": {"type": "delay", "delay_sec": 0.02, "depends_on": ["deploy"]},
            "tell": {"type": "notify", "depends_on": ["wait"],
                     "input": {"message": "run for ${input.who}", "severity": "warning"}}}))
        ok = await h.engine.start_run("wf1", {"who": "ops"})
        await h.engine.approve_step(ok.run_id, "gate", approve=True, approved_by="admin")
        await h.succeed(h.dispatched[-1].job_id, {})
        await asyncio.sleep(0.03)
        await h.engine.resume_due(ok.run_id)
        no = await h.engine.start_run("wf1", {"who": "dev"})
        await h.engine.approve_step(no.run_id, "gate", approve=False, approved_by="admin")
        a, b = await h.record(ok.run_id), await h.record(no.run_id)
        return {**a, "extra": b["run"], "timeline_rejected": b["timeline"]}

    t = both(scenario)
    assert t["run"]["status"] == "SUCCEEDED" and t["extra"]["status"] == "FAILED"


def test_cancel_and_rerun_from():
    async def scenario(h):
        await h.setup(wf_doc({
            "a": {"topic": "job.a"}, "b": {"topic": "job.b", "depends_on": ["a"]},
            "c": {"topic": "job.c", "depends_on": ["b"]}}))
        run = await h.engine.start_run("wf1", {})
        await h.succeed(h.dispatched[0].job_id, {"a": 1})
        await h.succeed(h.dispatched[1].job_id, {"b": 1})
        await h.succeed(h.dispatched[2].job_id, {"c": 1})
        await h.engine.rerun_from(run.run_id, "b")
        await h.succeed(h.dispatched[3].job_id, {"b": 2})
        other = await h.engine.start_run("wf1", {}, idempotency_key="once")
        again = await h.engine.start_run("wf1", {}, idempotency_key="once")
        await h.engine.cancel_run(other.run_id, reason="stop")
        rec = await h.record(run.run_id, {"same": again.run_id == other.run_id})
        rec["cancelled"] = (await h.record(other.run_id))["run"]
        return rec

    t = both(scenario)
    assert t["cancelled"]["status"] == "CANCELLED" and t["extra"]["same"] is True


def test_slo_class_sessions_and_dry_run():
    async def scenario(h):
        await h.setup(wf_doc({
            "gen": {"topic": "job.llm", "input": {"op": "llm.generate", "prompt": "hi"}},
            "other": {"topic": "job.t", "input": {"x": 1},
                      "meta": {"risk_tags": ["pii"], "requires": ["gpu"]}}},
            slo_class="interactive"))
        run = await h.engine.start_run("wf1", {}, labels={"cordum.session_key": "sess-1"})
        dry = await h.engine.start_run("wf1", {}, dry_run=True)
        rec = await h.record(run.run_id)
        rec["dry"] = (await h.record(dry.run_id))["run"]
        return rec

    t = both(scenario)
    gen = next(r for r in t["requests"] if r["request"]["topic"] == "job.llm")
    assert gen["payload"]["session_id"]


def test_context_steps_with_a_deterministic_embedder():
    async def scenario(h):
        await h.setup(wf_doc({
            "up": {"topic": "job.tpu.context",
                   "input": {"op": "context.update", "user_payload": "hello",
                             "model_response": "world", "summary": "the summary",
                             "chunks": [{"file_path": "notes", "content": "alpha beta"},
                                        {"file_path": "more", "content": "gamma delta"},
                                        {"file_path": "last", "content": "alpha gamma"}]}},
            "win": {"topic": "job.tpu.context", "depends_on": ["up"],
                    "input": {"op": "context.window", "mode": "RAG", "query": "alpha",
                              "max_input_tokens": 64}},
            "use": {"topic": "job.llm", "depends_on": ["win"],
                    "input": {"op": "llm.generate", "messages": "${steps.win.messages}"}}}))
        run = await h.engine.start_run("wf1", {})
        run = await h.drain(run.run_id)
        for r in h.dispatched:
            await h.succeed(r.job_id, {"tokens": [1, 2]})
        await h.drain(run.run_id)
        return await h.record(run.run_id)

    t = both(scenario, context=True)
    win = t["run"]["context"]["steps"]["win"]
    assert win["message_count"] >= 3 and win["messages"][0]["source"].startswith("rag:")
    assert [r["request"]["topic"] for r in t["requests"]] == ["job.llm"]
    assert t["embeds"] and t["run"]["status"] == "SUCCEEDED"


@pytest.mark.parametrize("wired", [False, True], ids=["no-service", "unknown-op"])
def test_context_step_edges(wired):
    """No context service: the step fails.  An op outside ``context.update``
    and ``context.window``: the step leaves as a plain job."""
    async def scenario(h):
        await h.setup(wf_doc({"up": {"topic": "job.tpu.context",
                                     "input": {"op": "context.nope" if wired
                                               else "context.update"}}}))
        run = await h.engine.start_run("wf1", {})
        return await h.record((await h.drain(run.run_id)).run_id)

    t = both(scenario, context=wired)
    if wired:
        assert t["run"]["status"] == "RUNNING" and len(t["requests"]) == 1
    else:
        assert t["run"]["status"] == "FAILED" and t["run"]["steps"]["up"]["error"]


# ---------------------------------------------------------------- two consumers


def test_gateway_and_engine_service_each_advance_a_run_once():
    """The reference deployment: the gateway's embedded engine starts runs
    and the workflow engine's service consumes results, with a second
    service replica on the same bus (two result consumers).  Every run
    ends SUCCEEDED, each step's job ran once, and both packages record the
    same runs and timelines."""
    async def one(root):
        pkg = Pkg(root)
        with counted_ids(pkg):
            s = await make_stack(pkg)
            replica = pkg.wf_service.WorkflowEngineService(
                engine=pkg.wf_engine.Engine(store=s.wf_store, bus=s.bus, mem=s.mem,
                                            schemas=s.schemas, instance_id="wf-engine-1"),
                bus=s.bus, job_store=s.job_store, instance_id="wf-engine-1",
                reconcile_interval_s=0.1)
            await replica.start()
            try:
                wf = {"id": "two", "steps": {
                    "a": {"topic": "job.work", "input": {"n": "${input.n}"}},
                    "f": {"topic": "job.work", "depends_on": ["a"], "for_each": "input.items",
                          "input": {"i": "${item}"}},
                    "z": {"topic": "job.work", "depends_on": ["f"]}}}
                r = await s.client.post("/api/v1/workflows", json=wf, headers=hdr())
                assert r.status == 201
                runs = []
                for n in range(3):
                    r = await s.client.post("/api/v1/workflows/two/runs", headers=hdr(),
                                            json={"input": {"n": n, "items": [1, 2, 3]}})
                    runs.append((await r.json())["run_id"])
                for _ in range(200):
                    await settle(s, 2)
                    docs = [await s.wf_store.get_run(rid) for rid in runs]
                    if all(d.status in ("SUCCEEDED", "FAILED") for d in docs):
                        break
                out = []
                for rid in runs:
                    d = await s.wf_store.get_run(rid)
                    out.append({"run": norm(d.to_dict()),
                                "timeline": norm(await s.wf_store.timeline(rid))})
                return out, list(s.responder.seen)
            finally:
                await replica.stop()
                await close_stack(s)

    (ref, ref_seen), (port, port_seen) = (asyncio.run(one(root)) for root in PACKAGES)
    assert port == ref
    assert [r["run"]["status"] for r in ref] == ["SUCCEEDED"] * 3
    for seen in (ref_seen, port_seen):
        assert len(seen) == len(set(seen)) == 3 * 5
    for r in ref:  # each step (and each fan-out child) succeeded once
        done = [e["step_id"] for e in r["timeline"] if e["event"] == "step_succeeded"]
        assert sorted(done) == sorted(set(done)) and len(done) == 5
