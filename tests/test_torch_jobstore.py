"""The port's job store, pipelines and record codec against the JAX
package's (``cordum_tpu/infra/{jobstore,kv,codec}.py``).

* Every transition of the job state machine, from every state (and from
  no record) to every state, gives the same outcome in both packages
  (changed, idempotent or ``IllegalTransition``) and leaves the same
  record behind, timestamps aside.
* ``Pipeline``: the same batches give the same results and versions on
  both packages' ``MemoryKV`` and on the port's ``StateBusKV`` against the
  port's statebus server; a stale watch returns False and applies nothing
  (the reference defines ``TxnConflict`` and raises it nowhere: a
  conflicting ``execute`` returns False); an op that cannot be pipelined
  is refused before anything is buffered.
* ``pack_record``/``unpack_record`` and the env-JSON helpers write the
  reference codec's bytes and read what it writes, JSON records of older
  builds included.
"""
from __future__ import annotations

import asyncio

import pytest

from cordum_tpu.infra import codec as ref_codec
from cordum_tpu.infra import jobstore as ref_js
from cordum_tpu.infra import kv as ref_kv
from cordum_tpu.protocol import types as ref_types
from cordum_tpu_torch.infra import codec as port_codec
from cordum_tpu_torch.infra import jobstore as port_js
from cordum_tpu_torch.infra import kv as port_kv
from cordum_tpu_torch.infra import statebus
from cordum_tpu_torch.protocol import types as port_types

STATES = [s.value for s in port_types.JobState]
TIMESTAMPS = ("created_at_us", "updated_at_us", "finished_at_us")


def _path_to(state):
    """A legal walk from no record to ``state`` (``""``: no walk)."""
    walks = {"": [], "PENDING": ["PENDING"], "APPROVAL_REQUIRED": ["PENDING", "APPROVAL_REQUIRED"],
             "SCHEDULED": ["PENDING", "SCHEDULED"],
             "DISPATCHED": ["PENDING", "SCHEDULED", "DISPATCHED"],
             "RUNNING": ["PENDING", "SCHEDULED", "DISPATCHED", "RUNNING"],
             "DENIED": ["PENDING", "DENIED"]}
    for end in ("SUCCEEDED", "FAILED", "CANCELLED", "TIMEOUT"):
        walks[end] = ["PENDING", "SCHEDULED", "DISPATCHED", "RUNNING", end]
    return walks[state]


async def _transition(js_mod, types_mod, kv, prev, nxt):
    store = js_mod.JobStore(kv)
    for st in _path_to(prev):
        await store.set_state("j", types_mod.JobState(st), fields={"tenant_id": "t"})
    try:
        outcome = await store.set_state("j", types_mod.JobState(nxt), event="e")
    except js_mod.IllegalTransition as e:
        outcome = ("illegal", e.prev, e.next)
    meta = {k: v for k, v in (await store.get_meta("j")).items() if k not in TIMESTAMPS}
    events = [{k: v for k, v in ev.items() if k != "ts_us"} for ev in await store.events("j")]
    index = {st: await store.list_by_state(st) for st in STATES}
    return outcome, meta, events, index


@pytest.mark.parametrize("nxt", STATES)
def test_transitions_match_the_reference(nxt):
    async def body():
        for prev in ["", *STATES]:
            want = await _transition(ref_js, ref_types, ref_kv.MemoryKV(), prev, nxt)
            got = await _transition(port_js, port_types, port_kv.MemoryKV(), prev, nxt)
            assert got == want, (prev, nxt)
            assert (port_types.is_allowed_transition(prev, port_types.JobState(nxt))
                    == ref_types.is_allowed_transition(prev, ref_types.JobState(nxt)))

    asyncio.run(body())


def test_illegal_transition_keeps_the_reference_shape():
    e = port_js.IllegalTransition("j", "", "SUCCEEDED")
    r = ref_js.IllegalTransition("j", "", "SUCCEEDED")
    assert (str(e), e.prev, e.next) == (str(r), r.prev, r.next)


async def _pipeline_script(kv_mod, kv):
    """The same batches on ``kv``; returns every observable outcome."""
    out = []
    p = kv.pipeline()
    p.set("a", b"1").hset("h", {"f": b"x", "g": b"y"}).zadd("z", "m", 2.0).rpush("l", b"p", b"q")
    p.sadd("s", "u", "v").expire("a", 60.0)
    out.append((len(p), await p.execute(), p.new_versions))
    ver = await kv.version("h")
    t = kv.pipeline().watch("h", ver).hdel("h", "g").zrem("z", "m").ltrim("l", 0, 0)
    out.append(await t.execute())
    out.append(dict(t.new_versions) == {"h": await kv.version("h")})
    stale = kv.pipeline().watch("h", ver).set("b", b"never")
    out.append((await stale.execute(), await kv.get("b")))
    absent = kv.pipeline().watch("fresh", 0).set("fresh", b"new").del_eq("a", b"1")
    out.append((await absent.execute(), await kv.get("fresh"), await kv.get("a")))
    with pytest.raises(ValueError):
        kv.pipeline().op("get", "a")
    out.append(sorted(await kv.hgetall("h")))
    out.append(await kv.lrange("l"))
    out.append(sorted(await kv.smembers("s")))
    out.append(kv.pipe_group("any-key"))
    assert issubclass(kv_mod.TxnConflict, Exception)
    assert kv_mod.PIPELINE_OPS == ref_kv.PIPELINE_OPS
    return out


def test_pipeline_on_memory_kv_matches_the_reference():
    async def body():
        want = await _pipeline_script(ref_kv, ref_kv.MemoryKV())
        got = await _pipeline_script(port_kv, port_kv.MemoryKV())
        assert got == want
        assert want[3] == (False, None)  # the stale watch applied nothing

    asyncio.run(body())


def test_pipeline_on_the_port_statebus_matches_memory_kv():
    async def body():
        want = await _pipeline_script(port_kv, port_kv.MemoryKV())
        srv = statebus.StateBusServer(port=0)
        await srv.start()
        try:
            kv, _, conn = await statebus.connect(f"statebus://127.0.0.1:{srv.port}")
            try:
                assert isinstance(kv, port_kv.KV)
                got = await _pipeline_script(port_kv, kv)
                # a job store over TCP commits its chains through the same pipes
                store = port_js.JobStore(kv)
                await store.set_state("j", port_types.JobState.PENDING)
                with pytest.raises(port_js.IllegalTransition):
                    await store.set_state("j", port_types.JobState.SUCCEEDED)
                assert await store.get_state("j") == "PENDING"
            finally:
                await conn.close()
        finally:
            await srv.stop()
        assert got == want

    asyncio.run(body())


RECORDS = [
    {"ts_us": 1712345678901234, "state": "RUNNING", "prev": "DISPATCHED", "event": "state:RUNNING"},
    {"job_id": "j", "decision": "ALLOW", "constraints": {"max_chips": 4, "env": {"A": "1"}},
     "remediations": [], "decided_at_us": 0, "score": 0.25, "none": None, "neg": -17},
    [1, "two", 3.5, b"\x00\xff", [True, False], {"k": {"nested": [None]}}],
    "plain string", 2**40, -(2**33),
]


@pytest.mark.parametrize("rec", RECORDS, ids=range(len(RECORDS)))
def test_records_pack_as_the_reference_packs_them(rec):
    packed = port_codec.pack_record(rec)
    assert packed == ref_codec.pack_record(rec)
    assert port_codec.unpack_record(packed) == ref_codec.unpack_record(packed)


def test_records_of_older_builds_are_read_as_json():
    for blob in (b'{"event": "submit", "ts_us": 5}', b'  ["a", 1]', b'"s"'):
        assert port_codec.unpack_record(blob) == ref_codec.unpack_record(blob)


def test_env_json_matches_the_reference():
    doc = {"b": [1, 2], "a": {"z": None, "y": "x"}}
    for sort_keys in (False, True):
        assert (port_codec.dumps_env_json(doc, sort_keys=sort_keys)
                == ref_codec.dumps_env_json(doc, sort_keys=sort_keys))
    s = ref_codec.dumps_env_json(doc)
    assert port_codec.loads_env_json(s) == ref_codec.loads_env_json(s) == doc
    assert port_codec.loads_env_json(s) is port_codec.loads_env_json(s)  # interned
    assert port_codec.loads_env_json("{not json") is None
    assert ref_codec.loads_env_json("{not json") is None
