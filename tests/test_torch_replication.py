"""The port's statebus durability against the reference's
(``cordum_tpu_torch/infra/{statebus,replication,kv}.py`` against
``cordum_tpu/infra/...``), in process on the CPU at port 0.

* **AOF bytes.** A seeded op stream writes a byte-equal AOF in both
  packages; each package replays the other's AOF to the same state (every
  key, value, version, and TTL within ``TTL_SLACK_S``); the reference's
  tail-corruption cuts recover the same state and offset in both.
* **Behaviour.** The reference's ``tests/test_replication.py`` cases run on
  each package's servers (``both``): the normalised role documents (ports
  and replica ids replaced by names) and the KV state must be equal.
* **Mixed replica sets.** A port replica tails a reference primary and a
  reference replica tails a port primary, to equal ``(epoch, offset)`` and
  snapshot bytes.

Heartbeat timeouts stay at 1 s or below.
"""
from __future__ import annotations

import asyncio
import collections
import importlib
import random
import time

import pytest

pytestmark = pytest.mark.statebus

REF, PORT = "cordum_tpu", "cordum_tpu_torch"
#: remaining TTLs of two replays are read at different instants
TTL_SLACK_S = 5.0


class Pkg:
    """One package's statebus modules."""

    def __init__(self, root):
        def m(name):
            return importlib.import_module(f"{root}.infra.{name}")

        self.root = root
        self.statebus, self.replication, self.kv = m("statebus"), m("replication"), m("kv")
        self.chaos = m("chaos")

    async def server(self, **kw):
        srv = self.statebus.StateBusServer(port=0, **kw)
        await srv.start()
        return srv

    async def replica(self, primary, **kw):
        return await self.server(replica_of=f"statebus://127.0.0.1:{primary.port}", **kw)


async def wait_for(cond, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = cond()
        if asyncio.iscoroutine(v):
            v = await v
        if v:
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


async def caught_up(primary, replica, timeout_s=10.0):
    await wait_for(lambda: replica.repl.offset >= primary.repl.offset, timeout_s,
                   "replica catch-up")


def rand_ops(rng, n):
    """The reference test's reproducible mutation stream."""
    ops = []
    for i in range(n):
        k = f"k{rng.randrange(12)}"
        ops.append(rng.choice([
            ("set", k, f"v{i}".encode()),
            ("hset", f"h{rng.randrange(4)}", {f"f{rng.randrange(3)}": str(i).encode()}),
            ("zadd", f"z{rng.randrange(3)}", f"m{rng.randrange(6)}", float(i)),
            ("rpush", f"l{rng.randrange(3)}", str(i).encode()),
            ("sadd", f"s{rng.randrange(3)}", f"m{rng.randrange(6)}"),
            ("delete", k),
        ]))
    return ops


def wide_ops(rng, n):
    """Every mutating op the server logs, TTLs included (``commit`` watches
    are read from the server at run time, so ``run_ops`` fills them)."""
    ops = []
    for i in range(n):
        k = f"k{rng.randrange(10)}"
        ops.append(rng.choice([
            ("set", k, f"v{i}".encode()),
            ("set", k, f"t{i}".encode(), 600.0 + i),
            ("setnx", k, f"n{i}".encode()),
            ("delete", k, f"k{rng.randrange(10)}"),
            ("del_eq", k, f"v{i - 1}".encode()),
            ("expire", k, 900.0),
            ("hset", f"h{rng.randrange(4)}", {f"f{rng.randrange(3)}": str(i).encode()}),
            ("hdel", f"h{rng.randrange(4)}", f"f{rng.randrange(3)}"),
            ("hincrby", f"c{rng.randrange(3)}", "n", rng.randrange(1, 5)),
            ("zadd", f"z{rng.randrange(3)}", f"m{rng.randrange(6)}", float(i) / 3),
            ("zrem", f"z{rng.randrange(3)}", f"m{rng.randrange(6)}"),
            ("rpush", f"l{rng.randrange(3)}", str(i).encode(), b"x"),
            ("ltrim", f"l{rng.randrange(3)}", -5, -1),
            ("sadd", f"s{rng.randrange(3)}", f"m{rng.randrange(6)}"),
            ("commit", k),
            ("pipe", k),
        ]))
    return ops


async def run_ops(kv, ops):
    for name, *args in ops:
        if name == "commit":
            ver = await kv.version(args[0])
            await kv.commit({args[0]: ver}, [("set", args[0], b"c"), ("sadd", "cs", args[0])])
        elif name == "pipe":
            await kv.pipe_execute({args[0]: await kv.version(args[0])},
                                  [("hset", "ph", {args[0]: b"p"}), ("expire", "ph", 700.0)])
        else:
            await getattr(kv, name)(*args)


def kv_state(kv):
    """A MemoryKV's every live key: value (sets sorted), version, TTL left."""
    now = time.monotonic()
    out = {}
    for k, e in kv._data.items():
        v = sorted(e.value) if isinstance(e.value, set) else e.value
        out[k] = (v, e.version, None if e.expires_at is None else e.expires_at - now)
    return out, kv._global_version


def assert_same_state(a, b, what):
    (sa, ga), (sb, gb) = a, b
    assert ga == gb, (what, ga, gb)
    assert sa.keys() == sb.keys(), (what, sa.keys() ^ sb.keys())
    for k in sa:
        (va, vera, ta), (vb, verb, tb) = sa[k], sb[k]
        assert (va, vera) == (vb, verb), (what, k, sa[k], sb[k])
        assert (ta is None) == (tb is None) and (ta is None or abs(ta - tb) < TTL_SLACK_S), (
            what, k, ta, tb)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def write(path, data):
    with open(path, "wb") as f:
        f.write(data)


async def write_aof(pkg, path, ops):
    srv = await pkg.server(aof_path=str(path))
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{srv.port}")
    try:
        await run_ops(kv, ops)
    finally:
        await conn.close()
        await srv.stop()
    return read(path), srv.repl.offset


async def replay(pkg, path):
    srv = await pkg.server(aof_path=str(path))
    state = kv_state(srv.kv), srv.repl.offset, srv.repl.epoch
    return srv, state


def test_record_bytes_and_endpoints_equal():
    ref, port = Pkg(REF).replication, Pkg(PORT).replication
    rec = ("pipe_execute", ({"k": 3}, [["set", "k", b"v"], ["hset", "h", {"f": b"1"}],
                                       ["zadd", "z", "m", 1.5], ["expire", "k", 9.25]]))
    assert port.pack_record(*rec) == ref.pack_record(*rec)
    assert port.unpack_record(ref.pack_record(*rec)) == ref.unpack_record(ref.pack_record(*rec))
    for url in ("statebus://h:7520", "h:7520", "statebus://a:7420|statebus://b:7520", ":"):
        assert port.parse_replica_set(url) == ref.parse_replica_set(url)
    assert port.DEFAULT_BACKLOG == ref.DEFAULT_BACKLOG == 4096
    assert port.SYNC_ACK_TIMEOUT_S == ref.SYNC_ACK_TIMEOUT_S
    # one copy of the endpoint parsers: the server module re-exports them
    assert Pkg(PORT).statebus.parse_endpoint is port.parse_endpoint


async def test_aof_bytes_equal_and_cross_replay(tmp_path):
    """A seeded stream of every mutating op writes the same AOF bytes in
    both packages, and each replays the other's to the same state."""
    ops = wide_ops(random.Random(20), 400)
    ref, port = Pkg(REF), Pkg(PORT)
    ref_aof, ref_off = await write_aof(ref, tmp_path / "ref.aof", ops)
    port_aof, port_off = await write_aof(port, tmp_path / "port.aof", ops)
    assert port_aof == ref_aof and port_off == ref_off == 400
    states = {}
    for reader in (ref, port):
        for writer, blob in (("ref", ref_aof), ("port", port_aof)):
            path = tmp_path / f"{reader.root}-{writer}.aof"
            write(path, blob)
            srv, states[reader.root, writer] = await replay(reader, path)
            await srv.stop()
    want = states[REF, "ref"]
    for key, got in states.items():
        assert got[1:] == want[1:], key
        assert_same_state(got[0], want[0], key)


async def test_snapshot_blob_equal_and_cross_load():
    """Snapshots keep versions, are the reference's bytes, and each package
    loads the other's (a client's watch stays valid across the load)."""
    ref, port = Pkg(REF).kv.MemoryKV(), Pkg(PORT).kv.MemoryKV()
    for kv in (ref, port):
        await run_ops(kv, rand_ops(random.Random(9), 200))
        await kv.set("a", b"1")
        await kv.set("a", b"2")
    assert await port.snapshot() == await ref.snapshot()
    for src, dst_cls in ((ref, Pkg(PORT).kv.MemoryKV), (port, Pkg(REF).kv.MemoryKV)):
        dst = dst_cls()
        await dst.load_snapshot(await src.snapshot())
        assert await dst.snapshot() == await src.snapshot()
        ver = await src.version("a")
        assert await dst.version("a") == ver
        assert await dst.commit({"a": ver}, [("set", "a", b"3")]) is True


def cut_points(blob):
    """The reference's ``test_aof_tail_corruption_fuzz`` cuts: 8 random
    truncations (``Random(17)``) and a garbage tail."""
    rng = random.Random(17)
    cuts = sorted(rng.randrange(1, len(blob)) for _ in range(8))
    return [(c, blob[:c]) for c in cuts] + [(None, blob + b"\xc1\x00garbage")]


async def test_aof_tail_corruption_same_recovery(tmp_path):
    """The reference's fuzz stream and cuts: both packages recover the same
    state and offset from each cut, truncate the tail clean, and a later
    append replays in the other package."""
    ref, port = Pkg(REF), Pkg(PORT)
    ops = [("set", f"fz-{i}", str(i).encode()) for i in range(50)]
    ops.append(("pipe", "fz-pipe"))
    blob, _ = await write_aof(ref, tmp_path / "full.aof", ops)
    assert (await write_aof(port, tmp_path / "full-port.aof", ops))[0] == blob
    for case, (cut, data) in enumerate(cut_points(blob)):
        got = {}
        for pkg in (ref, port):
            path = tmp_path / f"cut-{case}-{pkg.root}.aof"
            write(path, data)
            srv, got[pkg.root] = await replay(pkg, path)
            try:
                kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{srv.port}")
                await kv.set("post-recovery", b"ok")
                await conn.close()
            finally:
                await srv.stop()
        assert got[PORT][1:] == got[REF][1:], (cut, got[PORT][1:], got[REF][1:])
        assert_same_state(got[PORT][0], got[REF][0], cut)
        # the repaired files are equal, and each replays in the other package
        a, b = (read(tmp_path / f"cut-{case}-{r}.aof") for r in (REF, PORT))
        assert a == b, cut
        for pkg, other in ((ref, PORT), (port, REF)):
            srv, (_, off, _) = await replay(pkg, tmp_path / f"cut-{case}-{other}.aof")
            try:
                assert await srv.kv.get("post-recovery") == b"ok"
                assert off == got[REF][1] + 1
            finally:
                await srv.stop()


# ---------------------------------------------------------------------------
# behaviour: the reference's cases on both packages
# ---------------------------------------------------------------------------


def norm(obj, names):
    """``obj`` with every ``host:port`` of ``names`` (port → name) and every
    port number of them replaced by the name."""
    if isinstance(obj, dict):
        return {k: norm(v, names) for k, v in obj.items()}
    if isinstance(obj, list):
        return [norm(v, names) for v in obj]
    if isinstance(obj, str):
        for port, name in names.items():
            obj = obj.replace(f"127.0.0.1:{port}", name).replace(str(port), name)
        return obj
    return obj


async def role(pkg, srv, names, drop=()):
    doc = await pkg.replication.probe_role("127.0.0.1", srv.port)
    return {k: v for k, v in norm(doc, names).items() if k not in drop}


async def both(scenario):
    """Run ``scenario(pkg)`` on each package; the records must be equal."""
    ref = await scenario(Pkg(REF))
    port = await scenario(Pkg(PORT))
    assert port == ref
    return ref


async def mirrored(pkg):
    primary = await pkg.server()
    replica = await pkg.replica(primary)
    names = {primary.port: "P", replica.port: "R"}
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await run_ops(kv, rand_ops(random.Random(8), 300))
        ok, _ = await kv.pipe_execute({}, [("set", "pk", b"pv"), ("hset", "ph", {"f": b"1"})])
        assert ok
        await caught_up(primary, replica)
        snap = await primary.kv.snapshot()
        assert await replica.kv.snapshot() == snap
        assert replica.repl.epoch == primary.repl.epoch
        await wait_for(lambda: all(s.acked_offset == primary.repl.offset
                                   for s in primary.repl.sessions.values()), msg="acks")
        return {"snapshot": snap, "primary": await role(pkg, primary, names),
                "replica": await role(pkg, replica, names),
                "mode": replica._replica_link.last_sync_mode}
    finally:
        await conn.close()
        await replica.stop()
        await primary.stop()


async def test_replica_mirrors_random_op_stream():
    rec = await both(mirrored)
    assert rec["primary"]["role"] == "primary" and rec["replica"]["primary"].endswith("P")
    assert rec["mode"] == "incremental"


async def late_replica(pkg):
    primary = await pkg.server()
    primary.repl.backlog = collections.deque(maxlen=4)  # force the snapshot path
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    replica = None
    try:
        await run_ops(kv, rand_ops(random.Random(9), 120))
        replica = await pkg.replica(primary)
        await wait_for(lambda: replica._replica_link is not None
                       and replica._replica_link.connected.is_set(), msg="replica link")
        mode = replica._replica_link.last_sync_mode
        await caught_up(primary, replica)
        await kv.set("after-snap", b"yes")
        await caught_up(primary, replica)
        snap = await primary.kv.snapshot()
        assert await replica.kv.snapshot() == snap
        return {"mode": mode, "snapshot": snap, "offsets": (primary.repl.offset,
                                                            replica.repl.offset)}
    finally:
        await conn.close()
        if replica is not None:
            await replica.stop()
        await primary.stop()


async def test_late_replica_reseeds_via_snapshot():
    assert (await both(late_replica))["mode"] == "snapshot"


async def readonly(pkg):
    primary = await pkg.server()
    replica = await pkg.replica(primary)
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{replica.port}")
    errs = []
    try:
        assert await kv.get("nope") is None  # reads serve
        for call in (kv.set("nope", b"1"), kv.pipe_execute({}, [("set", "nope", b"1")])):
            with pytest.raises(RuntimeError, match="READONLY") as e:
                await call
            errs.append(norm(str(e.value), {primary.port: "P", replica.port: "R"}))
        return errs
    finally:
        await conn.close()
        await replica.stop()
        await primary.stop()


async def test_replica_rejects_writes_with_the_same_text():
    assert await both(readonly) == ["statebus: READONLY replica of statebus://P"] * 2


async def sync_crash(pkg):
    primary = await pkg.server(sync_replication=True, heartbeat_interval_s=0.1,
                               heartbeat_timeout_s=0.5)
    replica = await pkg.replica(primary, heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5)
    names = {primary.port: "P", replica.port: "R"}
    kv, _, conn = await pkg.statebus.connect(
        f"statebus://127.0.0.1:{primary.port}|statebus://127.0.0.1:{replica.port}")
    acked = []
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")

        async def writer(i):
            await kv.set(f"sync-{i}", str(i).encode())
            acked.append(i)

        tasks = [asyncio.ensure_future(writer(i)) for i in range(60)]
        await wait_for(lambda: len(acked) >= 10, msg="some acks")
        before = list(acked)
        await primary.crash()
        await asyncio.gather(*tasks)
        assert replica.role == "primary"
        lost = [i for i in before if await replica.kv.get(f"sync-{i}") != str(i).encode()]
        assert not lost, f"acked commits lost across the failover: {lost}"
        return {"values": {k: await replica.kv.get(k) for k in sorted(await replica.kv.keys())},
                "role": await role(pkg, replica, names, drop=("offset",))}
    finally:
        await conn.close()
        await replica.stop()
        await primary.stop()


async def test_sync_mode_zero_acked_commit_loss_on_primary_crash():
    rec = await both(sync_crash)
    assert len(rec["values"]) == 60 and rec["role"]["role"] == "primary"
    assert rec["role"]["epoch"] == 1


async def async_window(pkg):
    primary = await pkg.server()
    proxy = pkg.chaos.ChaosProxy("127.0.0.1", primary.port)
    await proxy.start()
    replica = await pkg.server(replica_of=f"statebus://127.0.0.1:{proxy.port}",
                               heartbeat_interval_s=0.1, heartbeat_timeout_s=0.6)
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        for i in range(20):
            await kv.set(f"a-{i}", b"x")
        await caught_up(primary, replica)
        replicated = replica.repl.offset
        proxy.blackhole()
        for i in range(15):
            await kv.set(f"b-{i}", b"y")  # acked async; never replicated
        await primary.crash()
        await wait_for(lambda: replica.role == "primary", 5.0, "auto-promote")
        assert replica.repl.offset == replicated
        return {"snapshot": await replica.kv.snapshot(), "offset": replica.repl.offset,
                "epoch": replica.repl.epoch,
                "metrics": [ln for ln in replica.metrics.render().splitlines()
                            if ln.startswith("cordum_statebus_promotions_total")]}
    finally:
        await conn.close()
        await proxy.stop()
        await replica.stop()
        await primary.stop()


async def test_async_mode_loss_bounded_to_unacked_window():
    rec = await both(async_window)
    assert rec["offset"] == 20 and rec["epoch"] == 1
    assert any('reason="primary-dead"' in ln for ln in rec["metrics"])


async def goaway(pkg):
    primary = await pkg.server(heartbeat_timeout_s=1.0)
    replica = await pkg.replica(primary, heartbeat_timeout_s=1.0)
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await primary.stop()  # graceful: GOAWAY broadcast
        await wait_for(lambda: replica.role == "primary", 5.0, "goaway promote")
        return [ln for ln in replica.metrics.render().splitlines()
                if ln.startswith("cordum_statebus_promotions_total")]
    finally:
        await replica.stop()
        await primary.stop()


async def test_goaway_promotes_replica_immediately():
    """The promotion's reason is the GOAWAY, not the heartbeat (1 s here)."""
    lines = await both(goaway)
    assert any('reason="primary-goaway"' in ln for ln in lines)
    assert not any('reason="primary-dead"' in ln for ln in lines)


async def admin(pkg):
    primary = await pkg.server()
    replica = await pkg.replica(primary)
    names = {primary.port: "P", replica.port: "R"}
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{replica.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        docs = [await role(pkg, primary, names), norm(await conn.call("role"), names),
                norm(await conn.call("promote"), names)]
        await kv.set("now-writable", b"1")
        assert await kv.get("now-writable") == b"1"
        docs.append(await role(pkg, replica, names, drop=("replicas",)))
        return docs
    finally:
        await conn.close()
        await replica.stop()
        await primary.stop()


async def test_admin_promote_and_role_frames():
    docs = await both(admin)
    assert docs[0]["role"] == "primary" and docs[0]["replicas"][0]["id"] == "R"
    assert docs[1]["role"] == "replica" and docs[2] == {"role": "primary", "epoch": 1,
                                                        "offset": 0}


async def exclusive(pkg):
    primary = await pkg.server(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5)
    replica = await pkg.replica(primary, heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5)
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    old = primary.port
    names = {old: "P", replica.port: "R"}
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await kv.set("pre-crash", b"1")
        await caught_up(primary, replica)
        await conn.close()
        await primary.crash()
        await wait_for(lambda: replica.role == "primary", 5.0, "auto-promote")
        returned = pkg.statebus.StateBusServer(port=old, peers=(
            f"statebus://127.0.0.1:{old}", f"statebus://127.0.0.1:{replica.port}"))
        await returned.start()
        await wait_for(lambda: returned.role == "replica", 5.0, "self-demotion")
        kv2, _, conn2 = await pkg.statebus.connect(f"statebus://127.0.0.1:{old}")
        with pytest.raises(RuntimeError, match="READONLY"):
            await kv2.set("split-brain", b"!")
        await conn2.close()
        kv3, _, conn3 = await pkg.statebus.connect(f"statebus://127.0.0.1:{replica.port}")
        await kv3.set("post-promotion", b"2")
        await caught_up(replica, returned)
        await conn3.close()
        assert await returned.kv.get("pre-crash") == b"1"
        await wait_for(lambda: returned._replica_link.connected.is_set(), msg="link")
        rec = {"snapshot": await returned.kv.snapshot(),
               "primary": await replica.kv.snapshot(),
               "returned": await role(pkg, returned, names),
               "new": await role(pkg, replica, names, drop=("replicas",))}
        await returned.stop()
        return rec
    finally:
        await replica.stop()
        await primary.stop()


async def test_promotion_is_exclusive_old_primary_demotes():
    rec = await both(exclusive)
    assert rec["snapshot"] == rec["primary"]
    assert rec["returned"]["role"] == "replica" and rec["returned"]["epoch"] == 1
    assert rec["returned"]["primary"] == "statebus://R"


async def sync_timeout(pkg):
    primary = await pkg.server(sync_replication=True)
    primary.repl.sync_timeout_s = 0.3
    proxy = pkg.chaos.ChaosProxy("127.0.0.1", primary.port)
    await proxy.start()
    replica = await pkg.server(replica_of=f"statebus://127.0.0.1:{proxy.port}",
                               heartbeat_timeout_s=1.0, auto_promote=False)
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await kv.set("synced", b"1")
        proxy.blackhole()
        t0 = time.monotonic()
        await kv.set("degraded", b"2")
        waited = time.monotonic() - t0
        assert waited >= 0.25, waited
        return {"timeouts": primary.metrics.statebus_sync_ack_timeouts.total(),
                "value": await kv.get("degraded"), "replica": replica.role}
    finally:
        await conn.close()
        await proxy.stop()
        await replica.stop()
        await primary.stop()


async def test_sync_ack_timeout_degrades_not_blocks():
    assert await both(sync_timeout) == {"timeouts": 1, "value": b"2", "replica": "replica"}


async def spurious(pkg):
    primary = await pkg.server(heartbeat_interval_s=0.05, heartbeat_timeout_s=0.2)
    replica = await pkg.replica(primary, heartbeat_interval_s=0.05, heartbeat_timeout_s=1.0)
    primary.peers = (f"statebus://127.0.0.1:{primary.port}",
                     f"statebus://127.0.0.1:{replica.port}")
    names = {primary.port: "P", replica.port: "R"}
    kv, _, conn = await pkg.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await kv.set("pre-split", b"1")
        await caught_up(primary, replica)
        await replica.promote(reason="admin")
        assert primary.role == "primary" and replica.role == "primary"
        await wait_for(lambda: primary.role == "replica", 10.0, "runtime self-demotion")
        await wait_for(lambda: primary.repl.epoch == 1, 10.0, "epoch adoption")
        kv2, _, conn2 = await pkg.statebus.connect(f"statebus://127.0.0.1:{replica.port}")
        await kv2.set("post-split", b"2")
        await caught_up(replica, primary)
        await conn2.close()
        assert await primary.kv.get("post-split") == b"2"
        return {"snapshot": await primary.kv.snapshot(),
                "demoted": await role(pkg, primary, names, drop=("lag_ops", "primary_offset"))}
    finally:
        await conn.close()
        await replica.stop()
        await primary.stop()


async def test_spuriously_failed_over_primary_demotes_at_runtime():
    rec = await both(spurious)
    assert rec["demoted"]["role"] == "replica" and rec["demoted"]["primary"] == "statebus://R"


# ---------------------------------------------------------------------------
# mixed replica sets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("primary_root,replica_root", [(REF, PORT), (PORT, REF)],
                         ids=["port-replica-of-reference", "reference-replica-of-port"])
async def test_mixed_replica_set(primary_root, replica_root, tmp_path):
    """One package's replica tails the other's primary (incremental from
    genesis, then a second replica re-seeded by snapshot); both reach the
    primary's ``(epoch, offset)`` and snapshot bytes, and the replica's AOF
    replays in the primary's package to the same state."""
    pp, rp = Pkg(primary_root), Pkg(replica_root)
    primary = await pp.server(heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0)
    replica = await rp.replica(primary, aof_path=str(tmp_path / "r.aof"),
                               heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0)
    late = None
    kv, _, conn = await pp.statebus.connect(f"statebus://127.0.0.1:{primary.port}")
    try:
        await wait_for(lambda: primary.repl.sessions, msg="replica attach")
        await run_ops(kv, wide_ops(random.Random(21), 200))
        primary.repl.backlog = collections.deque(primary.repl.backlog, maxlen=4)
        late = await rp.replica(primary, heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0)
        await wait_for(lambda: late._replica_link is not None
                       and late._replica_link.connected.is_set(), msg="late link")
        assert late._replica_link.last_sync_mode == "snapshot"
        await run_ops(kv, rand_ops(random.Random(22), 50))
        for r in (replica, late):
            await caught_up(primary, r)
            assert (r.repl.epoch, r.repl.offset) == (primary.repl.epoch, primary.repl.offset)
            assert_same_state(kv_state(r.kv), kv_state(primary.kv), r.port)
        # no TTL op in the tail: the snapshots' TTLs are read at one instant
        assert replica._replica_link.last_sync_mode == "incremental"
    finally:
        await conn.close()
        for s in (late, replica, primary):
            if s is not None:
                await s.stop()
    srv, (state, offset, _) = await replay(pp, tmp_path / "r.aof")
    try:
        assert offset == primary.repl.offset
        assert_same_state(state, kv_state(primary.kv), "replica's AOF")
    finally:
        await srv.stop()
