"""The port's statebus (``cordum_tpu_torch/infra/statebus.py``), its cold
tier journal (``serving/tiering.py`` ``StatebusColdTier``) and its config
reader (``infra/config.py``) against the JAX package's, on the CPU.

* Each half of the statebus against the other package's half: the same
  scripted sequence of KV ops, a pipelined batch with a version watch, a
  conflicting commit and queue-group pub/sub (two members on two
  connections, a plain subscriber on a third) runs against the reference
  server with the reference client, and must give the same results with
  the port's server under the reference client, the reference server
  under the port's client, and the port's server under the port's client.
* A cold-tier journal written by either package reads back in the other,
  and both journal the same bytes.
* The pools file parses to the reference's ``PoolConfig``.
"""
from __future__ import annotations

import asyncio
import dataclasses

import pytest

N_PUBS = 12


async def _sequence(pkg, url):
    """The scripted sequence over three connections of ``pkg``'s client;
    returns every result, in order."""
    statebus = pkg.infra.statebus
    types = pkg.protocol.types
    (kv, bus, c1), (_, bus2, c2), (_, bus3, c3) = [await statebus.connect(url) for _ in range(3)]
    out = []
    try:
        await kv.set("a", b"1")
        out += [await kv.get("a"), await kv.setnx("a", b"2"), await kv.setnx("b", b"2")]
        await kv.hset("h", {"x": b"1", "y": b"2"})
        out += [await kv.hgetall("h"), await kv.hget("h", "y"), await kv.hincrby("h", "n", 5),
                await kv.hdel("h", "x")]
        await kv.zadd("z", "m1", 2.0)
        await kv.zadd("z", "m2", 1.0)
        out += [await kv.zrange("z"), await kv.zrangebyscore("z", 0.0, 1.5), await kv.zcard("z"),
                await kv.zscore("z", "m1")]
        out += [await kv.rpush("l", b"a", b"b", b"c"), await kv.lrange("l", 0, 1)]
        await kv.ltrim("l", 1, -1)
        out += [await kv.llen("l"), await kv.sadd("s", "x", "y"), await kv.smembers("s")]
        out += [await kv.keys(""), await kv.delete("b"), await kv.del_eq("a", b"1")]
        ver = await kv.version("h")
        out.append(await kv.pipe_execute({"h": ver}, [("set", "p", b"q"), ("hset", "h", {"z": b"3"}),
                                                      ("zadd", "z", "m3", 3.0)]))
        out.append(await kv.pipe_execute({"h": ver}, [("set", "p", b"lost")]))
        out += [await kv.get("p"), await kv.watch_read("h")]
        v2 = await kv.version("p")
        out += [await kv.commit({"p": v2}, [("set", "p", b"r")]),
                await kv.commit({"p": v2}, [("set", "p", b"s")]), await kv.get("p"),
                await kv.ping()]
        # pub/sub: a queue group of two members on two connections, and a
        # plain subscriber on a third
        got = {"g1": [], "g2": [], "plain": []}

        def tap(name):
            async def handler(subject, pkt):
                got[name].append(pkt.job_request.job_id)
            return handler

        await bus2.subscribe("job.test.*", tap("g1"), queue="grp")
        await bus3.subscribe("job.test.*", tap("g2"), queue="grp")
        await bus.subscribe("job.test.>", tap("plain"))
        for i in range(N_PUBS):
            await bus.publish("job.test.x", types.BusPacket.wrap(
                types.JobRequest(job_id=f"j{i}", topic="job.test.x")))
        for _ in range(200):
            if len(got["plain"]) == N_PUBS and len(got["g1"]) + len(got["g2"]) == N_PUBS:
                break
            await asyncio.sleep(0.02)
        out += [sorted(got["plain"]), sorted(got["g1"] + got["g2"]),
                sorted((len(got["g1"]), len(got["g2"])))]
    finally:
        for c in (c1, c2, c3):
            await c.close()
    return out


async def _run(server_pkg, client_pkg):
    srv = server_pkg.infra.statebus.StateBusServer(port=0)
    await srv.start()
    try:
        return await asyncio.wait_for(_sequence(client_pkg, f"statebus://127.0.0.1:{srv.port}"),
                                      60)
    finally:
        await srv.stop()


def _pkgs():
    import cordum_tpu.infra.statebus  # noqa: F401
    import cordum_tpu.protocol.types  # noqa: F401
    import cordum_tpu_torch.infra.statebus  # noqa: F401
    import cordum_tpu_torch.protocol.types  # noqa: F401

    import cordum_tpu
    import cordum_tpu_torch

    return {"ref": cordum_tpu, "port": cordum_tpu_torch}


@pytest.mark.parametrize("server, client", [("port", "ref"), ("ref", "port"), ("port", "port")])
async def test_statebus_halves_interoperate(server, client):
    pkgs = _pkgs()
    want = await _run(pkgs["ref"], pkgs["ref"])
    got = await _run(pkgs[server], pkgs[client])
    assert got == want
    assert want[-1] == [N_PUBS // 2, N_PUBS // 2]  # round robin over the group


async def test_port_client_walks_a_replica_set_and_survives_a_goaway():
    """A replica set whose first endpoint is dead: the client dials on to
    the live primary (a role check each dial); a server stop (GOAWAY) and
    a restart on the same port: the client reconnects, resubscribes and a
    later publish still reaches its handler."""
    import socket

    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.protocol.types import BusPacket, JobRequest

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    srv = statebus.StateBusServer(port=0)
    await srv.start()
    port = srv.port
    kv, bus, conn = await statebus.connect(
        f"statebus://127.0.0.1:{dead}|statebus://127.0.0.1:{port}")
    got = []

    async def handler(subject, pkt):
        got.append(pkt.job_request.job_id)

    try:
        await bus.subscribe("job.x", handler)
        await kv.set("k", b"v")
        await srv.stop()
        srv = statebus.StateBusServer(port=port)
        await srv.start()
        await asyncio.wait_for(bus.publish("job.x", BusPacket.wrap(JobRequest(job_id="after"))), 20)
        for _ in range(200):
            if got:
                break
            await asyncio.sleep(0.02)
        assert got == ["after"] and conn.reconnect_count >= 1
        assert await kv.get("k") is None  # no AOF: a restarted server starts empty
    finally:
        await conn.close()
        await srv.stop()


def _cold_doc():
    return {"meta": {"job_id": "j1", "session_key": "s", "prompt_len": 20},
            "state": {"generated": [5, 6, 7], "max_new_tokens": 8, "temperature": 0.0},
            "records": [{"i": 0, "used": 16, "shape": [2, 16, 2, 16],
                         "k": bytes(range(256)) * 4, "v": b"\x7f" * 1024},
                        {"i": 1, "used": 4, "shape": [2, 16, 2, 16], "k": b"", "v": b"\x00"}]}


@pytest.mark.parametrize("writer", ["ref", "port"])
async def test_cold_tier_journal_reads_back_in_the_other_package(writer):
    from cordum_tpu.serving.tiering import StatebusColdTier as RefTier
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.serving.tiering import StatebusColdTier as PortTier

    kv = MemoryKV()
    tiers = {"ref": RefTier, "port": PortTier}
    write = tiers[writer](kv, worker_id="w1")
    write.put("sess-a", _cold_doc())
    write.put("sess-b", {"meta": {}, "state": {}, "records": []})
    write.pop("sess-b")
    await write.flush()
    assert await kv.keys("serving:cold:") == ["serving:cold:w1:sess-a"]
    import msgpack

    assert await kv.get("serving:cold:w1:sess-a") == msgpack.packb(_cold_doc(), use_bin_type=True)
    read = tiers["port" if writer == "ref" else "ref"](kv, worker_id="w1")
    assert await read.load() == 1
    assert read.get("sess-a") == _cold_doc() and read.bytes == write.bytes


def test_pools_file_parses_as_the_reference_parses_it():
    import yaml

    from cordum_tpu.infra import config as ref_config
    from cordum_tpu_torch.infra import config as port_config

    got = port_config.load_pool_config("config/pools.yaml")
    want = ref_config.load_pool_config("config/pools.yaml")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [p.name for p in got.pools_for_topic("job.tpu.embed")] == ["tpu"]
    missing = port_config.load_pool_config("config/no-such-file.yaml")
    assert dataclasses.asdict(missing) == dataclasses.asdict(
        ref_config.load_pool_config("config/no-such-file.yaml"))
    doc = yaml.safe_load(open("config/pools.yaml"))
    doc["pools"]["tpu"]["serving_cache_pages"] = "many"
    with pytest.raises(ValueError):
        port_config.parse_pool_config(doc)


def test_worker_boots_on_defaults_when_the_pools_file_is_unreadable(tmp_path, monkeypatch):
    from cordum_tpu_torch.cmd import worker as cmd_worker
    from cordum_tpu_torch.infra import config as port_config

    bad = tmp_path / "pools.yaml"
    bad.write_text("pools:\n  gpu-default:\n    max_batch_size: lots\n")
    monkeypatch.setenv("POOL_CONFIG_PATH", str(bad))
    assert cmd_worker._pool_limits(port_config.load(), "gpu-default") is None
    monkeypatch.setenv("POOL_CONFIG_PATH", "config/pools.yaml")
    assert cmd_worker._pool_limits(port_config.load(), "tpu").serving_cache_pages == 128
