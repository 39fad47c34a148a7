"""Statebus server binary: ``python -m cordum_tpu_torch.cmd.statebus``.

``STATEBUS_PARTITIONS=N`` serves N keyspace partitions from one process on
consecutive ports (STATEBUS_PORT .. STATEBUS_PORT+N-1), each with its own
AOF (``<STATEBUS_AOF>.<p>``) — the dev/smoke topology.  Production runs one
process per partition: ``STATEBUS_PARTITION_INDEX=p`` starts only partition
``p`` on ``STATEBUS_PORT+p``.  Clients list every endpoint in
``CORDUM_STATEBUS_URL`` (comma-separated; ``|``-separated replica sets per
partition) and route by keyspace.

Replication (docs/PROTOCOL.md §Replication): start a partition's replica
with ``--replica-of statebus://host:port`` (env ``STATEBUS_REPLICA_OF``).
The replica tails the primary's committed-record stream, serves reads, and
is promoted on primary failure — automatically after
``STATEBUS_HEARTBEAT_TIMEOUT`` quiet seconds (disable with
``STATEBUS_AUTO_PROMOTE=0``), or explicitly via the admin ``promote``
frame.  ``STATEBUS_PEERS`` lists the partition's full replica set so a
restarted old primary probes its peers and demotes itself when a
higher-epoch primary exists (no split-brain).
``STATEBUS_SYNC_REPLICATION=1`` makes every commit wait for one replica
ack before the client sees ok (zero acked-commit loss on primary death).
Defaults for the replication knobs may also come from the ``statebus:``
stanza in pools.yaml (env wins).  Every server keeps the reference's
record bytes, so its AOF replays in either package.

The import closure holds no ``torch``, ``msgpack`` or device code: the
statebus binds before the rest of the stack dials in.
"""
from __future__ import annotations

import argparse
import asyncio
import os

from ..infra.statebus import StateBusServer
from . import _boot


def _aof_path(base: str, partition: int, partitions: int) -> str:
    if not base:
        return ""
    return base if partitions <= 1 else f"{base}.{partition}"


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="cordum-statebus", description="statebus partition server")
    p.add_argument("--replica-of", default=os.environ.get("STATEBUS_REPLICA_OF", ""),
                   help="primary endpoint this server replicates "
                        "(statebus://host:port); empty = start as primary")
    p.add_argument("--peers", default=os.environ.get("STATEBUS_PEERS", ""),
                   help="comma-separated replica-set endpoints for this "
                        "partition (startup probe demotes a stale primary)")
    p.add_argument("--sync-replication", action="store_true",
                   default=_env_bool("STATEBUS_SYNC_REPLICATION", False),
                   help="commits wait for one replica ack before acking")
    p.add_argument("--no-auto-promote", action="store_true",
                   default=not _env_bool("STATEBUS_AUTO_PROMOTE", True),
                   help="never self-promote on primary-dead (admin-only)")
    return p.parse_args(argv)


def _pool_statebus_defaults() -> dict:
    """The pools.yaml ``statebus:`` stanza (missing file → {}); env wins.

    Read with a bare yaml.safe_load, NOT the full config loader: its
    jsonschema import chain costs close to a second on small hosts, and
    the statebus must bind before the rest of the stack dials in.  The
    stanza still schema-validates wherever the full config IS loaded
    (scheduler, tests)."""
    path = os.environ.get("POOL_CONFIG_PATH", "config/pools.yaml")
    try:
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        return dict(doc.get("statebus") or {})
    except Exception:  # noqa: BLE001 - optional defaults; env still applies
        return {}


async def main(argv=None) -> None:
    _boot.setup()
    args = parse_args(argv)
    defaults = _pool_statebus_defaults()
    host = os.environ.get("STATEBUS_HOST", "127.0.0.1")
    port = _boot.env_int("STATEBUS_PORT", 7420)
    aof = os.environ.get("STATEBUS_AOF", "")
    partitions = max(1, _boot.env_int("STATEBUS_PARTITIONS", 1))
    only = _boot.env_int("STATEBUS_PARTITION_INDEX", -1)
    sync = args.sync_replication or bool(defaults.get("sync_replication"))
    hb_timeout = _boot.env_float(
        "STATEBUS_HEARTBEAT_TIMEOUT",
        float(defaults.get("heartbeat_timeout_s", 3.0)))
    hb_interval = _boot.env_float(
        "STATEBUS_HEARTBEAT_INTERVAL", min(1.0, max(0.05, hb_timeout / 3)))
    peers = tuple(p.strip() for p in args.peers.split(",") if p.strip())
    indices = [only] if 0 <= only < partitions else list(range(partitions))
    servers = [
        StateBusServer(
            host, port + p, aof_path=_aof_path(aof, p, partitions),
            replica_of=args.replica_of, peers=peers,
            sync_replication=sync, auto_promote=not args.no_auto_promote,
            heartbeat_interval_s=hb_interval, heartbeat_timeout_s=hb_timeout,
            partition=p if partitions > 1 or only >= 0 else -1,
        )
        for p in indices
    ]
    for srv in servers:
        await srv.start()
    try:
        await _boot.wait_for_shutdown()
    finally:
        # SIGTERM path: each stop() fsyncs the AOF and broadcasts GOAWAY so
        # clients fail over immediately instead of waiting out heartbeats
        for srv in servers:
            await srv.stop()


if __name__ == "__main__":
    asyncio.run(main())
