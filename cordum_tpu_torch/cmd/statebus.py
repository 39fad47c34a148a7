"""Statebus server binary: ``python -m cordum_tpu_torch.cmd.statebus``.

Serves one keyspace partition on ``STATEBUS_HOST``:``STATEBUS_PORT``
(default 127.0.0.1:7420) until SIGTERM or SIGINT; a stop sends every
client a GOAWAY.  ``STATEBUS_PARTITION_INDEX=p`` serves partition ``p`` on
``STATEBUS_PORT + p`` (one process per partition, as production runs the
reference's).  The port's server keeps no append-only file and does not
replicate: ``STATEBUS_AOF``, ``STATEBUS_PARTITIONS`` > 1 and
``--replica-of`` / ``STATEBUS_REPLICA_OF`` are refused (ROADMAP: still to
port).
"""
from __future__ import annotations

import asyncio
import os

from ..infra.statebus import StateBusServer
from . import _boot


async def main() -> None:
    _boot.setup()
    env = os.environ
    unported = [k for k in ("STATEBUS_AOF", "STATEBUS_REPLICA_OF", "STATEBUS_PEERS",
                            "STATEBUS_SYNC_REPLICATION") if env.get(k)]
    if unported or _boot.env_int("STATEBUS_PARTITIONS", 1) > 1:
        raise SystemExit(
            f"cordum_tpu_torch statebus: {unported or ['STATEBUS_PARTITIONS']} not ported "
            "(the AOF, replication and multi-partition processes are ROADMAP work); "
            "run one process per partition with STATEBUS_PARTITION_INDEX")
    only = _boot.env_int("STATEBUS_PARTITION_INDEX", -1)
    port = _boot.env_int("STATEBUS_PORT", 7420) + max(only, 0)
    server = StateBusServer(env.get("STATEBUS_HOST", "127.0.0.1"), port, partition=only)
    await server.start()
    try:
        await _boot.wait_for_shutdown()
    finally:
        await server.stop()


if __name__ == "__main__":
    asyncio.run(main())
