"""Packed-array worker selection backed by the native C scan.

Maintains parallel ctypes arrays rebuilt whenever the registry version
changes (heartbeats mutate it ~every 10s per worker; dispatches happen
thousands of times a second — the pack cost amortizes across dispatches).
Capabilities are interned to bits (≤64 distinct), pools and topologies to
integer ids.  Falls back to the Python scan for shapes the C kernel doesn't
model (placement labels, per-pool device_kind / divergent pool
requirements).  ``native_picks`` counts the picks the C scan served.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional

from ...infra.registry import WorkerRegistry
from ...native import load_strategy_scan
from .strategy import HBM_OVERLOAD_FRACTION, _parse_tpu_requires

REBUILD_INTERVAL_S = 1.0  # also time-bounded: TTL-expired workers must drop
                          # from the pack even when no heartbeat mutates the
                          # registry version (dead-worker case)


class PackedWorkers:
    def __init__(self, registry: WorkerRegistry):
        self.registry = registry
        self._built_version = -1
        self._built_at = 0.0
        self._degenerate = False  # >64 distinct capabilities → python only
        self._lib = load_strategy_scan()
        self._cap_ids: dict[str, int] = {}
        self._pool_ids: dict[str, int] = {"": 0}
        self._topo_ids: dict[str, int] = {"": 0}
        self.worker_ids: list[str] = []
        self.n = 0
        # bumped whenever an interning table grows: callers caching resolved
        # routes (strategy _native_routes) key their entries on this so a
        # newly appearing pool/capability invalidates stale resolutions
        self.intern_gen = 0
        # picks the native path answered (no Python scan), "no eligible
        # worker" answers included
        self.native_picks = 0

    @property
    def available(self) -> bool:
        return self._lib is not None

    def _cap_bit(self, cap: str) -> Optional[int]:
        bit = self._cap_ids.get(cap)
        if bit is None:
            if len(self._cap_ids) >= 64:
                return None  # capability space exhausted → python fallback
            bit = len(self._cap_ids)
            self._cap_ids[cap] = bit
            self.intern_gen += 1
        return bit

    def _intern(self, table: dict[str, int], value: str) -> int:
        vid = table.get(value)
        if vid is None:
            vid = len(table)
            table[value] = vid
            self.intern_gen += 1
        return vid

    def _rebuild(self) -> None:
        snap = self.registry.snapshot()
        ids = sorted(snap)  # deterministic ties: lowest worker id wins
        n = len(ids)
        self.worker_ids = ids
        self.n = n
        self._cap_bits = (ctypes.c_uint64 * n)()
        self._pool_id = (ctypes.c_int32 * n)()
        self._topo_id = (ctypes.c_int32 * n)()
        self._chips = (ctypes.c_int32 * n)()
        self._active = (ctypes.c_float * n)()
        self._maxp = (ctypes.c_float * n)()
        self._cpu = (ctypes.c_float * n)()
        self._duty = (ctypes.c_float * n)()
        self._healthy = (ctypes.c_uint8 * n)()
        self._has_labels = [False] * n
        for i, wid in enumerate(ids):
            hb = snap[wid]
            bits = 0
            for cap in hb.capabilities:
                b = self._cap_bit(cap)
                if b is None:
                    # capability space exhausted: the C scan can no longer
                    # model eligibility — disable the native path entirely
                    self._degenerate = True
                    break
                bits |= 1 << b
            self._cap_bits[i] = bits
            self._pool_id[i] = self._intern(self._pool_ids, hb.pool)
            self._topo_id[i] = self._intern(self._topo_ids, hb.slice_topology)
            self._chips[i] = hb.chip_count
            self._active[i] = float(hb.active_jobs)
            self._maxp[i] = float(hb.max_parallel_jobs)
            self._cpu[i] = float(hb.cpu_load)
            self._duty[i] = float(hb.tpu_duty_cycle)
            # eligibility byte for the C scan: device health AND the HBM
            # pressure gate (is_overloaded's memory leg — the kernel computes
            # the load legs from active/cpu/duty itself but never sees HBM)
            hbm_full = (hb.hbm_total_gb > 0 and
                        hb.hbm_used_gb / hb.hbm_total_gb
                        >= HBM_OVERLOAD_FRACTION)
            self._healthy[i] = 1 if (hb.devices_healthy and not hbm_full) else 0
        self._built_version = self.registry.version

    def refresh(self) -> None:
        """Rebuild the pack if the registry moved (or the rebuild interval
        lapsed).  Raises LookupError when the native path is unusable."""
        if self._lib is None or self._degenerate:
            raise LookupError("native scan unavailable")
        now = time.monotonic()
        if (
            self._built_version != self.registry.version
            or now - self._built_at > REBUILD_INTERVAL_S
        ):
            self._rebuild()
            self._built_at = now
            if self._degenerate:
                raise LookupError("capability space exhausted")

    def prepare(
        self,
        *,
        required_caps: list[str],
        pool_names: list[str],
        min_chips: int,
        topology: str,
    ) -> tuple:
        """Resolve a routing shape to ready-to-call C-scan arguments.  The
        result is cacheable until ``intern_gen`` changes (a pool/cap that
        didn't exist at prepare time may exist later)."""
        req_caps = 0
        for cap in required_caps:
            b = self._cap_bit(cap)
            if b is None:
                raise LookupError("capability space exhausted")
            req_caps |= 1 << b
        pools = [self._pool_ids[p] for p in pool_names if p in self._pool_ids]
        arr = (ctypes.c_int32 * max(1, len(pools)))(*pools or [0])
        return (
            ctypes.c_uint64(req_caps), arr, len(pools), bool(pool_names),
            ctypes.c_int32(min_chips), topology,
        )

    def pick_prepared(self, prep: tuple) -> Optional[str]:
        """Run the C scan with :meth:`prepare`'d arguments.  Caller must
        :meth:`refresh` first (one refresh covers a whole batch of picks)."""
        req_caps, arr, n_pools, had_pools, min_chips, topology = prep
        self.native_picks += 1
        if self.n == 0:
            return None
        if had_pools and not n_pools:
            return None  # none of the eligible pools has live workers
        if topology and topology not in self._topo_ids:
            return None  # no worker reports this topology
        topo_id = self._topo_ids.get(topology, 0) if topology else 0
        idx = self._lib.pick_worker(
            self.n, self._cap_bits, self._pool_id, self._topo_id, self._chips,
            self._active, self._maxp, self._cpu, self._duty, self._healthy,
            req_caps, arr, n_pools,
            min_chips, ctypes.c_int32(topo_id),
        )
        if idx < 0:
            return None
        return self.worker_ids[idx]

    def pick(
        self,
        *,
        required_caps: list[str],
        pool_names: list[str],
        min_chips: int,
        topology: str,
    ) -> Optional[str]:
        """Returns the chosen worker id, None for no-eligible-worker, or
        raises LookupError when this request can't use the native path."""
        self.refresh()
        return self.pick_prepared(self.prepare(
            required_caps=required_caps, pool_names=pool_names,
            min_chips=min_chips, topology=topology,
        ))
