"""Dispatch-subject selection strategies.

``LeastLoadedStrategy`` recreates the reference semantics
(``core/controlplane/scheduler/strategy_least_loaded.go:40-262``) with
TPU-slice awareness:

  * topic → eligible pools from :class:`~cordum_tpu_torch.infra.config.PoolConfig`
  * pool eligibility: worker capabilities must cover the pool's ``requires``
    *and* the job's own ``metadata.requires``; TPU constraints
    (``chips:N``, ``topology:AxBxC``, pool ``min_chips``/``topology``/
    ``device_kind``) are matched against heartbeat slice telemetry
  * label hints: ``preferred_worker_id`` / ``preferred_pool``; placement
    labels (``placement.<k>=<v>`` must equal the worker's label ``<k>``)
  * overload skip: ≥90% of ``max_parallel_jobs``, or cpu ≥90, or TPU duty
    cycle ≥90, or unhealthy devices
  * score = ``active_jobs + cpu_load/100 + tpu_duty_cycle/100`` (reference
    used gpu_utilization; TPU duty cycle is the analogue); least wins
  * batch affinity: jobs carrying the ``cordum.batch_key`` label stick to
    the worker that last won for that key (TTL'd), so the worker-side
    micro-batch queues actually fill instead of each job landing on a
    different slice (docs/BATCHING.md)
  * session affinity (the serving generalization of batch affinity): jobs
    carrying ``cordum.session_key`` stick to the worker holding that
    conversation's KV pages, with a much longer TTL sized to conversation
    gaps rather than batch-fill windows (docs/SERVING.md); hit/miss/new
    outcomes feed ``cordum_session_affinity_total``
  * chosen worker → direct subject ``worker.<id>.jobs``; no worker →
    topic fan-in subject (queue-group consumption)

``update_routing`` atomically swaps the pool config (hot reload path).
"""
from __future__ import annotations

import itertools
import re
import time
from typing import Optional

from ...infra.config import Pool, PoolConfig
from ...infra.registry import WorkerRegistry
from ...protocol.subjects import direct_subject
from ...protocol.types import (
    Heartbeat,
    JobRequest,
    LABEL_BATCH_KEY,
    LABEL_OP,
    LABEL_SESSION_KEY,
    LABEL_SPECULABLE,
    SERVING_OPS,
)

_CHIPS_RE = re.compile(r"^chips:(\d+)$")
_TOPOLOGY_RE = re.compile(r"^topology:([0-9x]+)$")

OVERLOAD_FRACTION = 0.9
OVERLOAD_UTIL = 90.0
HBM_OVERLOAD_FRACTION = 0.95
BATCH_AFFINITY_TTL_S = 5.0
# Sessions outlive batch-fill windows: the TTL covers think-time between a
# conversation's turns, after which its KV pages are presumed reclaimed and
# re-routing is free.
SESSION_AFFINITY_TTL_S = 120.0
# Hibernated sessions keep affinity alive far past the normal TTL: their KV
# lives in the owning worker's host-RAM cold arena (docs/SERVING.md §Prefix
# cache and tiering), so the "pages presumed reclaimed" assumption behind the
# 120s TTL does not apply — routing the next turn anywhere else silently
# degrades to a cold re-prefill.  SessionMoved(reason="hibernated") pins the
# entry; reason="restored" (or any normal retarget) unpins it.
SESSION_HIBERNATE_TTL_S = 3600.0
_AFFINITY_CAP = 1024
# internal key namespace so an arbitrary session id can never collide with
# a batch key (batch keys stay raw for back-compat)
_SESSION_PREFIX = "session\x00"


class Strategy:
    def pick_subject(self, req: JobRequest) -> str:
        raise NotImplementedError

    def pick_subjects(self, reqs: list[JobRequest]) -> list[str]:
        """Batched selection (scheduler tick batching): one subject per
        request.  The default just loops; strategies that scan state
        per pick override this to amortize the scan across the batch."""
        return [self.pick_subject(r) for r in reqs]


class NaiveStrategy(Strategy):
    """Topic passthrough (reference strategy_naive.go)."""

    def pick_subject(self, req: JobRequest) -> str:
        return req.topic


def _parse_tpu_requires(requires: list[str]) -> tuple[list[str], int, str]:
    """Split requires into plain capabilities vs TPU constraints."""
    caps: list[str] = []
    min_chips = 0
    topology = ""
    for r in requires:
        m = _CHIPS_RE.match(r)
        if m:
            min_chips = max(min_chips, int(m.group(1)))
            continue
        m = _TOPOLOGY_RE.match(r)
        if m:
            topology = m.group(1)
            continue
        caps.append(r)
    return caps, min_chips, topology


def pool_requirement_mismatch(hb: Heartbeat, pool: Optional[Pool]) -> str:
    """Why a worker fails its pool's slice-requirement keys (pools.yaml
    ``min_chips`` / ``topology`` / ``device_kind``), or ``""`` when it
    passes.  Split out so the exclusion can be *announced* — a worker
    silently dropped from its own pool's routing is a misconfiguration the
    operator should hear about once, not discover via starvation."""
    if pool is None:
        return ""
    if pool.min_chips and hb.chip_count < pool.min_chips:
        return (f"advertises {hb.chip_count} chips < pool min_chips "
                f"{pool.min_chips}")
    if pool.topology and hb.slice_topology != pool.topology:
        return (f"topology {hb.slice_topology or '(none)'} != pool topology "
                f"{pool.topology}")
    if pool.device_kind and hb.device_kind and hb.device_kind != pool.device_kind:
        return (f"device_kind {hb.device_kind!r} != pool device_kind "
                f"{pool.device_kind!r}")
    return ""


# one-shot pool-exclusion warnings: (worker_id, pool_name) pairs already
# announced (capped so an unbounded worker churn can't grow it forever)
_POOL_EXCLUSION_WARNED: set[tuple[str, str]] = set()
_POOL_EXCLUSION_WARN_CAP = 4096


def warn_pool_exclusion(hb: Heartbeat, pool: Optional[Pool]) -> None:
    """Log ONCE per (worker, pool) when a worker is excluded from a pool's
    routing by the pool's slice-requirement keys."""
    reason = pool_requirement_mismatch(hb, pool)
    if not reason or pool is None:
        return
    key = (hb.worker_id, pool.name)
    if key in _POOL_EXCLUSION_WARNED:
        return
    if len(_POOL_EXCLUSION_WARNED) >= _POOL_EXCLUSION_WARN_CAP:
        _POOL_EXCLUSION_WARNED.clear()
    _POOL_EXCLUSION_WARNED.add(key)
    from ...infra import logging as logx

    logx.warn("worker excluded from pool routing",
              worker_id=hb.worker_id, pool=pool.name, reason=reason)


def worker_satisfies(
    hb: Heartbeat, pool: Optional[Pool], job_requires: list[str]
) -> bool:
    caps = set(hb.capabilities)
    req_caps, min_chips, topology = _parse_tpu_requires(job_requires)
    if pool is not None:
        pool_caps, pool_chips, pool_topology = _parse_tpu_requires(pool.requires)
        req_caps += pool_caps
        min_chips = max(min_chips, pool_chips, pool.min_chips)
        topology = topology or pool_topology or pool.topology
        if pool.device_kind and hb.device_kind and pool.device_kind != hb.device_kind:
            return False
    if not set(req_caps) <= caps:
        return False
    if min_chips and hb.chip_count < min_chips:
        return False
    # a worker reporting no topology cannot satisfy a topology requirement
    # (symmetric with the chips check above)
    if topology and hb.slice_topology != topology:
        return False
    return True


def is_overloaded(hb: Heartbeat) -> bool:
    if not hb.devices_healthy:
        return True
    if hb.draining:
        return True  # drain mode: finishing/migrating work, no new placements
    if hb.max_parallel_jobs > 0 and hb.active_jobs >= OVERLOAD_FRACTION * hb.max_parallel_jobs:
        return True
    if hb.cpu_load >= OVERLOAD_UTIL or hb.tpu_duty_cycle >= OVERLOAD_UTIL:
        return True
    # HBM pressure: a worker whose accelerator memory is effectively full
    # cannot take another placement even if its MXU duty cycle looks idle
    # (weights/KV arenas are resident; the next job would OOM, not queue)
    if hb.hbm_total_gb > 0 and hb.hbm_used_gb / hb.hbm_total_gb >= HBM_OVERLOAD_FRACTION:
        return True
    return False


def load_score(hb: Heartbeat) -> float:
    return hb.active_jobs + hb.cpu_load / 100.0 + hb.tpu_duty_cycle / 100.0


def _placement_labels(labels: dict[str, str]) -> dict[str, str]:
    return {
        k[len("placement."):]: v
        for k, v in labels.items()
        if k.startswith("placement.")
    }


class LeastLoadedStrategy(Strategy):
    def __init__(self, registry: WorkerRegistry, pool_config: PoolConfig, *,
                 native: bool = True, metrics=None):
        self.registry = registry
        self._pool_config = pool_config
        self.metrics = metrics
        # affinity: batch_key / namespaced session_key -> (worker_id, stamp)
        self._affinity: dict[str, tuple[str, float]] = {}
        # namespaced session keys whose entry uses SESSION_HIBERNATE_TTL_S
        # (the conversation's KV is tiered to that worker's cold arena)
        self._pinned: set[str] = set()
        # session-affinity outcome counters (the bench's affinity-hit-rate
        # source; mirrored to cordum_session_affinity_total when metrics set)
        self.session_affinity_hits = 0
        self.session_affinity_misses = 0
        self.session_affinity_new = 0
        self.session_affinity_evicted = 0
        self.session_affinity_retargeted = 0
        # routing caches: topic→pools and the native scan's
        # resolved arguments are identical for every job of one shape, so
        # re-deriving them per pick (regex parses, pool scans, ctypes array
        # builds) was pure hot-path overhead.  Both caches invalidate on
        # update_routing; native entries also carry the packed scan's
        # interning generation (tables grow when new pools/caps appear).
        self._topic_pools: dict[str, list[Pool]] = {}
        self._native_routes: dict[tuple, tuple] = {}
        self._packed = None
        if native:
            # no C compiler → pure python; a failed build or load raises
            from .native_scan import PackedWorkers

            packed = PackedWorkers(registry)
            if packed.available:
                self._packed = packed

    def update_routing(self, pool_config: PoolConfig) -> None:
        self._pool_config = pool_config
        self._topic_pools = {}
        self._native_routes = {}

    def _pools_for_topic(self, topic: str) -> list[Pool]:
        pools = self._topic_pools.get(topic)
        if pools is None:
            pools = self._pool_config.pools_for_topic(topic)
            if len(self._topic_pools) > 4096:
                self._topic_pools.clear()  # unbounded topic space guard
            self._topic_pools[topic] = pools
        return pools

    # -- batch affinity ---------------------------------------------------
    def _record_affinity(self, key: str, worker_id: str) -> None:
        if len(self._affinity) >= _AFFINITY_CAP:
            # amortized prune: drop the oldest half (insertion-ordered dict)
            for k in list(itertools.islice(self._affinity, _AFFINITY_CAP // 2)):
                del self._affinity[k]
                self._pinned.discard(k)
        self._affinity[key] = (worker_id, time.monotonic())
        # recording is (re-)election: only the hibernate retarget re-pins
        self._pinned.discard(key)

    def evict_worker(self, worker_id: str) -> int:
        """Invalidate every affinity entry (session AND batch) pointing at
        ``worker_id`` — called when a worker deregisters, drains, or misses
        heartbeats, so session turns stop routing to a dead/draining worker
        for up to the 120s session TTL.  Returns the number of entries
        dropped; session evictions count in
        ``cordum_session_affinity_total{outcome="evicted"}``."""
        dead = [k for k, (wid, _) in self._affinity.items() if wid == worker_id]
        for k in dead:
            del self._affinity[k]
            self._pinned.discard(k)  # dead worker's cold arena died with it
            if k.startswith(_SESSION_PREFIX):
                self._count_session_affinity("evicted")
        return len(dead)

    def _affinity_worker(
        self, key: str, pools: list[Pool], job_requires: list[str],
        placement: dict[str, str], ttl_s: float = BATCH_AFFINITY_TTL_S,
    ) -> str:
        """The sticky worker for an affinity key, if it is still a legal
        target.  An overloaded / vanished / no-longer-eligible sticky worker
        returns "" so the scan below elects (and records) a new one — the
        whole key's queue (or session) migrates together instead of smearing
        across workers."""
        ent = self._affinity.get(key)
        if ent is None:
            return ""
        worker_id, stamped = ent
        if key in self._pinned:
            ttl_s = SESSION_HIBERNATE_TTL_S  # cold-arena keepalive
        if time.monotonic() - stamped >= ttl_s:
            self._affinity.pop(key, None)
            self._pinned.discard(key)
            return ""
        hb = self.registry.get(worker_id)
        if hb is None or hb.draining:
            # missed-heartbeat / draining worker: drop the entry outright
            # (lazy mirror of evict_worker) instead of leaving it to block
            # the key until the TTL expires
            self._affinity.pop(key, None)
            self._pinned.discard(key)
            if key.startswith(_SESSION_PREFIX):
                self._count_session_affinity("evicted")
            return ""
        if is_overloaded(hb):
            return ""
        pool = next((p for p in pools if p.name == hb.pool), None)
        if pool is None:
            return ""
        if not worker_satisfies(hb, pool, job_requires):
            return ""
        if placement and any(hb.labels.get(k) != v for k, v in placement.items()):
            return ""
        self._affinity[key] = (worker_id, time.monotonic())  # sliding TTL
        return worker_id

    def _native_pick(self, req: JobRequest, pools, job_requires) -> Optional[str]:
        """Native packed scan for the common shape; LookupError → python.

        The per-shape resolution (pool-uniformity validation, requires
        parsing, capability-bit and pool-id interning, the ctypes pools
        array) is cached per ``(topic, requires)`` — only the C scan itself
        runs per pick."""
        packed = self._packed
        if packed is None:
            raise LookupError("native disabled")
        packed.refresh()  # rebuild pack if registry moved; may bump intern_gen
        key = (req.topic, tuple(job_requires), tuple(p.name for p in pools))
        ent = self._native_routes.get(key)
        if ent is None or ent[0] != packed.intern_gen:
            prep = self._resolve_native_route(pools, job_requires, packed)
            if len(self._native_routes) > 4096:
                self._native_routes.clear()
            ent = (packed.intern_gen, prep)
            self._native_routes[key] = ent
        prep = ent[1]
        if prep is None:
            raise LookupError("shape not modeled by native scan")
        return packed.pick_prepared(prep)

    def _resolve_native_route(self, pools, job_requires, packed):
        """→ prepared native-scan args, or None for shapes the C kernel
        doesn't model (cached either way)."""
        first = pools[0]
        # pools must agree on constraints for the single-pass C scan
        for p in pools[1:]:
            if (p.requires, p.min_chips, p.topology, p.device_kind) != (
                first.requires, first.min_chips, first.topology, first.device_kind
            ):
                return None
        if first.device_kind:
            return None  # device_kind filter not in native scan
        req_caps, min_chips, topology = _parse_tpu_requires(job_requires)
        pool_caps, pool_chips, pool_topology = _parse_tpu_requires(first.requires)
        try:
            return packed.prepare(
                required_caps=req_caps + pool_caps,
                pool_names=[p.name for p in pools],
                min_chips=max(min_chips, pool_chips, first.min_chips),
                topology=topology or pool_topology or first.topology,
            )
        except LookupError:
            return None

    def pick_subjects(self, reqs: list[JobRequest]) -> list[str]:
        """Batched selection: jobs sharing a routing shape (topic, requires,
        routing labels) within one tick share ONE scan — the registry is
        static between heartbeats, so sequential picks would return the
        same worker anyway."""
        memo: dict[tuple, str] = {}
        out: list[str] = []
        for req in reqs:
            key = self._shape_key(req)
            hit = memo.get(key)
            if hit is None:
                hit = self.pick_subject(req)
                memo[key] = hit
            out.append(hit)
        return out

    @staticmethod
    def _shape_key(req: JobRequest) -> tuple:
        labels = req.labels or {}
        routing = tuple(sorted(
            (k, v) for k, v in labels.items()
            if k in ("preferred_worker_id", "preferred_pool",
                     LABEL_BATCH_KEY, LABEL_SESSION_KEY)
            or k.startswith("placement.")
        ))
        requires = tuple(req.metadata.requires) if req.metadata else ()
        return (req.topic, requires, routing)

    def _count_session_affinity(self, outcome: str) -> None:
        if outcome == "hit":
            self.session_affinity_hits += 1
        elif outcome == "miss":
            self.session_affinity_misses += 1
        elif outcome == "evicted":
            self.session_affinity_evicted += 1
        elif outcome == "retargeted":
            self.session_affinity_retargeted += 1
        else:
            self.session_affinity_new += 1
        if self.metrics is not None:
            self.metrics.session_affinity.inc(outcome=outcome)

    def retarget_session(
        self, session_key: str, worker_id: str, *, pinned: bool = False
    ) -> None:
        """Point a session's affinity at its new owner — a ``SessionMoved``
        announcement after a hand-off/rebalance/drain migration commits
        (docs/SERVING.md §Disaggregation).  Follow-up turns and cancels
        then route to the worker actually holding the KV pages instead of
        the original placement.  ``pinned`` (reason="hibernated") switches
        the entry to :data:`SESSION_HIBERNATE_TTL_S`; any later normal
        retarget — including reason="restored" — unpins it."""
        if not session_key or not worker_id:
            return
        key = _SESSION_PREFIX + session_key
        self._record_affinity(key, worker_id)
        if pinned:
            self._pinned.add(key)
        self._count_session_affinity("retargeted")

    def pick_subject(self, req: JobRequest) -> str:
        labels = req.labels or {}
        job_requires = list(req.metadata.requires) if req.metadata else []

        pools = self._pools_for_topic(req.topic)
        if not pools:
            # topic not mapped to any pool: fan-in on the topic subject —
            # never direct-dispatch to workers whose pools don't serve it
            return req.topic
        placement = _placement_labels(labels)

        # direct worker hint — still subject to capability/placement checks so
        # a hint can never route a job to a worker that cannot run it
        preferred_worker = labels.get("preferred_worker_id", "")
        if preferred_worker:
            hb = self.registry.get(preferred_worker)
            if hb is not None and not is_overloaded(hb):
                pool = next((p for p in pools if p.name == hb.pool), None) if pools else None
                pool_ok = pool is not None or not pools
                placement_ok = all(hb.labels.get(k) == v for k, v in placement.items())
                if pool_ok and placement_ok and worker_satisfies(hb, pool, job_requires):
                    return direct_subject(preferred_worker)
        preferred_pool = labels.get("preferred_pool", "")
        if preferred_pool:
            hinted = [p for p in pools if p.name == preferred_pool]
            if hinted:
                pools = hinted

        # session affinity: a conversation's decode turns ride to the worker
        # holding its KV pages (the serving generalization of batch affinity;
        # explicit worker hints still win above)
        session_key = labels.get(LABEL_SESSION_KEY, "")
        session_akey = ""
        if session_key:
            session_akey = _SESSION_PREFIX + session_key
            had_entry = session_akey in self._affinity
            sticky = self._affinity_worker(
                session_akey, pools, job_requires, placement,
                ttl_s=SESSION_AFFINITY_TTL_S,
            )
            if sticky:
                self._count_session_affinity("hit")
                return direct_subject(sticky)
            # a dead entry (expired / evicted) means the session's pages are
            # on a worker we can no longer use: a true migration, vs "new"
            # for the first routing of a session
            self._count_session_affinity("miss" if had_entry else "new")

        # batch affinity: same-key jobs ride to the sticky worker so its
        # micro-batch queues fill (explicit worker hints still win above)
        batch_key = labels.get(LABEL_BATCH_KEY, "")
        if batch_key:
            sticky = self._affinity_worker(batch_key, pools, job_requires, placement)
            if sticky:
                if session_akey:
                    # a session-carrying job routed by its batch key (e.g. a
                    # workflow turn riding wf-tpl template co-location) must
                    # still elect its session entry, or every later turn of
                    # the run re-counts "new" and can never hit
                    self._record_affinity(session_akey, sticky)
                return direct_subject(sticky)

        # native packed scan (the hot path: no hints, uniform pools)
        if not placement and not preferred_worker:
            try:
                winner = self._native_pick(req, pools, job_requires)
                if winner:
                    if batch_key:
                        self._record_affinity(batch_key, winner)
                    if session_akey:
                        self._record_affinity(session_akey, winner)
                return direct_subject(winner) if winner else req.topic
            except LookupError:
                pass  # shapes the C kernel doesn't model → python scan

        best_worker = ""
        best_score = float("inf")
        for hb in self.registry.snapshot().values():
            # pool membership: worker's reported pool must be one of the
            # topic's pools (when the topic maps to pools at all)
            pool: Optional[Pool] = None
            if pools:
                matched = [p for p in pools if p.name == hb.pool]
                if not matched:
                    continue
                pool = matched[0]
            if not worker_satisfies(hb, pool, job_requires):
                # pools.yaml min_chips/topology/device_kind exclusions are
                # announced once per (worker, pool) — a worker dropped from
                # its OWN pool's routing is a config problem, not noise
                warn_pool_exclusion(hb, pool)
                continue
            if placement and any(hb.labels.get(k) != v for k, v in placement.items()):
                continue
            if is_overloaded(hb):
                continue
            score = load_score(hb)
            if score < best_score or (score == best_score and hb.worker_id < best_worker):
                best_score = score
                best_worker = hb.worker_id
        if best_worker:
            if batch_key:
                self._record_affinity(batch_key, best_worker)
            if session_akey:
                self._record_affinity(session_akey, best_worker)
            return direct_subject(best_worker)
        return req.topic


class ThroughputAwareStrategy(LeastLoadedStrategy):
    """Heterogeneity-aware routing on the measured throughput matrix
    (Gavel, PAPERS.md; ROADMAP item 1 — the capacity observatory's first
    data-plane consumer).

    Each job carrying the gateway-stamped ``cordum.op`` label routes to
    eligible workers in proportion to their measured **steady-state
    headroom** for that op: ``items/s × (1 − load_fraction)`` from the
    :class:`~cordum_tpu_torch.obs.capacity.CapacityView`, distributed by smooth
    weighted round-robin (nginx-style: deterministic, starvation-free — a
    3× faster worker gets exactly 3× the jobs).  Workers the matrix has
    not measured for the op get the median measured weight so they receive
    traffic and *become* measured.

    Degradation ladder (each step is exact LeastLoaded behavior):
    affinity/hint/placement-labeled jobs delegate wholesale (sticky
    sessions beat throughput); ops with NO fresh measured row fall back to
    the LeastLoaded scan; an absent CapacityView disables the override
    entirely.
    """

    def __init__(self, registry: WorkerRegistry, pool_config: PoolConfig, *,
                 capacity=None, placer=None, native: bool = True,
                 metrics=None):
        super().__init__(registry, pool_config, native=native, metrics=metrics)
        self.capacity = capacity
        # role-aware serving placement (docs/SERVING.md §Disaggregation):
        # new llm.generate sessions route by measured prefill tokens/s
        # headroom instead of the generic items/s WRR
        self.placer = placer
        # smooth-WRR state per op: worker → current credit
        self._wrr: dict[str, dict[str, float]] = {}
        self.routed_measured = 0
        self.routed_fallback = 0
        self.routed_placed = 0

    _ROUTING_LABELS = ("preferred_worker_id", "preferred_pool",
                       LABEL_BATCH_KEY, LABEL_SESSION_KEY)

    def pick_subjects(self, reqs: list[JobRequest]) -> list[str]:
        # no shape memoization: the WRR must distribute jobs WITHIN a tick
        # (the parent's one-pick-per-shape would send a whole tick batch to
        # one worker, defeating proportional routing)
        return [self.pick_subject(r) for r in reqs]

    def _eligible_workers(self, req: JobRequest, pools,
                          job_requires) -> list[Heartbeat]:
        out: list[Heartbeat] = []
        for hb in self.registry.snapshot().values():
            pool = next((p for p in pools if p.name == hb.pool), None)
            if pool is None:
                continue
            if not worker_satisfies(hb, pool, job_requires):
                warn_pool_exclusion(hb, pool)
                continue
            if is_overloaded(hb):
                continue
            out.append(hb)
        return out

    def _pick_serving(self, req: JobRequest, labels: dict) -> str:
        """Role-aware placement for a serving job (docs/SERVING.md
        §Disaggregation).  A follow-up turn rides its session affinity to
        the page-holding worker (retargeted on migration); a NEW session
        goes to the placer's best measured prefill-headroom worker.
        Returns "" when the placer has nothing analytic to say — the
        caller degrades to the generic measured-items/s routing."""
        pools = self._pools_for_topic(req.topic)
        if not pools:
            return ""
        job_requires = list(req.metadata.requires) if req.metadata else []
        session_key = labels.get(LABEL_SESSION_KEY, "")
        session_akey = ""
        had_entry = False
        if session_key:
            session_akey = _SESSION_PREFIX + session_key
            had_entry = session_akey in self._affinity
            sticky = self._affinity_worker(
                session_akey, pools, job_requires, {},
                ttl_s=SESSION_AFFINITY_TTL_S,
            )
            if sticky:
                self._count_session_affinity("hit")
                return direct_subject(sticky)
        winner = self.placer.pick(
            self._eligible_workers(req, pools, job_requires),
            speculable=bool(labels.get(LABEL_SPECULABLE)),
        )
        if not winner:
            # no counting here: the caller's fallback re-runs the affinity
            # check and counts the outcome exactly once
            return ""
        if session_akey:
            self._count_session_affinity("miss" if had_entry else "new")
            self._record_affinity(session_akey, winner)
        self.routed_placed += 1
        return direct_subject(winner)

    def pick_subject(self, req: JobRequest) -> str:
        labels = req.labels or {}
        # serving jobs take the role-aware placement path FIRST: session
        # affinity is honored inside it (sticky turns beat throughput), and
        # only hint/placement-labeled jobs bypass it entirely
        if (
            self.placer is not None
            and labels.get(LABEL_OP, "") in SERVING_OPS
            and not labels.get("preferred_worker_id")
            and not labels.get("preferred_pool")
            and not labels.get(LABEL_BATCH_KEY)
            and not any(k.startswith("placement.") for k in labels)
        ):
            subject = self._pick_serving(req, labels)
            if subject:
                return subject
        if self.capacity is None or any(
            labels.get(k) for k in self._ROUTING_LABELS
        ) or any(k.startswith("placement.") for k in labels):
            return super().pick_subject(req)
        op = labels.get(LABEL_OP, "")
        if not op:
            return super().pick_subject(req)
        pools = self._pools_for_topic(req.topic)
        if not pools:
            return req.topic
        job_requires = list(req.metadata.requires) if req.metadata else []
        candidates = self._eligible_workers(req, pools, job_requires)
        if not candidates:
            return req.topic
        measured = {
            hb.worker_id: self.capacity.rate(hb.worker_id, op)
            for hb in candidates
        }
        rates = sorted(r for r in measured.values() if r > 0)
        if not rates:
            # matrix empty/stale for this op: exact LeastLoaded behavior
            self.routed_fallback += 1
            return super().pick_subject(req)
        median = rates[len(rates) // 2]
        weights: dict[str, float] = {}
        for hb in candidates:
            base = measured[hb.worker_id] or median
            if hb.max_parallel_jobs > 0:
                load_frac = min(1.0, hb.active_jobs / hb.max_parallel_jobs)
            else:
                load_frac = min(1.0, load_score(hb) / 16.0)
            weights[hb.worker_id] = base * max(0.1, 1.0 - load_frac)
        winner = self._wrr_pick(op, weights)
        self.routed_measured += 1
        return direct_subject(winner)

    def _wrr_pick(self, op: str, weights: dict[str, float]) -> str:
        """Smooth weighted round-robin: add each worker's weight to its
        credit, pick the max, subtract the total — selections converge to
        exact weight proportions with no randomness and no starvation."""
        if len(self._wrr) > 1024:
            self._wrr.clear()  # unbounded-op-space guard
        state = self._wrr.setdefault(op, {})
        for gone in [w for w in state if w not in weights]:
            del state[gone]
        total = sum(weights.values())
        best, best_credit = "", float("-inf")
        for wid, w in sorted(weights.items()):
            credit = state.get(wid, 0.0) + w
            state[wid] = credit
            if credit > best_credit:
                best, best_credit = wid, credit
        state[best] -= total
        return best
