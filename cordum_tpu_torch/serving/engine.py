"""The continuous-batching loop (the serving subsystem's scheduler).

Lifecycle of an ``llm.generate`` session (docs/SERVING.md):

  * :meth:`ServingEngine.submit` parks the session in the **admission
    queue**; admission allocates its full worst-case page footprint
    (prompt + max_new_tokens) so an admitted session can never die
    mid-decode from cache pressure — exhaustion just delays admission;
  * admitted sessions join the step loop immediately: their prompts
    **prefill in chunks inside the mixed step**, riding the token-budget
    headroom left after the decode rows (the FlexNPU co-location policy,
    PAPERS.md, realized the Ragged Paged Attention way — prefill and
    decode share ONE device call instead of racing for the device lock
    from separate executor threads);
  * every step assembles one ragged batch — one decode row per prefilled
    session plus up to ``max_concurrent_prefills`` prompt chunks within
    the backend's flat token budget — runs ONE device call (the single
    static-shape step), scatters tokens back, admits joiners and retires
    finishers; sessions join/leave mid-stream without perturbing each
    other's rows and without recompiling anything;
  * retirement (finish / cancel / failure) frees the session's pages back
    to the allocator and resolves the submit waiter.

Token streaming rides the session's ``on_tokens`` callback (the worker
publishes ``JobProgress`` packets with ``status_hint="stream"``); the
terminal ``JobResult`` carries the full token list for non-streaming
consumers.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

from ..infra import logging as logx
from ..protocol.types import OP_SERVING_PREFILL, SERVING_OPS
from .backend import StepEntry
from .pager import CacheExhausted, PageAllocator
from .prefixcache import PrefixCache, PrefixNode
from .tiering import SessionTiering

# on_tokens(new_tokens, n_generated, done) — the streaming sink
TokenSink = Callable[[list[int], int, bool], Awaitable[None]]

DEFAULT_MAX_SESSIONS = 8
DEFAULT_MAX_NEW_TOKENS = 64
# prefill chunks co-scheduled into one mixed step: more rows admit faster,
# but each chunk spends flat-buffer slots the decode rows also want
DEFAULT_MAX_CONCURRENT_PREFILLS = 2
# SLO classes whose prefill chunks take the step budget first
# (docs/ADMISSION.md §Serving)
INTERACTIVE_CLASSES = frozenset({"INTERACTIVE", "CRITICAL"})
# speculative decoding (docs/SERVING.md §Speculative decoding): default
# draft length cap, the per-session acceptance EWMA that throttles the
# next step's draft length, and the engine-level EWMA the capacity block
# publishes as spec_accept_rate
DEFAULT_DRAFT_K = 4
SPEC_EWMA_ALPHA = 0.4
SPEC_FLEET_ALPHA = 0.2


class SessionCancelled(Exception):
    """Session evicted by ``sys.job.cancel`` (queued, prefilling or
    decoding); the worker publishes an ordinary CANCELLED result."""


class SessionMigrated(Exception):
    """Session live-migrated to a peer worker (docs/SERVING.md §Migration,
    drain, and failover): the target owns the token stream and the terminal
    result now — the local waiter publishes NOTHING."""


class SessionRequeued(Exception):
    """Session handed back to the scheduler for failover (drain with no
    migration target, crashed decode loop): the worker publishes a
    non-terminal ``SESSION_REQUEUE`` result and the scheduler re-dispatches
    with the already-streamed tokens as a forced-decode prefix — bounded by
    the attempts counter, FAILED only past the cap."""


class SessionHibernated(Exception):
    """Session frozen whole and tiered into the host-RAM cold arena
    (docs/SERVING.md §Prefix cache and tiering): a later
    ``restore_hibernated`` on this worker owns the token stream and the
    terminal result — the local waiter publishes NOTHING (the live-
    migration contract, pointed at ourselves)."""


@dataclass
class GenRequest:
    """A decomposed ``llm.generate`` payload."""

    prompt: list[int]
    max_new_tokens: int = 16
    session_key: str = ""
    eos_token: Optional[int] = None
    stream: bool = True
    # SLO class (JobRequest.priority, stamped by the worker intake): batch
    # prefill chunks yield step-budget headroom to interactive ones
    # (docs/ADMISSION.md §Serving)
    job_class: str = "BATCH"
    # failover resume (LABEL_RESUME_TOKENS): tokens a previous worker
    # already generated and streamed for this job.  They prefill as a
    # forced-decode prefix (prompt + resume ride the chunked prefill path),
    # count toward max_new_tokens, and replay at offset 0 so stream
    # consumers deduping by offset see an exactly-once sequence.
    resume_tokens: list[int] = field(default_factory=list)


@dataclass
class ServingStats:
    admitted: int = 0
    retired: int = 0
    cancelled: int = 0
    failed: int = 0
    steps: int = 0
    decoded_tokens: int = 0  # generated tokens (decode rows + first tokens)
    prefill_tokens: int = 0  # prompt tokens fed through mixed-step chunks
    prefill_chunks: int = 0
    migrated_out: int = 0  # sessions live-migrated to a peer worker
    migrated_in: int = 0  # sessions adopted from a peer worker
    requeued: int = 0  # sessions handed back to the scheduler for failover
    prefix_hits: int = 0  # admissions that mapped cached shared-prefix pages
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0  # prompt tokens whose prefill was skipped
    cow_copies: int = 0  # copy-on-write page duplications
    drafted_tokens: int = 0  # speculative tokens proposed into draft rows
    accepted_tokens: int = 0  # drafts verified and kept (bonus excluded)
    rolled_back_tokens: int = 0  # drafts rejected; write positions rolled back
    spec_steps: int = 0  # steps that carried at least one draft row
    hibernated_out: int = 0  # live sessions tiered whole to the cold arena
    restored_in: int = 0  # live sessions restored from the cold arena
    occupancy_sum: int = 0
    max_occupancy: int = 0
    admission_waits: int = 0  # admissions delayed by cache exhaustion
    # per-step wall time (seconds), capped ring for inter-token p50/p99
    step_seconds: deque = field(default_factory=lambda: deque(maxlen=4096))
    # submit → first sampled token (seconds), capped ring for TTFT p50
    # (resume/migrated-in sessions excluded: their first token belongs to
    # a previous worker's clock)
    ttft_seconds: deque = field(default_factory=lambda: deque(maxlen=4096))

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0


@dataclass
class _Session:
    job_id: str
    req: GenRequest
    future: asyncio.Future
    on_tokens: Optional[TokenSink] = None
    trace_id: str = ""
    parent_span_id: str = ""
    pages: list[int] = field(default_factory=list)
    pos: int = 0  # sequence positions cached so far
    prefill_pos: int = 0  # prompt tokens fed so far (== pos until prefilled)
    last_token: int = 0
    out_tokens: list[int] = field(default_factory=list)
    cancelled: bool = False
    # frozen = mid-migration: the step loop must not advance this session
    # (decode pauses only for the final freeze-and-delta chunk)
    frozen: bool = False
    # post-prefill hand-off (docs/SERVING.md §Disaggregation): the
    # on_prefill_done hook fires at most once per session
    handoff_signaled: bool = False
    # governor immunity: a migrated-in session may not be rebalanced again
    # before this monotonic stamp (the anti-ping-pong cooldown)
    immune_until: float = 0.0
    # speculative decoding: the session's acceptance EWMA (throttles the
    # next step's draft length; optimistic start so drafts flow at once)
    # and the tokens the drafter planned for the upcoming step
    accept_ewma: float = 1.0
    draft_plan: list[int] = field(default_factory=list)
    enqueued_at: float = field(default_factory=time.monotonic)

    @property
    def prefill_seq(self) -> list[int]:
        """What prefill must feed: the prompt plus the forced-decode resume
        prefix MINUS its last token (failover replay, docs/SERVING.md).
        The final resume token stays ``last_token``: the first post-resume
        step is then an ordinary decode row feeding it at the next
        position — the exact state a live-migrated session resumes from,
        so the continuation token is sampled with decode semantics, not a
        prefill-completion sample."""
        seq = self.req.prompt + self.req.resume_tokens
        return seq[:-1] if self.req.resume_tokens else seq

    @property
    def prefilled(self) -> bool:
        return self.prefill_pos >= len(self.prefill_seq)

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_token
        return eos is not None and bool(self.out_tokens) and self.out_tokens[-1] == eos


class ServingEngine:
    """One per worker; owns the allocator, the session table and the loop."""

    def __init__(
        self,
        backend: Any,
        *,
        run_blocking: Callable[..., Awaitable[Any]],
        max_sessions: int = DEFAULT_MAX_SESSIONS,
        max_new_tokens_cap: int = DEFAULT_MAX_NEW_TOKENS,
        max_concurrent_prefills: int = DEFAULT_MAX_CONCURRENT_PREFILLS,
        metrics: Optional[Any] = None,
        tracer: Optional[Any] = None,
        capacity: Optional[Any] = None,
        handoff_threshold_tokens: int = 0,
        migrate_in_cooldown_s: float = 30.0,
        prefix_cache: bool = True,
        hibernate_after_s: float = 0.0,
        speculative: bool = False,
        draft_k: int = DEFAULT_DRAFT_K,
        drafter: Optional[Callable[[list[int], int], list[int]]] = None,
    ) -> None:
        self.backend = backend
        self.run_blocking = run_blocking  # worker.run_in_executor
        # post-prefill hand-off (docs/SERVING.md §Disaggregation): the owner
        # (the worker) sets this to a callable(job_id); the loop invokes it
        # once per session when its prompt finishes prefilling — or earlier,
        # once prefill crosses handoff_threshold_tokens (>0) — so a
        # prefill-roled worker can ship the session to a decode worker
        # while the KV pages are hot
        self.on_prefill_done: Optional[Callable[[str], None]] = None
        self.handoff_threshold_tokens = max(0, handoff_threshold_tokens)
        # governor anti-ping-pong: sessions adopted via install_session are
        # immune to pick_rebalance_sessions for this window (drain ignores
        # it — a draining worker must move everything)
        self.migrate_in_cooldown_s = max(0.0, migrate_in_cooldown_s)
        # capacity observatory (obs/capacity.py): each ragged step reports
        # delivered tokens at the static flat-buffer bucket, with warmup
        # compiles flagged so steady-state rows exclude them
        self.capacity = capacity
        self.max_sessions = max(1, max_sessions)
        self.max_new_tokens_cap = max(1, max_new_tokens_cap)
        self.max_concurrent_prefills = max(1, max_concurrent_prefills)
        self.metrics = metrics
        self.tracer = tracer
        # the backend's static page-table width caps a session's lifetime
        # footprint; anything longer must be rejected at submit (the arena
        # may hold far more pages than one table row can address)
        self.max_context = int(getattr(backend, "max_context", 0) or 0)
        # the flat token buffer bounds decode rows + prefill chunk tokens
        # per step; every admitted session must at least fit a decode row
        self.step_tokens = int(
            getattr(backend, "max_batch_tokens", 0) or 2 * self.max_sessions
        )
        self.max_sessions = min(
            self.max_sessions,
            int(getattr(backend, "max_seqs", 0) or self.max_sessions),
            self.step_tokens,
        )
        self.allocator = PageAllocator(backend.num_pages, backend.page_size)
        # prefix cache + session tiering (docs/SERVING.md §Prefix cache and
        # tiering): the radix index over cached full-page prefixes, and the
        # hibernate/restore machinery that tiers idle resident state to the
        # host-RAM cold arena.  hibernate_after_s <= 0 disables the sweep
        # (the cache still shares; pressure is handled by LRU eviction).
        # Sharing also requires the backend's page-copy primitive (CoW):
        # without one a shared page could never be duplicated on divergent
        # write, so the cache is disabled outright rather than half-armed —
        # arena-less test fakes recompute K/V from the tokens actually fed,
        # so a silent prefill skip would change their outputs.
        can_share = prefix_cache and callable(getattr(backend, "copy_page", None))
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator, metrics=metrics)
            if can_share else None
        )
        self.tiering: Optional[SessionTiering] = (
            SessionTiering(
                self.prefix,
                hibernate_after_s=hibernate_after_s,
                export_page=self._export_prefix_page,
                metrics=metrics,
            )
            if self.prefix is not None else None
        )
        # speculative decoding (docs/SERVING.md §Speculative decoding):
        # the self-speculative drafter proposes k tokens per decoding
        # session per step; verification rides the same ragged program as
        # prefill-shaped draft rows with per-position sampling.  Gated on
        # the backend's per-position prediction support — fakes and legacy
        # backends without ``supports_draft`` keep the exact legacy step
        # shape (byte-for-byte: no draft rows are ever assembled).
        self.speculative = bool(speculative) and bool(
            getattr(backend, "supports_draft", False)
        )
        self.draft_k = max(1, int(draft_k or DEFAULT_DRAFT_K))
        self._drafter = drafter or self._ngram_draft
        # engine-level acceptance EWMA — the capacity block publishes it
        # as spec_accept_rate so the placer can route speculable traffic
        self.spec_accept_ewma = 0.0
        self._tiering_task: Optional[asyncio.Task] = None
        self.stats = ServingStats()
        self._pending: deque[_Session] = deque()
        self._active: dict[str, _Session] = {}
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        # job ids riding the step currently on the device: a migration
        # freeze is complete only once the in-flight step (which may still
        # produce one token for the session) has scattered its results
        self._in_step: frozenset[str] = frozenset()

    # ------------------------------------------------------------------
    def parts(self, payload: Any) -> Optional[GenRequest]:
        """Decompose a job payload; None = not a serving job (the worker
        keeps its ordinary handler path)."""
        if not isinstance(payload, dict) or payload.get("op") not in SERVING_OPS:
            return None
        tokens = payload.get("tokens")
        if not (
            isinstance(tokens, list) and tokens
            and all(isinstance(t, int) for t in tokens)
        ):
            return None
        try:
            max_new = int(payload.get("max_new_tokens", 16) or 16)
        except (TypeError, ValueError):
            # malformed payload is not a session: fall through to the
            # handler path, which raises the op's own descriptive error
            return None
        eos = payload.get("eos_token")
        return GenRequest(
            prompt=tokens,
            max_new_tokens=max(1, min(max_new, self.max_new_tokens_cap)),
            session_key=str(payload.get("session_id", "") or ""),
            eos_token=int(eos) if isinstance(eos, int) else None,
            stream=bool(payload.get("stream", True)),
        )

    # ------------------------------------------------------------------
    @property
    def session_count(self) -> int:
        return len(self._pending) + len(self._active)

    def queue_depth(self) -> int:
        return len(self._pending)

    def active_sessions(self) -> int:
        return len(self._active)

    # ------------------------------------------------------------------
    async def submit(
        self,
        gen: GenRequest,
        *,
        job_id: str,
        trace_id: str = "",
        parent_span_id: str = "",
        on_tokens: Optional[TokenSink] = None,
    ) -> dict[str, Any]:
        """Queue a session and await its completed generation."""
        if self._closed:
            raise RuntimeError("serving engine is stopped")
        total = len(gen.prompt) + gen.max_new_tokens
        if self.max_context and total > self.max_context:
            # beyond the backend's static page-table width: prefill would
            # silently truncate and the session would poison its step —
            # fail this job alone, before it becomes a session
            raise ValueError(
                f"request spans {total} tokens (prompt {len(gen.prompt)} + "
                f"{gen.max_new_tokens} new); backend max_context is "
                f"{self.max_context}"
            )
        footprint = self.allocator.pages_for(total)
        if footprint > self.allocator.capacity:
            raise ValueError(
                f"request needs {footprint} KV pages; cache holds "
                f"{self.allocator.capacity}"
            )
        sess = _Session(
            job_id=job_id, req=gen,
            future=asyncio.get_running_loop().create_future(),
            on_tokens=on_tokens if gen.stream else None,
            trace_id=trace_id, parent_span_id=parent_span_id,
        )
        if gen.resume_tokens:
            # forced-decode resume: the prefix counts as already-generated
            # output; prefill feeds prompt + prefix and decoding continues
            # from the prefix's last token
            sess.out_tokens = list(gen.resume_tokens)
            sess.last_token = gen.resume_tokens[-1]
        self._pending.append(sess)
        self._ensure_loop()
        self._wake.set()
        tokens = await sess.future
        return self.result_doc(gen, tokens)

    @staticmethod
    def result_doc(gen: GenRequest, tokens: list[int]) -> dict[str, Any]:
        """The terminal result payload for a finished generation — shared by
        :meth:`submit` and the migrated-session adoption path."""
        return {
            "tokens": tokens,
            "n_tokens": len(tokens),
            "session_key": gen.session_key,
            "finish_reason": (
                "eos" if gen.eos_token is not None and tokens
                and tokens[-1] == gen.eos_token else "length"
            ),
        }

    # ------------------------------------------------------------------
    def cancel(self, job_id: str) -> bool:
        """Evict a session wherever it is: admission queue (pages never
        allocated) or the step loop — prefilling or decoding, the pages are
        freed by the loop on its next tick.  Returns False when the job is
        not a live session."""
        for i, sess in enumerate(self._pending):
            if sess.job_id == job_id:
                del self._pending[i]
                # _retire keeps stats and the retirement metric in step
                # (pages were never allocated; free() is a no-op here)
                self._retire(sess, error=SessionCancelled(job_id))
                return True
        sess = self._active.get(job_id)
        if sess is not None:
            sess.cancelled = True  # the loop retires + frees pages
            self._wake.set()
            return True
        return False

    # ------------------------------------------------------------------
    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._decode_loop())
            self._loop_task.add_done_callback(self._on_loop_done)
        if (
            self.tiering is not None and self.tiering.hibernate_after_s > 0
            and (self._tiering_task is None or self._tiering_task.done())
        ):
            self._tiering_task = asyncio.ensure_future(self._tiering_loop())

    async def _tiering_loop(self) -> None:
        """Periodic hibernate sweep — its own task because idle resident
        conversations are exactly the ones generating no steps: the decode
        loop is parked on its wake event while they cool down."""
        assert self.tiering is not None
        interval = max(0.05, min(1.0, self.tiering.hibernate_after_s / 4))
        while not self._closed:
            await asyncio.sleep(interval)
            if self._closed:
                return
            try:
                await self.tiering.sweep()
            except Exception as e:  # noqa: BLE001 - sweep is best-effort
                logx.warn("hibernate sweep failed", err=str(e))

    async def _export_prefix_page(self, page: int) -> Optional[dict]:
        """One full arena page as a migration record — the tiering
        sweep's export half (None = the backend has no arena to export)."""
        fn = getattr(self.backend, "export_kv", None)
        if fn is None:
            return None
        recs = await self.run_blocking(fn, [page], 0, self.allocator.page_size)
        return recs[0] if recs else None

    def _on_loop_done(self, task: asyncio.Task) -> None:
        """Step failures are handled inside the loop; anything that still
        escapes must not strand live sessions on never-resolving futures —
        hand them back to the scheduler for failover (each publishes a
        non-terminal SESSION_REQUEUE result; the attempts counter bounds the
        retries, so a deterministic crasher still ends FAILED past the cap)
        and let the next submit restart the loop."""
        if task.cancelled() or self._closed:
            return
        exc = task.exception()
        if exc is None:
            return
        logx.warn("decode loop crashed; requeueing live sessions", err=str(exc))
        for sess in [*self._pending, *self._active.values()]:
            self._retire(sess, error=SessionRequeued(
                f"decode loop crashed: {exc}"
            ))
        self._pending.clear()

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.serving_sessions.set(float(len(self._active)))
            self.metrics.serving_kv_pages_in_use.set(float(self.allocator.used_pages))

    async def _admit(self) -> None:
        """Move pending sessions straight into the step loop while pages
        and session slots allow; FIFO so exhaustion delays but never
        reorders admission.  An admitted session needs no separate prefill
        phase — its prompt chunks ride the next steps' token budget.

        Prefix-cache hook (docs/SERVING.md §Prefix cache and tiering): the
        longest cached page-aligned prefix of the prompt maps its physical
        pages straight into the new session's table — prefill starts at
        the divergence point.  Cold nodes on the hit path restore from the
        host-RAM arena first (the hibernate restore), and exhaustion
        LRU-evicts zero-refcount cached prefixes before the head-of-line
        admission gives up and waits."""
        while self._pending and len(self._active) < self.max_sessions:
            sess = self._pending[0]
            if sess.cancelled:
                self._pending.popleft()
                self._retire(sess, error=SessionCancelled(sess.job_id))
                continue
            footprint = self.allocator.pages_for(
                len(sess.req.prompt) + sess.req.max_new_tokens
            )
            shared: list[int] = []
            hit_tokens = 0
            if self.prefix is not None and not sess.req.resume_tokens:
                nodes = await self._restore_nodes(
                    self.prefix.match(sess.prefill_seq)
                )
                if self._closed:
                    break  # stop() raced the restore await
                if sess.cancelled:
                    continue  # loop head pops + retires it
                # keep only the unbroken warm head of the path (a restore
                # may have truncated it, or an eviction raced the await)
                for node in nodes:
                    if node.dropped or not node.warm:
                        break
                    shared.append(node.page)
                # at least one token must be fed through prefill so the
                # completing chunk has a position to sample from; a hit
                # ending exactly at the prompt end re-feeds the final
                # token into shared territory (the CoW guard copies that
                # page before the step writes it)
                hit_tokens = min(
                    len(shared) * self.allocator.page_size,
                    len(sess.prefill_seq) - 1,
                )
                if hit_tokens < 1:
                    shared, hit_tokens = [], 0
            try:
                pages = self._alloc_with_evict(
                    sess.job_id, footprint - len(shared), shared
                )
            except CacheExhausted:
                self.stats.admission_waits += 1
                break  # head-of-line waits for a retirement to free pages
            self._pending.popleft()
            sess.pages = pages
            if hit_tokens > 0:
                # the skipped positions' K/V already sits in the shared
                # pages (identical token prefix ⇒ identical K/V — the
                # radix path IS the key); chunked prefill picks up at the
                # divergence point via prefill_pos
                sess.prefill_pos = hit_tokens
                sess.pos = hit_tokens
                self.stats.prefix_hits += 1
                self.stats.prefix_hit_tokens += hit_tokens
                self.prefix.stats.hits += 1
                self.prefix.stats.hit_tokens += hit_tokens
                if self.metrics is not None:
                    self.metrics.serving_prefix.inc(outcome="hit")
                    self.metrics.serving_prefix_tokens.inc(float(hit_tokens))
            elif self.prefix is not None and not sess.req.resume_tokens:
                self.stats.prefix_misses += 1
                self.prefix.stats.misses += 1
                if self.metrics is not None:
                    self.metrics.serving_prefix.inc(outcome="miss")
            if self.tiering is not None and sess.req.session_key:
                self.tiering.touch(sess.req.session_key)
            self._active[sess.job_id] = sess
            self.stats.admitted += 1
            if self.metrics is not None:
                self.metrics.serving_admitted.inc()
            if sess.out_tokens and sess.on_tokens is not None:
                # failover resume: replay the already-streamed prefix at
                # offset 0 — consumers dedupe by offset, so a client that
                # saw the original stream skips it and one that missed
                # packets in the crash window backfills
                asyncio.ensure_future(self._emit(sess, list(sess.out_tokens)))
            if sess.done:
                # the crash landed after the final token: nothing left to
                # decode — finish straight from the resume prefix
                self._retire(sess)

    def _alloc_with_evict(
        self, owner: str, n_fresh: int, shared: list[int]
    ) -> list[int]:
        """Admission alloc with the exhaustion hook: LRU-evict cached
        prefixes only the cache still references to cover the shortfall,
        then retry once.  The hit path's own pages are shielded with an
        extra reference while evicting, so the eviction scan can never
        free a page this very admission is about to map."""
        try:
            return self.allocator.alloc(owner, n_fresh, shared=shared)
        except CacheExhausted:
            if self.prefix is None:
                raise
            need = n_fresh - self.allocator.free_pages
            if shared:
                self.allocator.retain(shared)
            try:
                if self.prefix.evict(need) < need:
                    raise
                return self.allocator.alloc(owner, n_fresh, shared=shared)
            finally:
                if shared:
                    self.allocator.release(shared)

    async def _restore_nodes(
        self, nodes: list[PrefixNode]
    ) -> list[PrefixNode]:
        """Re-warm the cold nodes on a matched path (hibernate restore):
        allocate a fresh page, scatter the host-RAM record back, promote.
        The path truncates at the first node that cannot restore (no
        import support, exhaustion even after eviction, or an eviction
        racing the scatter).  The pause — what the turn waits before its
        prefill can start — feeds
        ``cordum_serving_hibernate_pause_seconds``."""
        out: list[PrefixNode] = []
        t0 = None
        imp = getattr(self.backend, "import_kv", None)
        for node in nodes:
            if node.dropped:
                break
            if node.warm:
                out.append(node)
                continue
            if imp is None or node.record is None or self.prefix is None:
                break
            if t0 is None:
                t0 = time.monotonic()
            try:
                (page,) = self.allocator.alloc_raw(1)
            except CacheExhausted:
                if self.prefix.evict(1) < 1:
                    break
                try:
                    (page,) = self.allocator.alloc_raw(1)
                except CacheExhausted:
                    break
            try:
                await self.run_blocking(imp, [page], [dict(node.record, i=0)])
            except Exception as e:  # noqa: BLE001 - keep the record, skip the hit
                self.allocator.release([page])
                logx.warn("prefix restore failed", err=str(e))
                break
            if node.dropped:
                self.allocator.release([page])
                break
            self.prefix.promote(node, page)
            if self.tiering is not None:
                self.tiering.stats.restored_pages += 1
            out.append(node)
        if t0 is not None and self.metrics is not None:
            self.metrics.serving_hibernate_pause.observe(time.monotonic() - t0)
        return out

    async def _emit(self, sess: _Session, new_tokens: list[int]) -> None:
        if sess.on_tokens is None:
            return
        try:
            await sess.on_tokens(new_tokens, len(sess.out_tokens), sess.done)
        except Exception as e:  # noqa: BLE001 - streaming is best-effort
            logx.warn("token stream sink failed", job_id=sess.job_id, err=str(e))

    def _retire(self, sess: _Session, error: Optional[BaseException] = None) -> None:
        if (
            error is None and self.prefix is not None
            and not self._closed and not sess.cancelled and sess.pages
        ):
            # retain the finished conversation's full pages under their
            # token path: the next turn (same history + new suffix) maps
            # them instead of re-prefilling.  Register BEFORE the
            # allocator drops the session's references, so a shared page
            # never transits the free list (the retain/release ordering
            # the property suite pins down).  Positions [0, pos) were
            # written; their tokens are prompt + generated output minus
            # the never-fed final sample.
            covered = (sess.req.prompt + sess.out_tokens)[:sess.pos]
            self.prefix.register(covered, sess.pages)
            if self.tiering is not None and sess.req.session_key:
                self.tiering.note_turn(sess.req.session_key, covered)
        self.allocator.free(sess.job_id)
        self._active.pop(sess.job_id, None)
        if error is None:
            self.stats.retired += 1
            if self.metrics is not None:
                self.metrics.serving_retired.inc(reason="finished")
            if not sess.future.done():
                sess.future.set_result(list(sess.out_tokens))
        else:
            if isinstance(error, SessionCancelled):
                reason = "cancelled"
                self.stats.cancelled += 1
            elif isinstance(error, SessionMigrated):
                reason = "migrated"
                self.stats.migrated_out += 1
            elif isinstance(error, SessionHibernated):
                reason = "hibernated"
                self.stats.hibernated_out += 1
            elif isinstance(error, SessionRequeued):
                reason = "requeued"
                self.stats.requeued += 1
            else:
                reason = "failed"
            if self.metrics is not None:
                self.metrics.serving_retired.inc(reason=reason)
            if not sess.future.done():
                sess.future.set_exception(error)

    # ------------------------------------------------------------------
    @staticmethod
    def _ngram_draft(history: list[int], k: int) -> list[int]:
        """Prompt-lookup drafting — the zero-extra-weights self-speculative
        drafter: find the most recent earlier occurrence of the history's
        final n-gram and propose the tokens that followed it.  Longest gram
        first (a longer match is stronger evidence the continuation
        repeats), most-recent-first within a gram so loops and templates
        match their latest iteration.  Returns ``[]`` when nothing matches:
        the session decodes a plain single-token row this step."""
        n = len(history)
        for g in (3, 2, 1):
            if n <= g:
                continue
            tail = history[-g:]
            # bounded lookback keeps a very long conversation O(window)
            lo = max(0, n - g - 512)
            for i in range(n - g - 1, lo - 1, -1):
                if history[i:i + g] == tail:
                    cont = history[i + g:i + g + k]
                    if cont:
                        return cont
        return []

    def _plan_drafts(self) -> None:
        """Propose draft continuations for every decoding session — BEFORE
        CoW resolution (the write span must cover the planned draft
        positions) and before assembly (which trims plans to the step's
        flat-buffer budget).  The per-session acceptance EWMA throttles the
        proposal length: a session whose drafts keep verifying ramps to
        ``draft_k``, one whose drafts keep rejecting decays to single-token
        probes.  The length clamp ``k <= remaining - 1`` guarantees a fully
        accepted burst (k drafts + the bonus token) never overshoots
        ``max_new_tokens`` — and therefore never writes outside the
        session's admitted page footprint."""
        if not self.speculative:
            return
        for sess in self._active.values():
            sess.draft_plan = []
            if not sess.prefilled or sess.frozen or sess.cancelled:
                continue
            room = sess.req.max_new_tokens - len(sess.out_tokens)
            k_cap = min(self.draft_k, room - 1)
            if k_cap < 1:
                continue
            k = 1 + int(round(sess.accept_ewma * (k_cap - 1)))
            history = sess.req.prompt + sess.out_tokens
            try:
                plan = self._drafter(history, k)
            except Exception as e:  # noqa: BLE001 - drafting is best-effort
                logx.warn("drafter failed", job_id=sess.job_id, err=str(e))
                plan = []
            sess.draft_plan = [int(t) for t in plan[:k]]

    # ------------------------------------------------------------------
    async def _resolve_cow(self) -> frozenset[str]:
        """Copy-on-write guard (docs/SERVING.md §Prefix cache and
        tiering): before assembling a step, any page a session is about
        to WRITE that another table — or the prefix cache — still
        references is duplicated onto a fresh page and swapped into this
        session's table only.  Full-page-only caching makes the trigger
        rare (a prefix hit ending exactly at the prompt end re-feeds one
        token into shared territory), but the guard is what makes sharing
        safe by construction instead of by keying convention.  Returns
        job ids that must sit this step out (no fresh page even after
        dropping the cache's own reference)."""
        skip: set[str] = set()
        ps = self.allocator.page_size
        for sess in list(self._active.values()):
            if sess.frozen or sess.cancelled or sess.job_id not in self._active:
                continue
            if sess.prefilled:
                # a draft row writes positions [pos, pos + k]: the span may
                # cross into the next page (or start inside a shared prefix
                # page), so every page it touches gets the CoW guard
                hi = sess.pos + len(sess.draft_plan)
                write_pages = range(sess.pos // ps, hi // ps + 1)
            else:
                lo = sess.prefill_pos // ps
                hi = min(
                    len(sess.prefill_seq) - 1,
                    sess.prefill_pos + self.step_tokens - 1,
                ) // ps
                write_pages = range(lo, hi + 1)
            for idx in write_pages:
                if idx >= len(sess.pages):
                    break
                if self.allocator.refcount(sess.pages[idx]) <= 1:
                    continue
                if not await self._cow(sess, idx):
                    skip.add(sess.job_id)
                    break
        return frozenset(skip)

    async def _cow(self, sess: _Session, idx: int) -> bool:
        """Give ``sess`` a private copy of page-table slot ``idx``.
        Cheapest first: under exhaustion (or when the cache is the only
        other holder left) dropping the cache's reference may already
        make this session the sole owner — no copy, no fresh page."""
        old = sess.pages[idx]
        copy = getattr(self.backend, "copy_page", None)
        if copy is None:
            # arena-less backends (test fakes) have no page contents to
            # copy and no way to share them — nothing to protect
            return True
        if self.allocator.free_pages < 1 and self.prefix is not None:
            self.prefix.drop_subtree(old)
            if self.allocator.refcount(old) <= 1:
                return True
        try:
            (fresh,) = self.allocator.alloc_raw(1)
        except CacheExhausted:
            if self.prefix is not None:
                self.prefix.drop_subtree(old)
                if self.allocator.refcount(old) <= 1:
                    return True
            return False
        await self.run_blocking(copy, old, fresh)
        if sess.cancelled or sess.job_id not in self._active:
            self.allocator.release([fresh])  # retired during the copy
            return True
        self.allocator.swap_owned(sess.job_id, old, fresh)
        sess.pages[idx] = fresh
        self.allocator.release([old])
        self.stats.cow_copies += 1
        if self.metrics is not None:
            self.metrics.serving_cow_copies.inc()
        return True

    # ------------------------------------------------------------------
    def _assemble(
        self, skip: frozenset = frozenset()
    ) -> tuple[list[StepEntry], list[tuple[_Session, int, bool, list[int]]]]:
        """Build one mixed step: a decode row for every prefilled session
        (with its planned draft tokens appended while the budget lasts),
        then prompt chunks for prefilling ones (admission order) within the
        flat token budget and the per-step chunk cap.  Returns the entries
        plus aligned ``(session, chunk_len, samples, draft_tokens)``
        bookkeeping.  ``skip`` rows sit this step out (CoW starved for a
        fresh page)."""
        entries: list[StepEntry] = []
        rows: list[tuple[_Session, int, bool, list[int]]] = []
        budget = self.step_tokens
        chunks = 0
        decoding = [
            # frozen = mid-migration freeze-and-delta: the session's pages
            # are being shipped; its rows sit this step (and the next) out
            s for s in self._active.values()
            if s.prefilled and not s.frozen and s.job_id not in skip
        ]
        # draft budget: the flat-buffer slots left after every decode row's
        # base token.  While prompts are waiting to prefill, drafts take at
        # most half the leftover so speculation can never starve admission
        # latency — the prefill chunks below ride the rest.
        waiting = any(
            not s.prefilled and not s.frozen and s.job_id not in skip
            for s in self._active.values()
        )
        spare = budget - len(decoding)
        draft_budget = (
            (spare // 2 if waiting else spare) if self.speculative else 0
        )
        for sess in decoding:
            plan = sess.draft_plan[:draft_budget] if draft_budget > 0 else []
            sess.draft_plan = []
            entries.append(StepEntry(
                tokens=[sess.last_token, *plan], start=sess.pos,
                pages=sess.pages, sample=True, phase="decode",
                key=sess.job_id, draft=len(plan),
            ))
            rows.append((sess, 1 + len(plan), True, plan))
            budget -= 1 + len(plan)
            draft_budget -= len(plan)
        # prefill candidates ride interactive-first (stable within a class,
        # so admission order still breaks ties): under load the leftover
        # token budget goes to interactive prompts and BATCH prefill waits —
        # batch decode rows above keep their single-token slots, only new
        # batch prompt ingestion is deprioritized (docs/ADMISSION.md)
        prefilling = [
            s for s in self._active.values()
            if not s.prefilled and not s.frozen and s.job_id not in skip
        ]
        prefilling.sort(
            key=lambda s: 0 if s.req.job_class in INTERACTIVE_CLASSES else 1
        )
        for sess in prefilling:
            if budget <= 0 or chunks >= self.max_concurrent_prefills:
                break
            # the prefill sequence is prompt + any forced-decode resume
            # prefix (minus its last token, which decodes as a normal row);
            # the completing chunk samples only for resume-free sessions
            # with output still to generate
            seq = sess.prefill_seq
            chunk = min(budget, len(seq) - sess.prefill_pos)
            completes = sess.prefill_pos + chunk >= len(seq)
            samples = (
                completes and not sess.done and not sess.req.resume_tokens
            )
            entries.append(StepEntry(
                tokens=seq[sess.prefill_pos:sess.prefill_pos + chunk],
                start=sess.prefill_pos, pages=sess.pages,
                sample=samples, phase="prefill",
                key=sess.job_id,
            ))
            rows.append((sess, chunk, samples, []))
            budget -= chunk
            chunks += 1
        return entries, rows

    async def _decode_loop(self) -> None:
        """The continuous-batching loop: one ragged device call per step over
        every active session — decode rows and prefill chunks mixed;
        admission and retirement happen between steps, never inside one."""
        while not self._closed:
            await self._admit()
            # evict cancellations before assembling the batch
            for sess in [s for s in self._active.values() if s.cancelled]:
                self._retire(sess, error=SessionCancelled(sess.job_id))
            if not self._active:
                self._gauge()
                if not self._pending:
                    if self._closed:
                        return
                    self._wake.clear()
                    # re-check after clear: a submit may have landed between
                    # the emptiness check and the clear
                    if not (self._pending or self._active):
                        await self._wake.wait()
                else:
                    await asyncio.sleep(0.001)  # pages freeing: poll soon
                continue
            self._plan_drafts()
            entries, rows = self._assemble(await self._resolve_cow())
            if not entries:  # defensive: all rows parked past the budget
                await asyncio.sleep(0.001)
                continue
            t0 = time.monotonic()
            step_span = None
            if self.tracer is not None and rows[0][0].trace_id:
                oldest = min((r[0] for r in rows), key=lambda s: s.enqueued_at)
                step_span = self.tracer.begin(
                    "decode-step", trace_id=oldest.trace_id,
                    parent_span_id=oldest.parent_span_id,
                    attrs={"occupancy": str(len(rows))},
                )
            self._in_step = frozenset(s.job_id for s, _, _, _ in rows)
            try:
                results = await self.run_blocking(self.backend.step, entries)
            except Exception as e:  # noqa: BLE001 - whole-step failure
                # a poisoned step fails every rider (pages freed); the next
                # tick starts clean — mirrors the batcher's isolation intent
                # without re-running autoregressive state per item
                self._in_step = frozenset()
                logx.warn("serving step failed", occupancy=len(rows), err=str(e))
                if step_span is not None and self.tracer is not None:
                    step_span.attrs["error"] = type(e).__name__
                    await self.tracer.finish(step_span, status="ERROR")
                for sess, _, _, _ in rows:
                    self.stats.failed += 1
                    self._retire(sess, error=e)
                continue
            dt = time.monotonic() - t0
            generated = 0
            prefill_fed = 0
            retired_this_step = 0
            step_drafted = 0
            step_accepted = 0
            emits = []
            retires = []
            for (sess, chunk, samples, drafted), tok in zip(rows, results):
                if drafted:
                    # speculative verification row: the backend returned
                    # one next-token prediction per fed position.  Accept
                    # the longest draft prefix the model agrees with, then
                    # the bonus token — the prediction after the last
                    # accepted draft, which is exactly what a sequential
                    # decode would have sampled next (so the burst is
                    # token-identical to the oracle by construction).
                    preds = [int(t) for t in tok]
                    a = 0
                    while a < len(drafted) and drafted[a] == preds[a]:
                        a += 1
                    burst = drafted[:a] + [preds[a]]
                    eos = sess.req.eos_token
                    if eos is not None and eos in burst:
                        burst = burst[:burst.index(eos) + 1]
                    rejected = len(drafted) - a
                    step_drafted += len(drafted)
                    step_accepted += a
                    frac = a / len(drafted)
                    sess.accept_ewma += SPEC_EWMA_ALPHA * (
                        frac - sess.accept_ewma
                    )
                    self.spec_accept_ewma += SPEC_FLEET_ALPHA * (
                        frac - self.spec_accept_ewma
                    )
                    self.stats.drafted_tokens += len(drafted)
                    self.stats.accepted_tokens += a
                    self.stats.rolled_back_tokens += rejected
                    if self.metrics is not None:
                        self.metrics.serving_spec_drafted.inc(
                            float(len(drafted)))
                        self.metrics.serving_spec_accepted.inc(float(a))
                        if rejected:
                            self.metrics.serving_spec_rolled_back.inc(
                                float(rejected))
                    # page write-position rollback: pos advances over the
                    # verified burst ONLY.  Rejected draft positions sit at
                    # >= the new pos; every later step writes its own K/V
                    # there before any gather runs (writes precede gathers
                    # inside the ragged program, and positions are consumed
                    # contiguously), so the arena never serves speculated
                    # garbage.
                    first = not sess.out_tokens
                    sess.pos += len(burst)
                    sess.last_token = burst[-1]
                    sess.out_tokens.extend(burst)
                    generated += len(burst)
                    if first:
                        self.stats.ttft_seconds.append(
                            time.monotonic() - sess.enqueued_at
                        )
                    emits.append(self._emit(sess, burst))
                else:
                    if sess.prefilled:
                        sess.pos += 1  # decode row: wrote its token at pos
                    else:
                        sess.prefill_pos += chunk
                        sess.pos = sess.prefill_pos
                        prefill_fed += chunk
                        self.stats.prefill_chunks += 1
                    if samples and tok is not None:
                        t = int(tok)
                        sess.last_token = t
                        sess.out_tokens.append(t)
                        generated += 1
                        if len(sess.out_tokens) == 1:
                            # first token of a locally born session: TTFT
                            # (resume prefixes pre-populate out_tokens, so
                            # migrated/resumed sessions never land here)
                            self.stats.ttft_seconds.append(
                                time.monotonic() - sess.enqueued_at
                            )
                        emits.append(self._emit(sess, [t]))
                if sess.done or sess.cancelled:
                    retired_this_step += 1
                    # deferred below the emit gather: the future must not
                    # resolve before the session's final token packet is
                    # delivered, or a submitter that stops the engine the
                    # moment submit() returns races the stream's tail (the
                    # exactly-once contract spec bursts lean on)
                    retires.append(sess)
                elif (
                    self.on_prefill_done is not None
                    and not sess.handoff_signaled
                    and not sess.frozen
                    and (sess.prefilled or (
                        self.handoff_threshold_tokens > 0
                        and sess.prefill_pos >= self.handoff_threshold_tokens
                    ))
                ):
                    # post-prefill hand-off trigger: the prompt finished
                    # prefilling (or crossed the threshold mid-prefill) and
                    # the session still has tokens to generate — the hook
                    # fires once; the owner decides whether/where to migrate
                    sess.handoff_signaled = True
                    try:
                        self.on_prefill_done(sess.job_id)
                    except Exception as e:  # noqa: BLE001 - policy is best-effort
                        logx.warn("prefill-done hook failed",
                                  job_id=sess.job_id, err=str(e))
            self.stats.steps += 1
            self.stats.decoded_tokens += generated
            self.stats.prefill_tokens += prefill_fed
            if step_drafted:
                self.stats.spec_steps += 1
            self.stats.occupancy_sum += len(rows)
            self.stats.max_occupancy = max(self.stats.max_occupancy, len(rows))
            self.stats.step_seconds.append(dt)
            if self.capacity is not None:
                # one mixed step at the backend's static flat-buffer shape;
                # warmup compiles are flagged so the steady-state tokens/s
                # rows in the capacity matrix exclude them.  The step's
                # device time is apportioned by delivered tokens between
                # prompt ingestion (the OP_SERVING_PREFILL row) and token
                # generation (the llm.generate row), so prefill tokens/s
                # and decode tokens/s are separately measurable — the
                # disaggregation policy's two placement signals
                # (docs/SERVING.md §Disaggregation)
                compiled = bool(getattr(self.backend, "last_step_compiled",
                                        False))
                total_toks = generated + prefill_fed
                if prefill_fed:
                    self.capacity.observe(
                        OP_SERVING_PREFILL,
                        device_s=dt * prefill_fed / total_toks,
                        bucket=str(self.step_tokens),
                        items=prefill_fed, tokens=prefill_fed,
                        compiled=compiled,
                    )
                if generated or not prefill_fed:
                    self.capacity.observe(
                        "llm.generate",
                        device_s=(dt * generated / total_toks
                                  if total_toks else dt),
                        bucket=str(self.step_tokens),
                        items=generated, tokens=generated,
                        compiled=compiled,
                    )
            if emits:
                await asyncio.gather(*emits)
            for sess in retires:
                self._retire(
                    sess,
                    error=SessionCancelled(sess.job_id)
                    if sess.cancelled else None,
                )
            # every token of this step is appended AND emitted: a freeze
            # waiting on wait_quiesced() now sees a fully consistent session
            self._in_step = frozenset()
            if self.metrics is not None:
                self.metrics.serving_batch_occupancy.observe(float(len(rows)))
                self.metrics.serving_inter_token.observe(dt)
            if step_span is not None and self.tracer is not None:
                step_span.attrs["retired"] = str(retired_this_step)
                step_span.attrs["prefill_tokens"] = str(prefill_fed)
                step_span.attrs["step_ms"] = f"{dt * 1000:.2f}"
                if self.speculative:
                    step_span.attrs["drafted"] = str(step_drafted)
                    step_span.attrs["accepted"] = str(step_accepted)
                await self.tracer.finish(step_span)
            self._gauge()
            # yield to the loop so intake/cancel/heartbeat tasks run between
            # steps even under a saturated decode set
            await asyncio.sleep(0)

    # ------------------------------------------------------------------
    # live migration (serving/migration.py, docs/SERVING.md §Migration,
    # drain, and failover).  The engine side is deliberately mechanical:
    # describe → stream stable pages live → freeze → export the delta →
    # complete (retire as SessionMigrated) or unfreeze on failure.
    # ------------------------------------------------------------------
    def session_ids(self) -> list[str]:
        """Every live session, decoding first (pending last): the order a
        drain migrates them in — decoding sessions carry KV state worth
        moving; pending ones are requeued cheaply."""
        return [*self._active.keys(), *(s.job_id for s in self._pending)]

    def pick_rebalance_sessions(self, n: int = 1) -> list[str]:
        """Cheapest movable sessions for a governor rebalance
        (docs/SERVING.md §Disaggregation): active, unfrozen, uncancelled,
        and past their migrated-in cooldown — a session the governor (or a
        hand-off) just placed here is immune, so skew oscillation can
        never ping-pong it.  Cheapest = fewest live pages, then oldest
        (smallest) position — the least KV state to ship; sessions still
        prefilling qualify (they are the cheapest of all, and migration
        resumes prefill on the target).  Drain uses :meth:`session_ids`
        instead and ignores immunity (a draining worker must move
        everything)."""
        now = time.monotonic()
        cands = [
            s for s in self._active.values()
            if not s.frozen and not s.cancelled
            and not s.done and s.immune_until <= now
        ]
        cands.sort(key=lambda s: (len(s.pages), s.pos))
        return [s.job_id for s in cands[:max(0, n)]]

    def describe_session(self, job_id: str) -> Optional[dict[str, Any]]:
        """The session's immutable metadata (the migration hello frame);
        None when it is not actively decoding here."""
        sess = self._active.get(job_id)
        if sess is None or sess.cancelled:
            return None
        req = sess.req
        return {
            "job_id": sess.job_id,
            "prompt": list(req.prompt),
            "resume_tokens": list(req.resume_tokens),
            "max_new_tokens": req.max_new_tokens,
            "session_key": req.session_key,
            "eos_token": req.eos_token,
            "stream": req.stream,
            "trace_id": sess.trace_id,
            "page_size": self.allocator.page_size,
            "n_pages": len(sess.pages),
        }

    def export_state(self, job_id: str) -> Optional[dict[str, Any]]:
        """The session's mutable decode state — valid only once frozen and
        quiesced (the commit frame's ``state``)."""
        sess = self._active.get(job_id)
        if sess is None:
            return None
        return {
            "pos": sess.pos,
            "prefill_pos": sess.prefill_pos,
            "out_tokens": list(sess.out_tokens),
            "last_token": sess.last_token,
        }

    async def export_pages(
        self, job_id: str, start_tok: int, end_tok: int
    ) -> list[dict]:
        """Page records covering positions ``[start_tok, end_tok)`` at
        their true lengths (backends without an arena export nothing — the
        receiver rebuilds from the metadata via ``restore_session``)."""
        sess = self._active.get(job_id)
        fn = getattr(self.backend, "export_kv", None)
        if sess is None or fn is None:
            return []
        return await self.run_blocking(fn, sess.pages, start_tok, end_tok)

    def freeze_session(self, job_id: str) -> bool:
        """Pause the session's decode (it sits out subsequent steps);
        False when it is not actively decoding here."""
        sess = self._active.get(job_id)
        if sess is None or sess.cancelled:
            return False
        sess.frozen = True
        return True

    def unfreeze_session(self, job_id: str) -> None:
        """Resume a frozen session (migration failed: decode continues
        locally as if nothing happened)."""
        sess = self._active.get(job_id)
        if sess is not None:
            sess.frozen = False
            self._wake.set()

    async def wait_quiesced(self, job_id: str) -> None:
        """Block until the in-flight step (which may still produce one
        token for a just-frozen session) has scattered its results."""
        while job_id in self._in_step:
            await asyncio.sleep(0.002)

    def complete_migration(self, job_id: str) -> bool:
        """The target committed: retire locally as migrated — the waiter
        publishes nothing (the target owns stream + terminal result)."""
        sess = self._active.get(job_id)
        if sess is None:
            return False
        self._retire(sess, error=SessionMigrated(job_id))
        return True

    async def hibernate_session(self, job_id: str) -> bool:
        """Freeze a live session and tier it whole into the host-RAM cold
        arena — the local analogue of live migration (same record format,
        no peer): freeze → quiesce → export state + pages → retire
        ``reason="hibernated"``.  The submit waiter gets
        :class:`SessionHibernated` and publishes nothing;
        :meth:`restore_hibernated` later owns the token stream and the
        terminal result.  False when the session is not live here (or
        tiering is disabled)."""
        if self.tiering is None:
            return False
        meta = self.describe_session(job_id)
        if meta is None or not self.freeze_session(job_id):
            return False
        try:
            await self.wait_quiesced(job_id)
            state = self.export_state(job_id)
            if state is None:
                return False
            records = await self.export_pages(job_id, 0, int(state["pos"]))
        except BaseException:
            self.unfreeze_session(job_id)
            raise
        sess = self._active.get(job_id)
        if sess is None or sess.cancelled:
            self.unfreeze_session(job_id)
            return False
        self.tiering.arena.put(job_id, {
            "meta": meta, "state": state, "records": records,
        })
        self._retire(sess, error=SessionHibernated(job_id))
        if self.metrics is not None:
            self.metrics.serving_hibernate.inc(event="hibernated")
        return True

    async def restore_hibernated(
        self,
        job_id: str,
        *,
        on_tokens: Optional[TokenSink] = None,
    ) -> asyncio.Future:
        """Re-admit a hibernated session from the cold arena via the
        existing :meth:`install_session` path; carried tokens replay at
        offset 0, so offset-deduping stream consumers see an exactly-once
        sequence across the gap.  Raises ``KeyError`` when the arena has
        no such session; on install failure (exhaustion) the cold doc is
        put back, restorable later."""
        if self.tiering is None:
            raise KeyError(job_id)
        doc = self.tiering.arena.pop(job_id)
        if doc is None:
            raise KeyError(job_id)
        meta, state = doc["meta"], doc["state"]
        eos = meta.get("eos_token")
        req = GenRequest(
            prompt=[int(t) for t in meta["prompt"]],
            max_new_tokens=int(meta["max_new_tokens"]),
            session_key=str(meta.get("session_key", "")),
            eos_token=int(eos) if isinstance(eos, int) else None,
            stream=bool(meta.get("stream", True)),
            resume_tokens=[int(t) for t in meta.get("resume_tokens") or []],
        )
        t0 = time.monotonic()
        try:
            fut = await self.install_session(
                req, job_id=job_id, state=state, records=doc["records"],
                trace_id=str(meta.get("trace_id", "")),
                on_tokens=on_tokens, origin="hibernate",
            )
        except BaseException:
            self.tiering.arena.put(job_id, doc)
            raise
        self.stats.restored_in += 1
        if self.metrics is not None:
            self.metrics.serving_hibernate.inc(event="restored")
            self.metrics.serving_hibernate_pause.observe(time.monotonic() - t0)
        return fut

    def requeue(self, job_id: str, reason: str = "") -> bool:
        """Hand a session (pending or active) back to the scheduler for
        failover — the drain fallback when no peer can take its pages."""
        for i, sess in enumerate(self._pending):
            if sess.job_id == job_id:
                del self._pending[i]
                self._retire(sess, error=SessionRequeued(reason or job_id))
                return True
        sess = self._active.get(job_id)
        if sess is None:
            return False
        self._retire(sess, error=SessionRequeued(reason or job_id))
        return True

    async def install_session(
        self,
        req: GenRequest,
        *,
        job_id: str,
        state: dict[str, Any],
        records: list[dict],
        trace_id: str = "",
        parent_span_id: str = "",
        on_tokens: Optional[TokenSink] = None,
        origin: str = "migration",
    ) -> asyncio.Future:
        """Adopt a migrated-in session: allocate fresh arena blocks,
        scatter the shipped page records into them, and resume decoding
        exactly where the source froze.  Raises (``CacheExhausted`` /
        ``ValueError``) when this worker cannot take it — the source then
        falls back to a scheduler requeue.  Returns the session's result
        future (token list).  ``origin="hibernate"`` (the
        :meth:`restore_hibernated` path) books the adoption under the
        hibernate counters instead of the migration ones."""
        if self._closed:
            raise RuntimeError("serving engine is stopped")
        if job_id in self._active or any(
            s.job_id == job_id for s in self._pending
        ):
            raise ValueError(f"session {job_id} already live on this worker")
        total = len(req.prompt) + req.max_new_tokens
        if self.max_context and total > self.max_context:
            raise ValueError(
                f"migrated session spans {total} tokens; backend max_context "
                f"is {self.max_context}"
            )
        if len(self._active) >= self.max_sessions:
            raise CacheExhausted(
                f"{len(self._active)} active sessions; max {self.max_sessions}"
            )
        pages = self.allocator.alloc(job_id, self.allocator.pages_for(total))
        try:
            imp = getattr(self.backend, "import_kv", None)
            if imp is not None and records:
                await self.run_blocking(imp, pages, records)
        except BaseException:
            self.allocator.free(job_id)
            raise
        sess = _Session(
            job_id=job_id, req=req,
            future=asyncio.get_running_loop().create_future(),
            on_tokens=on_tokens if req.stream else None,
            trace_id=trace_id, parent_span_id=parent_span_id,
        )
        sess.pages = pages
        sess.pos = int(state.get("pos", 0) or 0)
        sess.prefill_pos = int(state.get("prefill_pos", 0) or 0)
        sess.out_tokens = [int(t) for t in state.get("out_tokens") or []]
        sess.last_token = int(state.get("last_token", 0) or 0)
        # anti-ping-pong cooldown: a just-adopted session may not be picked
        # for another governor rebalance until the window passes
        sess.immune_until = time.monotonic() + self.migrate_in_cooldown_s
        # a migrated-in session never re-fires the source's hand-off hook:
        # it is already where the policy put it
        sess.handoff_signaled = True
        # arena-less backends (test fakes) rebuild their per-session decode
        # state from the metadata instead of imported pages
        restore = getattr(self.backend, "restore_session", None)
        if restore is not None:
            restore(job_id, sess.prefill_seq, sess.prefill_pos)
        self._active[job_id] = sess
        self.stats.admitted += 1
        if origin == "migration":
            self.stats.migrated_in += 1
        if self.metrics is not None:
            self.metrics.serving_admitted.inc()
            if origin == "migration":
                self.metrics.serving_migrations.inc(role="in", outcome="ok")
        if sess.out_tokens and sess.on_tokens is not None:
            # replay the carried tokens at offset 0: dedupe-by-offset makes
            # it a no-op for clients that saw them and a backfill for
            # clients that lost packets in the handover window
            asyncio.ensure_future(self._emit(sess, list(sess.out_tokens)))
        if sess.done:
            self._retire(sess)
        else:
            self._ensure_loop()
            self._wake.set()
        self._gauge()
        return sess.future

    # ------------------------------------------------------------------
    # cordum: single-flight -- sole caller is the owning runner's shutdown path; the cancel/await/None teardown is idempotent
    async def stop(self) -> None:
        """Evict every session (CANCELLED) and stop the loop — worker
        shutdown; generations are conversation turns, not batch jobs, so
        draining them could take unboundedly long."""
        self._closed = True
        self._wake.set()
        if self._tiering_task is not None:
            self._tiering_task.cancel()
            try:
                await self._tiering_task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 - logged, never swallowed
                logx.warn("tiering sweep crashed during shutdown", err=str(e))
            self._tiering_task = None
        for sess in list(self._pending):
            if not sess.future.done():
                sess.future.set_exception(SessionCancelled(sess.job_id))
        self._pending.clear()
        for sess in list(self._active.values()):
            sess.cancelled = True
            self._retire(sess, error=SessionCancelled(sess.job_id))
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 - logged, never swallowed
                logx.warn("decode loop crashed during shutdown", err=str(e))
            self._loop_task = None
