"""Worker-side gang execution: the rendezvous barrier, the SPMD train leg
and tensor-parallel serving gangs — the counterpart of
``cordum_tpu/worker/gang.py``.

A gang member job arrives on the worker's direct subject carrying the
scheduler-stamped ``cordum.gang_*`` labels (gang id, rank, size, member
list).  The member then:

1. subscribes its gang's ``sys.job.gang.<gang_id>`` subject and beacons
   ``GangMsg(kind="ready")`` every few hundred ms until the member ends
   (fan-out subjects are not durable, so beacons repeat), and waits until
   it has seen every rank's beacon — the rendezvous barrier;
2. a barrier timeout, a peer's abort, a cancel, or any local failure
   aborts the WHOLE gang: the member publishes ``kind="abort"``, peers
   stop, and the scheduler releases every reserved worker and requeues the
   job;
3. past the barrier it runs the step program:

   * **serving** (``op: "llm.generate"`` or ``gang.kind == "serving"``):
     the ranks join a ``torch.distributed`` group
     (:class:`..parallel.mesh.TPGroup`; rank 0 opens its ``TCPStore`` before
     it beacons and puts the store's ``host:port`` in its ready message).
     Rank 0 runs the real :class:`..serving.engine.ServingEngine` over its
     :class:`..serving.shard.ShardedServingBackend` and ships each step's
     entries as ``kind="step"`` BEFORE its device call — the step's
     all-reduces wait for the followers, so shipping after it (as the
     reference does) would deadlock; followers replay the entries in
     ``seq`` order against their slices until the final marker.  The group
     is torn down on every exit: done, abort or cancel.
   * **SPMD train** (``op: "train"``, unless MPMD below): every member runs
     the port's :class:`~.training.TrainRunner` on its own card (dense,
     MoE or the one-device pipeline), as the reference's members each run
     a replica on one device.
   * **MPMD pipeline** (``op: "train"`` with ``mesh.pp`` equal to the gang's
     size, size > 1): rank ``r`` owns stage ``r`` of a pipeline model
     (rank 0 also embeds, the last rank owns the head and the loss).
     Activations flow forward and cotangents back between neighbour ranks
     as ``kind="stage"`` messages over the bus, addressed by tag to one
     rank and carried as raw little-endian float32, in the fill/drain
     GPipe schedule; autograd takes the place of ``jax.vjp``, and every
     rank applies SGD to its own stage.  No collective: two workers that
     share one card run it.
   * ``gang_test`` spins (``spin_s``) or fails the workers named in
     ``fail_workers``; any other op is barrier-only (``gang_echo``).

4. on success the member publishes ``kind="done"`` with its stats; the
   scheduler folds all ranks into the job's single terminal result.
   Members never publish a ``JobResult``.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..infra import logging as logx
from ..models import llama, pipeline
from ..obs.capacity import serving_gang_block
from ..optim import tree_leaves, tree_map
from ..parallel.mesh import TPGroup, connect_store, open_store
from ..protocol import subjects as subj
from ..protocol.types import (
    LABEL_GANG_ID,
    LABEL_GANG_MEMBERS,
    LABEL_GANG_RANK,
    LABEL_GANG_SIZE,
    SERVING_OPS,
    BusPacket,
    GangMsg,
    JobRequest,
)
from ..serving.engine import GenRequest, ServingEngine
from ..serving.shard import ShardedServingBackend, StepReplay, step_message

DEFAULT_RENDEZVOUS_TIMEOUT_S = 10.0
DEFAULT_PEER_TIMEOUT_S = 30.0
BEACON_INTERVAL_S = 0.25
_DONE_CACHE_CAP = 128
#: the wire dtype of MPMD stage tensors: raw little-endian float32
WIRE_DTYPE = np.dtype("<f4")


class GangAborted(Exception):
    """The gang is over (peer abort / barrier timeout / cancel) — unwind
    without publishing a member result."""


class _GangSession:
    """One member's live view of its gang: the ready set, the abort latch,
    rank 0's rendezvous store address, the replay stream and the
    tag-addressed mailboxes of MPMD stage traffic."""

    def __init__(self, gang_id: str, job_id: str, rank: int, size: int,
                 trace_id: str = "") -> None:
        self.gang_id = gang_id
        self.job_id = job_id
        self.rank = rank
        self.size = size
        self.trace_id = trace_id
        self.ready: set[int] = {rank}
        self.barrier = asyncio.Event()
        self.abort = asyncio.Event()
        self.abort_reason = ""
        # rank 0's rendezvous store (host:port), from its ready beacon
        self.store_addr = ""
        # serving-gang replay stream (kind="step"): rank 0's entry batches,
        # drained in seq order by the follower loop
        self.steps: collections.deque[GangMsg] = collections.deque()
        self.step_event = asyncio.Event()
        # MPMD stage traffic (kind="stage"), one future a tag, made by
        # whichever of the message and the recv comes first
        self._mail: dict[str, asyncio.Future] = {}

    def on_msg(self, msg: GangMsg) -> None:
        if msg.kind in ("ready", "done", "step"):
            if msg.kind == "ready" and msg.rank == 0 and (msg.stats or {}).get("store"):
                self.store_addr = str(msg.stats["store"])
            # a peer's done or step also proves it passed its rendezvous: a
            # barrier-only peer can hear our beacon, finish and stop
            # beaconing before its own first beacon reached us
            self.ready.add(msg.rank)
            if len(self.ready) >= self.size:
                self.barrier.set()
        if msg.kind == "step":
            self.steps.append(msg)
            self.step_event.set()
        elif msg.kind == "abort":
            self.abort_reason = self.abort_reason or (msg.reason or "abort")
            self.abort.set()
            for fut in self._mail.values():
                if not fut.done():
                    fut.set_exception(GangAborted(self.abort_reason))
        elif msg.kind == "stage" and msg.to_rank == self.rank:
            fut = self._mailbox(msg.tag)
            if not fut.done():  # a redelivered message changes nothing
                fut.set_result((bytes(msg.data or b""), [int(n) for n in msg.shape or []]))

    def _mailbox(self, tag: str) -> asyncio.Future:
        fut = self._mail.get(tag)
        if fut is None:
            fut = self._mail[tag] = asyncio.get_running_loop().create_future()
        return fut

    def check_abort(self) -> None:
        if self.abort.is_set():
            raise GangAborted(self.abort_reason or "abort")

    async def recv(self, tag: str, timeout_s: float) -> tuple[bytes, list[int]]:
        """The stage message addressed to this rank by ``tag``, whether it
        arrived before this call or arrives within ``timeout_s``: ``(data,
        shape)``.  A peer's abort fails the wait at once; a peer that went
        silent raises ``GangAborted("peer_timeout:<tag>")``."""
        self.check_abort()
        fut = self._mailbox(tag)
        try:
            return await asyncio.wait_for(asyncio.shield(fut), timeout_s)
        except asyncio.TimeoutError:
            raise GangAborted(f"peer_timeout:{tag}") from None
        finally:
            self._mail.pop(tag, None)


def _is_serving(payload: Any) -> bool:
    payload = payload if isinstance(payload, dict) else {}
    stanza = payload.get("gang") if isinstance(payload.get("gang"), dict) else {}
    return str(payload.get("op", "train")) in SERVING_OPS or str(stanza.get("kind", "")) == "serving"


class GangRunner:
    """Executes gang member jobs for one worker (attached with
    ``Worker.attach_gang``).  ``trainer`` runs the SPMD train leg;
    ``params_provider(cfg)``, when given, returns the full weights a
    serving gang's ranks slice (the way ``GPUCompute`` takes
    ``llama_params``), else every rank draws them from the payload's
    seed.  ``store_host``, when set, is the address rank 0 advertises for
    its rendezvous store (``WORKER_GANG_ADDR``: a gang whose ranks live on
    other hosts), else ``127.0.0.1``."""

    def __init__(
        self,
        worker,
        *,
        trainer=None,
        rendezvous_timeout_s: float = DEFAULT_RENDEZVOUS_TIMEOUT_S,
        peer_timeout_s: float = DEFAULT_PEER_TIMEOUT_S,
        beacon_interval_s: float = BEACON_INTERVAL_S,
        params_provider: Optional[Callable[[Any], Any]] = None,
        store_host: str = "",
    ) -> None:
        self.worker = worker
        self.trainer = trainer
        self.rendezvous_timeout_s = rendezvous_timeout_s
        self.peer_timeout_s = peer_timeout_s
        self.beacon_interval_s = beacon_interval_s
        self.params_provider = params_provider
        self.store_host = store_host
        self._sessions: dict[str, _GangSession] = {}
        self._tasks: set[asyncio.Task] = set()
        # live serving gangs this worker is a member of, keyed by gang id —
        # the worker's telemetry beacon carries one as its serving_gang block
        self._serving_gangs: dict[str, dict] = {}
        # done-report cache: a member packet redelivered after completion
        # republishes the recorded GangMsg instead of re-running the program
        self._done: dict[str, GangMsg] = {}

    async def stop(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        for t in list(self._tasks):
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._tasks.clear()

    # ------------------------------------------------------------------
    @staticmethod
    def is_member(req: JobRequest) -> bool:
        return LABEL_GANG_ID in (req.labels or {})

    async def handle(
        self, req: JobRequest, payload: Any, *,
        trace_id: str = "", parent_span_id: str = "",
    ) -> None:
        """Run one gang member job end to end.  Publishes only GangMsg
        traffic — never a JobResult."""
        labels = req.labels or {}
        gang_id = labels.get(LABEL_GANG_ID, "")
        try:
            rank = int(labels.get(LABEL_GANG_RANK, "-1"))
            size = int(labels.get(LABEL_GANG_SIZE, "0"))
        except ValueError:
            rank, size = -1, 0
        if not gang_id or rank < 0 or size < 1:
            logx.warn("malformed gang member labels", job_id=req.job_id)
            return
        cached = self._done.get(req.job_id)
        if cached is not None and cached.gang_id == gang_id:
            await self._publish(gang_id, cached, trace_id)
            return
        existing = self._sessions.get(req.job_id)
        if existing is not None:
            if existing.gang_id == gang_id:
                return  # redelivery of an in-flight member
            # a fresh gang attempt for the same job: the old session is
            # tearing down — wait it out (bounded) so the new attempt is
            # not mistaken for a redelivery
            deadline = time.monotonic() + self.rendezvous_timeout_s
            while self._sessions.get(req.job_id) is existing:
                if time.monotonic() > deadline:
                    logx.warn("stale gang session blocks new attempt",
                              job_id=req.job_id, old_gang=existing.gang_id,
                              new_gang=gang_id)
                    return  # the scheduler's rendezvous backstop retries
                await asyncio.sleep(0.02)
        t = asyncio.ensure_future(self._run_member(
            req, payload, gang_id, rank, size,
            trace_id=trace_id, parent_span_id=parent_span_id,
        ))
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        await t

    async def _publish(self, gang_id: str, msg: GangMsg, trace_id: str) -> None:
        await self.worker.bus.publish(
            subj.gang_subject(gang_id),
            BusPacket.wrap(msg, trace_id=trace_id, sender_id=self.worker.worker_id),
        )

    async def _run_member(
        self, req: JobRequest, payload: Any, gang_id: str, rank: int, size: int,
        *, trace_id: str, parent_span_id: str,
    ) -> None:
        from .runtime import JobContext

        worker = self.worker
        ctx = JobContext(request=req, payload=payload, worker=worker)
        session = _GangSession(gang_id, req.job_id, rank, size, trace_id=trace_id)
        self._sessions[req.job_id] = session
        worker._active[req.job_id] = ctx
        worker._mark_busy()

        async def _on_gang_pkt(subject: str, pkt: BusPacket) -> None:
            self._route(session, pkt)

        sub = await worker.bus.subscribe(subj.gang_subject(gang_id), _on_gang_pkt)
        tracer = worker.tracer
        exec_span = tracer.begin(
            "gang-execute", trace_id=trace_id, parent_span_id=parent_span_id,
            attrs={"job_id": req.job_id, "gang_id": gang_id,
                   "rank": str(rank), "worker_id": worker.worker_id},
        )
        # a serving gang's rank 0 opens its rendezvous store before it
        # beacons, so every peer that passes the barrier knows the address
        store = None
        ready_stats: dict = {}
        beacon: Optional[asyncio.Future] = None
        try:
            if rank == 0 and size > 1 and _is_serving(payload):
                store, ready_stats["store"] = await worker.run_in_executor(
                    lambda: open_store(size, timeout_s=self.peer_timeout_s,
                                       advertise_host=self.store_host or None))
            beacon = asyncio.ensure_future(self._beacon_loop(session, trace_id, ready_stats))
            rdv_span = tracer.begin(
                "gang-rendezvous", trace_id=trace_id,
                parent_span_id=exec_span.span_id,
                attrs={"gang_id": gang_id, "rank": str(rank)},
            )
            t0 = time.monotonic()
            await self._barrier(session, ctx)
            waited = time.monotonic() - t0
            rdv_span.attrs["members"] = str(size)
            await tracer.finish(rdv_span)
            metrics = getattr(worker, "gang_metrics", None)
            if metrics is not None:
                metrics.gang_rendezvous_seconds.observe(waited)

            step_span = tracer.begin(
                "gang-step", trace_id=trace_id,
                parent_span_id=exec_span.span_id,
                attrs={"gang_id": gang_id, "rank": str(rank)},
            )
            stats = await self._run_program(session, ctx, payload, store)
            if stats.get("loss") is not None:
                step_span.attrs["loss"] = f"{stats['loss']:.4f}"
            step_span.attrs["mode"] = str(stats.get("mode", ""))
            await tracer.finish(step_span)

            done = GangMsg(
                gang_id=gang_id, job_id=req.job_id, kind="done", rank=rank,
                worker_id=worker.worker_id, stats=stats,
            )
            if len(self._done) > _DONE_CACHE_CAP:
                self._done.clear()
            self._done[req.job_id] = done
            await self._publish(gang_id, done, trace_id)
            exec_span.attrs["status"] = "DONE"
            await tracer.finish(exec_span)
        except GangAborted as e:
            reason = str(e) or "abort"
            exec_span.attrs["status"] = "ABORTED"
            exec_span.attrs["reason"] = reason
            await tracer.finish(exec_span, status="ERROR")
            if not session.abort.is_set():
                # a locally-originated abort (timeout, cancel, refusal)
                await self._publish(gang_id, GangMsg(
                    gang_id=gang_id, job_id=req.job_id, kind="abort",
                    rank=rank, worker_id=worker.worker_id, reason=reason,
                ), trace_id)
        except asyncio.CancelledError:
            # worker shutdown: die silently, as a killed process would — the
            # scheduler's watchdog recovers the gang
            raise
        except Exception as e:  # noqa: BLE001 - a member failure aborts the gang
            reason = f"member_failed:{type(e).__name__}"
            logx.warn("gang member failed", job_id=req.job_id,
                      gang_id=gang_id, rank=rank, err=str(e))
            exec_span.attrs["status"] = "FAILED"
            exec_span.attrs["error"] = type(e).__name__
            await tracer.finish(exec_span, status="ERROR")
            await self._publish(gang_id, GangMsg(
                gang_id=gang_id, job_id=req.job_id, kind="abort", rank=rank,
                worker_id=worker.worker_id, reason=reason,
            ), trace_id)
        finally:
            if beacon is not None:
                beacon.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await beacon
            sub.unsubscribe()
            store = None  # rank 0's store server closes with its last reference
            self._sessions.pop(req.job_id, None)
            worker._active.pop(req.job_id, None)
            worker._mark_idle()

    def _route(self, session: _GangSession, pkt: BusPacket) -> None:
        msg = pkt.gang_msg
        if msg is not None and pkt.sender_id != self.worker.worker_id:
            session.on_msg(msg)

    async def _beacon_loop(self, session: _GangSession, trace_id: str, stats: dict) -> None:
        """Re-publish the ready beacon for the member's whole lifetime: a
        peer that subscribed late must still complete its barrier."""
        msg = GangMsg(
            gang_id=session.gang_id, job_id=session.job_id, kind="ready",
            rank=session.rank, worker_id=self.worker.worker_id, stats=dict(stats),
        )
        while not session.abort.is_set():
            await self._publish(session.gang_id, msg, trace_id)
            await asyncio.sleep(self.beacon_interval_s)

    async def _barrier(self, session: _GangSession, ctx) -> None:
        deadline = time.monotonic() + self.rendezvous_timeout_s
        while not session.barrier.is_set():
            session.check_abort()
            if ctx.cancelled.is_set():
                raise GangAborted("cancelled")
            if time.monotonic() > deadline:
                raise GangAborted(
                    f"rendezvous_timeout:rank{session.rank}:"
                    f"saw{len(session.ready)}of{session.size}"
                )
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(session.barrier.wait(), 0.1)

    # ------------------------------------------------------------------
    # step programs
    # ------------------------------------------------------------------
    async def _run_program(self, session: _GangSession, ctx, payload: Any, store) -> dict:
        payload = payload if isinstance(payload, dict) else {}
        op = str(payload.get("op", "train"))
        if _is_serving(payload):
            return await self._run_serving(session, ctx, payload, store)
        if op == "train":
            pp = int((payload.get("mesh") or {}).get("pp", 1) or 1)
            if session.size > 1 and pp == session.size:
                return await self._run_mpmd(session, ctx, payload)
            return await self._run_spmd(session, ctx, payload)
        if op == "gang_test":
            return await self._run_gang_test(session, ctx, payload)
        # barrier-only member (echo-class)
        return {"op": op, "mode": "barrier", "rank": session.rank}

    def _abort_poll(self, session: _GangSession, ctx):
        return lambda: session.abort.is_set() or ctx.cancelled.is_set()

    def _check(self, session: _GangSession, ctx) -> None:
        session.check_abort()
        if ctx.cancelled.is_set():
            raise GangAborted("cancelled")

    async def _run_spmd(self, session: _GangSession, ctx, payload: dict) -> dict:
        """Every member runs the identical training program on its card."""
        if self.trainer is None:
            raise RuntimeError("gang runner has no trainer attached")
        cancelled = self._abort_poll(session, ctx)
        out = await self.worker.run_in_executor(
            lambda: self.trainer.train(payload, cancelled=cancelled))
        self._check(session, ctx)
        if not out.get("completed", False):
            raise GangAborted(session.abort_reason or "cancelled")
        return {**out, "mode": "spmd", "rank": session.rank, "loss": out.get("final_loss")}

    async def _run_gang_test(self, session: _GangSession, ctx, payload: dict) -> dict:
        """Spin for ``spin_s`` checking the abort latch, failing outright on
        workers named in ``fail_workers`` — the fault tests' harness."""
        if self.worker.worker_id in (payload.get("fail_workers") or []):
            raise RuntimeError("gang_test: injected member failure")
        spin_s = float(payload.get("spin_s", 0.0) or 0.0)
        deadline = time.monotonic() + spin_s
        while time.monotonic() < deadline:
            self._check(session, ctx)
            await asyncio.sleep(0.02)
        return {"op": "gang_test", "mode": "spin", "rank": session.rank, "spin_s": spin_s}

    # ------------------------------------------------------------------
    # MPMD pipeline: one stage per worker, activations over the bus
    # ------------------------------------------------------------------
    async def _run_mpmd(self, session: _GangSession, ctx, payload: dict) -> dict:
        """This rank's stage of an MPMD pipeline gang (the reference's
        ``_run_mpmd``, ``gang.py:698-790``): every microbatch forward
        through the stage (fill), then every cotangent back (drain), the
        gradients summed over the microbatches and one SGD step of ``lr /
        microbatches``.  ``batch`` is rounded DOWN to the microbatch count,
        as the reference rounds it."""
        worker = self.worker
        rank, size = session.rank, session.size
        state = await worker.run_in_executor(
            lambda: mpmd_state(mpmd_draw(payload, size), rank, size, mpmd_base(),
                               worker.device))
        steps = int(payload.get("steps", 1) or 1)
        micro = max(1, int(payload.get("microbatches", 1) or 1))
        batch = int(payload.get("batch", 4) or 4)
        batch = max(micro, (batch // micro) * micro)
        seq = int(payload.get("seq", 16) or 16)
        lr = float(payload.get("lr", 1e-3) or 1e-3)
        losses: list[float] = []
        for step in range(steps):
            self._check(session, ctx)
            # every rank draws the same tokens: only activations and
            # cotangents cross the wire, never the batch
            mbs = mpmd_tokens(step, batch, seq, state["vocab"]).reshape(micro, batch // micro, seq)
            graphs: list[Any] = []
            grads: list[torch.Tensor] = []
            mb_losses: list[float] = []
            for m in range(micro):  # fill
                x = None
                if rank > 0:
                    x = from_wire(*await session.recv(f"fwd:{step}:{m}:{rank}",
                                                      self.peer_timeout_s))
                out = await worker.run_in_executor(
                    lambda x=x, m=m: mpmd_forward(state, mbs[m], x))
                graphs.append(out)
                if rank == size - 1:
                    mb_losses.append(out[0])
                else:
                    await self._send_stage(session, f"fwd:{step}:{m}:{rank + 1}", rank + 1, out[0])
            for m in range(micro):  # drain
                if rank == size - 1:
                    _, g_params, g_x = graphs[m]
                else:
                    g_y = from_wire(*await session.recv(f"bwd:{step}:{m}:{rank}",
                                                        self.peer_timeout_s))
                    g_params, g_x = await worker.run_in_executor(
                        lambda g=graphs[m][1], g_y=g_y: mpmd_backward(g, g_y))
                graphs[m] = None  # this microbatch's graph and activations go
                if rank > 0:
                    await self._send_stage(session, f"bwd:{step}:{m}:{rank - 1}", rank - 1, g_x)
                grads = [a + b for a, b in zip(grads, g_params)] if grads else g_params
            await worker.run_in_executor(lambda g=grads: mpmd_sgd(state, g, lr / micro))
            if mb_losses:
                losses.append(sum(mb_losses) / len(mb_losses))
        return {
            "mode": "mpmd",
            "rank": rank,
            "steps_done": steps,
            "mesh": {"pp": size, "dp": 1},
            "microbatches": micro,
            "loss": losses[-1] if losses else None,
            "loss_first": losses[0] if losses else None,
        }

    async def _send_stage(self, session: _GangSession, tag: str, to_rank: int,
                          arr: np.ndarray) -> None:
        await self._publish(session.gang_id, GangMsg(
            gang_id=session.gang_id, job_id=session.job_id, kind="stage",
            rank=session.rank, to_rank=to_rank, tag=tag,
            data=arr.tobytes(), shape=list(arr.shape),
            worker_id=self.worker.worker_id,
        ), session.trace_id)

    # ------------------------------------------------------------------
    # serving gangs: tensor-parallel ragged serving over the gang
    # ------------------------------------------------------------------
    def serving_gang_doc(self) -> dict:
        """This worker's live serving-gang membership for the telemetry
        beacon (empty: not serving in a gang).  Rank 0's doc carries the
        measured throughput; followers' carry identity and arena headroom."""
        for doc in self._serving_gangs.values():
            out = dict(doc)
            cb = out.pop("_live", None)
            if callable(cb):
                with contextlib.suppress(Exception):
                    out.update(cb())
            return out
        return {}

    def _serving_backend(self, session: _GangSession, payload: dict, group):
        """This rank's backend from the payload's sizing knobs, as the
        reference builds it: ``LlamaConfig.tiny()`` in the payload's dtype,
        weights from ``params_provider`` or drawn from the payload's seed
        (each rank keeps its slices)."""
        dtype_name = str(payload.get("dtype", "float32") or "float32")
        cfg = dataclasses.replace(
            llama.LlamaConfig.tiny(),
            dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
        )
        provider = None
        if self.params_provider is not None:
            provider = lambda: self.params_provider(cfg)  # noqa: E731
        max_seqs = max(1, int(payload.get("max_sessions", 4) or 4))
        return ShardedServingBackend(
            cfg,
            rank=session.rank,
            tp=session.size,
            group=group,
            num_pages=max(2, int(payload.get("cache_pages", 64) or 64)),
            page_size=max(1, int(payload.get("page_size", 16) or 16)),
            max_seqs=max_seqs,
            max_batch_tokens=max_seqs + max(1, int(payload.get("prefill_budget", 16) or 16)),
            seed=int(payload.get("seed", 0) or 0),
            params_provider=provider,
            device=self.worker.device,
        )

    async def _join_group(self, session: _GangSession, ctx, store):
        """This rank's :class:`TPGroup`, bounded by the peer timeout.  An
        abort or cancel while the join blocks ends the member at once; a
        group that forms later is closed when its join returns."""
        worker = self.worker
        timeout_s = self.peer_timeout_s
        if session.size == 1:
            return None

        def join():
            st = store
            if st is None:
                if not session.store_addr:
                    raise RuntimeError("rank 0's ready beacon named no rendezvous store")
                st = connect_store(session.store_addr, session.size, timeout_s=timeout_s)
            return TPGroup.join(st, session.rank, session.size, worker.device,
                                timeout_s=timeout_s)

        fut = asyncio.ensure_future(worker.run_in_executor(join))
        abort_w = asyncio.ensure_future(session.abort.wait())
        cancel_w = asyncio.ensure_future(ctx.cancelled.wait())
        try:
            await asyncio.wait({fut, abort_w, cancel_w}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            abort_w.cancel()
            cancel_w.cancel()
        if not fut.done():
            def close_late(f: asyncio.Future) -> None:
                if f.exception() is None:
                    f.result().close()

            fut.add_done_callback(close_late)
            self._check(session, ctx)
        return await fut

    async def _run_serving(self, session: _GangSession, ctx, payload: dict, store) -> dict:
        """One serving-gang member: join the rank group, then lead (rank 0)
        or replay.  The group is torn down on every way out."""
        labels = ctx.request.labels or {}
        members = [m for m in labels.get(LABEL_GANG_MEMBERS, "").split(",") if m]
        group = await self._join_group(session, ctx, store)
        collective = group.backend if group is not None else ""
        metrics = getattr(self.worker, "gang_metrics", None)
        try:
            backend = self._serving_backend(session, payload, group)
            self._serving_gangs[session.gang_id] = serving_gang_block(
                session.gang_id, session.rank, session.size, members, backend.num_pages)
            if metrics is not None:
                metrics.serving_gang_members.set(float(session.size), gang=session.gang_id)
            try:
                if session.rank == 0:
                    out = await self._serve_leader(session, ctx, payload, backend)
                else:
                    out = await self._serve_follower(session, ctx, backend)
            finally:
                # linger_s keeps the gang's capacity row visible after the job
                # finishes; the abort latch cuts the linger short
                linger = float(payload.get("linger_s", 0.0) or 0.0)
                deadline = time.monotonic() + linger
                while time.monotonic() < deadline and not session.abort.is_set():
                    await asyncio.sleep(0.05)
                self._serving_gangs.pop(session.gang_id, None)
                if metrics is not None:
                    metrics.serving_gang_members.set(0.0, gang=session.gang_id)
        finally:
            if group is not None:
                group.close()
        return {**out, "collective": collective}

    async def _serve_leader(self, session: _GangSession, ctx, payload: dict, backend) -> dict:
        worker = self.worker
        loop = asyncio.get_running_loop()
        metrics = getattr(worker, "gang_metrics", None)
        seq = 0

        def _broadcast(entries) -> None:
            # called from the step's executor thread once the buffers are
            # built and BEFORE the device call: the step's all-reduces need
            # the followers stepping on the same entries.  Waiting for the
            # publish keeps the stream ordered.
            nonlocal seq
            msg = GangMsg(
                gang_id=session.gang_id, job_id=session.job_id, kind="step",
                rank=0, worker_id=worker.worker_id, stats=step_message(seq, entries),
            )
            seq += 1
            asyncio.run_coroutine_threadsafe(
                self._publish(session.gang_id, msg, session.trace_id), loop
            ).result()
            if metrics is not None:
                metrics.serving_gang_steps.inc(role="lead")

        backend.before_step = _broadcast
        engine = ServingEngine(
            backend,
            run_blocking=worker.run_in_executor,
            max_sessions=backend.max_seqs,
            max_new_tokens_cap=int(payload.get("max_new_tokens", 16) or 16),
            metrics=metrics,
            tracer=worker.tracer,
            # copy-on-write page copies happen outside step() and would not
            # replay on the followers: prefix sharing is off in a gang
            prefix_cache=False,
            speculative=bool(payload.get("speculative", False)),
            draft_k=int(payload.get("draft_k", 0) or 0) or 4,
        )
        prompts = payload.get("prompts")
        if not isinstance(prompts, list) or not prompts:
            one = payload.get("prompt") or payload.get("tokens") or [1, 2, 3]
            prompts = [one]
        prompts = [[int(t) for t in p] for p in prompts if p][: backend.max_seqs]
        max_new = int(payload.get("max_new_tokens", 16) or 16)
        live = {"t0": time.monotonic(), "tokens": 0}

        def _live() -> dict:
            dt = max(1e-6, time.monotonic() - live["t0"])
            return {"pages_free": engine.allocator.free_pages,
                    "tokens_per_s": round(live["tokens"] / dt, 3)}

        self._serving_gangs[session.gang_id]["_live"] = _live

        def _sink(first: bool):
            base = worker._token_sink(
                session.job_id, GenRequest(prompt=[], max_new_tokens=max_new),
            ) if first else None

            async def sink(new_tokens, n_generated, done):
                live["tokens"] += len(new_tokens)
                if metrics is not None and new_tokens:
                    metrics.serving_gang_stream_tokens.inc(len(new_tokens), rank="0")
                if base is not None:
                    await base(new_tokens, n_generated, done)

            return sink

        async def _drive() -> list[dict]:
            subs = [
                engine.submit(
                    GenRequest(prompt=p, max_new_tokens=max_new, stream=(i == 0)),
                    job_id=session.job_id if i == 0 else f"{session.job_id}#{i}",
                    trace_id=session.trace_id,
                    on_tokens=_sink(first=(i == 0)),
                )
                for i, p in enumerate(prompts)
            ]
            return await asyncio.gather(*subs)

        drive = asyncio.ensure_future(_drive())
        abort_w = asyncio.ensure_future(session.abort.wait())
        cancel_w = asyncio.ensure_future(ctx.cancelled.wait())
        try:
            done, _ = await asyncio.wait(
                {drive, abort_w, cancel_w}, return_when=asyncio.FIRST_COMPLETED)
            if drive not in done:
                drive.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await drive
                raise GangAborted(session.abort_reason or "cancelled")
            results = await drive
        finally:
            for w in (abort_w, cancel_w):
                w.cancel()
            with contextlib.suppress(Exception):
                await engine.stop()
            # the final marker releases the follower replay loops
            with contextlib.suppress(Exception):
                await self._publish(session.gang_id, GangMsg(
                    gang_id=session.gang_id, job_id=session.job_id,
                    kind="step", rank=0, worker_id=worker.worker_id,
                    stats=step_message(seq, final=True),
                ), session.trace_id)
        elapsed = max(1e-6, time.monotonic() - live["t0"])
        total = sum(len(r.get("tokens") or []) for r in results)
        return {
            "mode": "serving", "rank": 0, "tp": session.size,
            "sessions": len(results), "tokens": total,
            "tokens_per_s": round(total / elapsed, 3),
            "steps": seq, "compiled": backend.compiled_programs(),
            "results": results,
        }

    async def _serve_follower(self, session: _GangSession, ctx, backend) -> dict:
        """Replay rank 0's entry batches in seq order until the final
        marker.  A batch must never run early: :class:`StepReplay`
        reorders."""
        metrics = getattr(self.worker, "gang_metrics", None)
        replay = StepReplay(backend)
        while True:
            self._check(session, ctx)
            while session.steps:
                replay.offer(session.steps.popleft().stats or {})
            msg = replay.next()
            if msg is None:
                await self._next_step_msg(session, ctx, replay.expected)
            elif msg.get("final"):
                return {
                    "mode": "serving", "rank": session.rank,
                    "tp": session.size, "steps_replayed": replay.replayed,
                    "compiled": backend.compiled_programs(),
                }
            elif await self.worker.run_in_executor(lambda m=msg: replay.step(m)):
                if metrics is not None:
                    metrics.serving_gang_steps.inc(role="replay")

    async def _next_step_msg(self, session: _GangSession, ctx, expected: int) -> None:
        """Wait for the leader's next message, watching the abort latch and
        the cancel flag; nothing for ``peer_timeout_s`` aborts the gang."""
        deadline = time.monotonic() + self.peer_timeout_s
        while not session.steps:
            self._check(session, ctx)
            if time.monotonic() > deadline:
                raise GangAborted(f"peer_timeout:step{expected}")
            session.step_event.clear()
            if session.steps:
                return
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(session.step_event.wait(), 0.1)


# ---------------------------------------------------------------------------
# MPMD stage math (blocking calls for the worker's executor threads)
# ---------------------------------------------------------------------------


class StageGraph(NamedTuple):
    """A microbatch's forward through a stage, kept until its cotangent
    arrives: the stage output and what its gradient is taken for (the
    stage's param leaves, then the received activation on ranks past 0)."""

    y: torch.Tensor
    inputs: list
    with_input: bool


def mpmd_base() -> llama.LlamaConfig:
    """The model an MPMD gang trains: ``LlamaConfig.tiny()`` in fp32, as the
    reference builds it."""
    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)


def mpmd_draw(payload: dict, size: int) -> dict:
    """The full stacked pipeline params every rank draws alike, from a CPU
    ``torch.Generator`` seeded with the payload's ``seed``: a generator on a
    card draws other numbers than one on the CPU, so ranks on different
    devices would train different models with no error.  ``ValueError`` when
    the layers do not split into ``size`` stages."""
    base = mpmd_base()
    if base.n_layers % size:
        raise ValueError(f"pipeline needs n_layers {base.n_layers} divisible by pp={size}")
    cfg = pipeline.PipelineConfig(base=base, n_stages=size, n_microbatches=1)
    gen = torch.Generator().manual_seed(int(payload.get("seed", 0) or 0))
    return pipeline.init_params(cfg, generator=gen, device="cpu")


def mpmd_tokens(step: int, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """Step ``step``'s batch ``[batch, seq]``, the same on every rank: from a
    CPU generator seeded ``1000 + step`` (the reference's key)."""
    gen = torch.Generator().manual_seed(1000 + step)
    return torch.randint(0, vocab, (batch, seq), generator=gen)


def mpmd_state(full: dict, rank: int, size: int, base: llama.LlamaConfig,
               device: DeviceLike) -> dict:
    """Rank ``rank``'s slice of ``full`` (stacked pipeline params): its
    stage's leaves, the embedding on rank 0, the final norm and the head on
    the last rank, as leaves that require grad on ``device``."""
    params: dict = {"stage": pipeline.layer_views(full["stages"])[rank]}
    if rank == 0:
        params["embed"] = full["embed"]
    if rank == size - 1:
        params["final_norm"] = full["final_norm"]
        params["lm_head"] = full["lm_head"]
    dev = resolve_device(device)
    params = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params)
    return {"params": params, "base": base, "vocab": base.vocab_size, "rank": rank,
            "size": size, "device": dev}


def to_wire(t: torch.Tensor) -> np.ndarray:
    """A stage tensor as the wire carries it: little-endian float32."""
    return t.detach().to("cpu", torch.float32).numpy().astype(WIRE_DTYPE, copy=False)


def from_wire(data: bytes, shape: list[int]) -> np.ndarray:
    return np.frombuffer(data, WIRE_DTYPE).reshape(shape)


def mpmd_forward(state: dict, tokens_mb: torch.Tensor, x_in: Optional[np.ndarray]):
    """One microbatch through this rank's stage (the reference's
    ``_mpmd_forward``), on the state's device:

    * rank 0: ``(activation, graph)``, the graph for the params only;
    * middle ranks: ``(activation, graph)`` for the params and the input;
    * the last rank: ``(loss, param grads, input cotangent)``: the backward
      starts here, so the loss and both gradients come from one call.

    Activations and cotangents are wire arrays (:func:`to_wire`)."""
    params, base, dev = state["params"], state["base"], state["device"]
    rank, size = state["rank"], state["size"]
    tokens = tokens_mb.to(dev)
    mb, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=dev).expand(mb, t)
    leaves = tree_leaves(params)
    with torch.enable_grad():
        if rank == 0:
            x = params["embed"][tokens.long()].float()
        else:
            x = torch.from_numpy(np.array(x_in, np.float32)).to(dev).requires_grad_(True)
        y = pipeline._stage_apply(params["stage"], x, positions, base)
        if rank < size - 1:
            inputs = leaves if rank == 0 else [*leaves, x]
            return to_wire(y), StageGraph(y, inputs, rank > 0)
        loss = pipeline.microbatch_nll(y, tokens, params, base) / (mb * (t - 1))
        *g_params, g_x = torch.autograd.grad(loss, [*leaves, x])
    return float(loss.detach()), g_params, to_wire(g_x)


def mpmd_backward(graph: StageGraph, g_y: np.ndarray):
    """Pull the received cotangent through this rank's forward: ``(param
    grads, input cotangent)``, the cotangent ``None`` on rank 0.  The graph
    is freed."""
    g = torch.from_numpy(np.array(g_y, np.float32)).to(graph.y.device, graph.y.dtype)
    grads = list(torch.autograd.grad(graph.y, graph.inputs, grad_outputs=g))
    if not graph.with_input:
        return grads, None
    g_x = grads.pop()
    return grads, to_wire(g_x)


@torch.no_grad()
def mpmd_sgd(state: dict, grads: list[torch.Tensor], lr: float) -> None:
    """``p -= lr * g`` on this rank's leaves, in place."""
    for p, g in zip(tree_leaves(state["params"]), grads):
        p.sub_(lr * g)


__all__ = ["GangRunner", "GangAborted"]
