"""Tensor-parallel serving over a gang of ranks: the sharded half of the
serving backend, the counterpart of ``cordum_tpu/serving/shard.py``.

One session set, ``tp`` ranks.  Every rank runs the same ragged mixed
prefill+decode step (``models/llama.ragged_step``) over its slice of the
model, with two all-reduces a layer over a ``torch.distributed`` group
(:class:`..parallel.mesh.TPGroup`):

  * weights split Megatron-style (:func:`..models.llama.shard_params`):
    column-parallel ``wq``/``wk``/``wv`` by head and ``w_gate``/``w_up`` by
    ``d_ff``, row-parallel ``wo`` and ``w_down``, whose partial products
    are summed across the ranks before the residual add;
  * both KV page arenas split by head, ``[L, pages, ps, kvh / tp, hd]``,
    matching ``wk``/``wv``, so page writes and the paged attention (B1, at
    the rank's ``n_heads / tp`` query heads) stay on the rank;
  * rank 0 alone samples: followers skip the lm_head projection and hold
    no lm_head.  Rank 0 owns token streaming, admission and the session
    registry (``worker/gang.py``).

How this differs from the reference:

  * the reference places the full weights and arenas with
    ``NamedSharding`` over ``rank_mesh(tp)`` and lets GSPMD split them (on
    one device every rank holds a full replica); here each rank draws or
    receives the full weights and keeps only its slices
    (``init_params(shard=)``, ``shard_params``), and the sums across ranks
    are explicit all-reduces;
  * ``embed`` and ``lm_head`` stay whole on every rank (the reference
    splits them on the vocabulary): only rank 0 uses ``lm_head``, and a
    vocabulary-split argmax would need a cross-rank (max, index) reduction;
  * there is no ``init_distributed``: a cross-process gang's ranks meet at
    a ``TCPStore`` that rank 0 opens (``worker/gang.py``), and
    :class:`ServingGangGroup`'s ranks are threads of one process over
    in-process gloo groups;
  * a rank's arena already holds only its heads, so :meth:`export_kv`
    stamps the per-rank header without slicing again, and
    :meth:`ShardedServingBackend.import_kv` keeps only its heads of the
    merged records.

Per-rank migration records carry ``rank``/``tp``/``heads: [lo, hi)``;
:func:`merge_rank_records` reassembles full-head records from any rank
order, byte-compatible with the single-rank format, so drain, failover and
hand-off work between a gang and a single-rank backend of either package.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..parallel.mesh import TPGroup, in_process_groups
from .backend import LlamaServingBackend, StepEntry

__all__ = [
    "heads_for_rank",
    "slice_rank_record",
    "merge_rank_records",
    "entry_to_wire",
    "entry_from_wire",
    "step_message",
    "StepReplay",
    "ShardedServingBackend",
    "ServingGangGroup",
]

#: seconds an in-process gang's collective may wait for a peer rank
GROUP_TIMEOUT_S = 120.0


def heads_for_rank(n_kv_heads: int, tp: int, rank: int) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` KV-head slice rank ``rank`` owns under a
    ``tp``-way split.  Heads must divide evenly."""
    if tp < 1 or not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    if n_kv_heads % tp:
        raise ValueError(f"{n_kv_heads} kv heads not divisible by tp={tp}")
    per = n_kv_heads // tp
    return rank * per, (rank + 1) * per


def slice_rank_record(rec: dict, rank: int, tp: int, lo: int, hi: int) -> dict:
    """One rank's head slice of a full page record.  The wire shape stays
    ``[L, used, heads, hd]`` float32; the header grows ``rank``/``tp``/
    ``heads=[lo, hi)`` so the importer knows where the slice lands."""
    shape = tuple(rec["shape"])
    k = np.frombuffer(rec["k"], np.float32).reshape(shape)[:, :, lo:hi]
    v = np.frombuffer(rec["v"], np.float32).reshape(shape)[:, :, lo:hi]
    return {
        "i": rec["i"], "used": rec["used"],
        "k": np.ascontiguousarray(k).tobytes(),
        "v": np.ascontiguousarray(v).tobytes(),
        "shape": list(k.shape),
        "rank": rank, "tp": tp, "heads": [lo, hi],
    }


def merge_rank_records(records: list[dict]) -> list[dict]:
    """Reassemble full-head page records from a per-rank gang export.

    Groups by page ordinal ``i``, orders each group by ``heads[0]``,
    concatenates along the head axis, and checks that the slices tile the
    head axis exactly (contiguous, no gap, no overlap).  Plain full-head
    records pass through untouched, so a mixed list merges too."""
    plain = [r for r in records if "heads" not in r]
    sliced = [r for r in records if "heads" in r]
    by_ord: dict[int, list[dict]] = {}
    for rec in sliced:
        by_ord.setdefault(int(rec["i"]), []).append(rec)
    out = list(plain)
    for o, group in sorted(by_ord.items()):
        group = sorted(group, key=lambda r: int(r["heads"][0]))
        ks, vs, cursor = [], [], 0
        for rec in group:
            lo, hi = (int(x) for x in rec["heads"])
            if lo != cursor:
                raise ValueError(
                    f"page {o}: head slice [{lo}, {hi}) does not start at "
                    f"{cursor} — rank records missing or overlapping"
                )
            shape = tuple(rec["shape"])
            ks.append(np.frombuffer(rec["k"], np.float32).reshape(shape))
            vs.append(np.frombuffer(rec["v"], np.float32).reshape(shape))
            cursor = hi
        tp = int(group[0].get("tp", len(group)))
        if len(group) != tp:
            raise ValueError(f"page {o}: {len(group)} rank slices for tp={tp}")
        k = np.concatenate(ks, axis=2)
        v = np.concatenate(vs, axis=2)
        out.append({
            "i": o, "used": int(group[0]["used"]),
            "k": np.ascontiguousarray(k).tobytes(),
            "v": np.ascontiguousarray(v).tobytes(),
            "shape": list(k.shape),
        })
    out.sort(key=lambda r: int(r["i"]))
    return out


# ---------------------------------------------------------------------------
# StepEntry wire codec: the replay protocol rides GangMsg (kind="step")
# stats dicts, so entries must round-trip through the bus codec
# ---------------------------------------------------------------------------


def entry_to_wire(e: StepEntry) -> dict:
    return {
        "tokens": [int(t) for t in e.tokens], "start": int(e.start),
        "pages": [int(p) for p in e.pages], "sample": bool(e.sample),
        "phase": e.phase, "key": e.key, "draft": int(e.draft),
    }


def entry_from_wire(d: dict) -> StepEntry:
    return StepEntry(
        tokens=list(d.get("tokens") or []), start=int(d.get("start", 0)),
        pages=list(d.get("pages") or []), sample=bool(d.get("sample", True)),
        phase=str(d.get("phase", "decode")), key=str(d.get("key", "")),
        draft=int(d.get("draft", 0)),
    )


def step_message(seq: int, entries: Optional[list[StepEntry]] = None, **marks: Any) -> dict:
    """Message ``seq`` of a gang's step stream, leader to followers: one
    step's entries, shipped before the leader's own device call (the
    step's all-reduces need every rank stepping on them), or a marker such
    as ``final=True``, which ends the stream."""
    msg: dict = {"seq": int(seq), **marks}
    if entries is not None:
        msg["entries"] = [entry_to_wire(e) for e in entries]
    return msg


class StepReplay:
    """A follower's end of the step stream.  The transport is the
    caller's (``worker/gang.py`` reads the statebus, a benchmark a
    ``TCPStore``): :meth:`offer` takes the leader's messages in any arrival
    order, :meth:`next` hands each back once in ``seq`` order (``None``
    while the next one has not arrived), and :meth:`step` runs a message's
    entries on the rank's backend.  ``replayed`` counts the steps run."""

    def __init__(self, backend: Any) -> None:
        self.backend = backend
        self.expected = 0
        self.replayed = 0
        self._pending: dict[int, dict] = {}

    def offer(self, msg: dict) -> None:
        seq = int(msg.get("seq", -1))
        if seq >= self.expected:
            self._pending[seq] = msg

    def next(self) -> Optional[dict]:
        msg = self._pending.pop(self.expected, None)
        if msg is not None:
            self.expected += 1
        return msg

    def step(self, msg: dict) -> bool:
        """Run ``msg``'s entries; ``False`` for a marker (nothing to run)."""
        entries = [entry_from_wire(d) for d in msg.get("entries") or []]
        if not entries:
            return False
        self.backend.step(entries)
        self.replayed += 1
        return True


class ShardedServingBackend(LlamaServingBackend):
    """One rank of a tensor-parallel serving gang.

    The step semantics and static shapes of :class:`LlamaServingBackend`,
    plus:

      * ``rank``/``tp`` and the rank's ``[lo, hi)`` KV-head slice;
      * the rank's slices of the weights and a ``kvh / tp``-head arena
        (from ``params_provider``'s full weights, or drawn leaf by leaf from
        the seed so that the whole model is never held);
      * ``group``, the rank group its step all-reduces over (``None`` only
        with ``tp == 1``);
      * followers (``rank > 0``) run with ``sample_output=False``: no
        lm_head projection, and no lm_head held;
      * :meth:`export_kv` emits per-rank records; :meth:`import_kv` takes
        per-rank or full records and keeps its heads.
    """

    def __init__(self, cfg: Any = None, *, rank: int = 0, tp: int = 1,
                 group: Optional[TPGroup] = None,
                 sample_output: Optional[bool] = None, **kw: Any) -> None:
        super().__init__(cfg, **kw)
        self.rank = int(rank)
        self.tp = max(1, int(tp))
        llama.check_tp(self.cfg, self.tp)
        self.heads = heads_for_rank(self.cfg.n_kv_heads, self.tp, self.rank)
        if self.tp > 1 and (group is None or group.size != self.tp or group.rank != self.rank):
            raise ValueError(f"rank {self.rank} of tp={self.tp} needs its rank group")
        self.tp_group = group if self.tp > 1 else None
        # rank 0 owns sampling unless the caller says otherwise
        self.sample_output = (self.rank == 0) if sample_output is None else bool(sample_output)

    def _init_state(self) -> tuple[Any, torch.Tensor, torch.Tensor]:
        provider = self._params_provider
        return llama.shard_serving_state(
            self.cfg, self.rank, self.tp, num_pages=self.num_pages, page_size=self.page_size,
            params=provider() if provider is not None else None,
            generator=None if provider is not None
            else torch.Generator(device=self.device).manual_seed(self._seed),
            lm_head=bool(self.sample_output), device=self.device)

    def export_kv(self, pages: list[int], start_tok: int, end_tok: int) -> list[dict]:
        """This rank's head slice of every page record, with the per-rank
        header.  A gang's full export is the concatenation over ranks, in
        any order.  With ``tp == 1`` the plain records ship unchanged."""
        records = super().export_kv(pages, start_tok, end_tok)
        if self.tp <= 1:
            return records
        lo, hi = self.heads
        return [{**r, "rank": self.rank, "tp": self.tp, "heads": [lo, hi]} for r in records]

    def import_kv(self, pages: list[int], records: list[dict]) -> None:
        """Merge per-rank records (any rank order), then write this rank's
        heads of each full-head record."""
        if not records:
            return
        if any("heads" in rec for rec in records):
            records = merge_rank_records(records)
        if self.tp > 1:
            lo, hi = self.heads
            records = [slice_rank_record(r, self.rank, self.tp, lo, hi) for r in records]
        self._scatter_records(pages, records)

    def close(self) -> None:
        """Tear down the rank group (idempotent)."""
        if self.tp_group is not None:
            self.tp_group.close()


class ServingGangGroup:
    """An in-process tensor-parallel serving gang: rank 0 (the leader,
    sampling) plus ``tp - 1`` followers, each with its slices and its
    in-process gloo group, driven lock-step and used wherever a
    :class:`LlamaServingBackend` goes.

    Every rank steps on the same entries: the followers each in a thread
    of their own (their all-reduces meet the leader's), the leader in the
    calling thread; results come from the leader alone.  Cross-process
    gangs (``worker/gang.py`` ``_run_serving``) are this loop with the
    followers' entries shipped over the bus ahead of the leader's step
    (:func:`step_message`, :class:`StepReplay`).
    :meth:`close` tears the groups down."""

    supports_draft = True
    on_step: Optional[Callable[[list[StepEntry]], None]] = None

    def __init__(self, cfg: Any = None, *, tp: int = 2, metrics: Any = None,
                 **kw: Any) -> None:
        if tp < 1:
            raise ValueError(f"tp={tp}")
        llama.check_tp(cfg or llama.LlamaConfig.tiny(), tp)
        dev = resolve_device(kw.get("device"))
        groups = in_process_groups(tp, dev, timeout_s=GROUP_TIMEOUT_S) if tp > 1 else [None]
        # metrics ride on the leader only: the group is ONE serving
        # position; per-rank step shapes stay visible in compiled_per_rank()
        self.ranks = [
            ShardedServingBackend(cfg, rank=r, tp=tp, group=groups[r],
                                  metrics=metrics if r == 0 else None, **kw)
            for r in range(tp)
        ]
        self.tp = tp
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max(1, tp - 1), thread_name_prefix="tp-rank")

    # -- backend facade ------------------------------------------------
    @property
    def leader(self) -> ShardedServingBackend:
        return self.ranks[0]

    @property
    def cfg(self):
        return self.leader.cfg

    @property
    def device(self) -> torch.device:
        return self.leader.device

    @property
    def page_size(self) -> int:
        return self.leader.page_size

    @property
    def num_pages(self) -> int:
        return self.leader.num_pages

    @property
    def max_context(self) -> int:
        return self.leader.max_context

    @property
    def pages_per_seq(self) -> int:
        return self.leader.pages_per_seq

    @property
    def max_seqs(self) -> int:
        return self.leader.max_seqs

    @property
    def max_batch_tokens(self) -> int:
        return self.leader.max_batch_tokens

    @property
    def last_step_compiled(self) -> bool:
        return any(r.last_step_compiled for r in self.ranks)

    def compiled_programs(self) -> int:
        return self.leader.compiled_programs()

    def compiled_per_rank(self) -> list[int]:
        return [r.compiled_programs() for r in self.ranks]

    # -- lock-step execution -------------------------------------------
    def _on_device(self, fn: Callable[[], Any]) -> Any:
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return fn()
        return fn()

    def step(self, entries: list[StepEntry]) -> list[Any]:
        with self._lock:
            followers = [self._pool.submit(self._on_device, lambda r=r: r.step(entries))
                         for r in self.ranks[1:]]
            try:
                res = self.leader.step(entries)
            finally:
                # a follower's failure (a collective that timed out) raises here
                for f in followers:
                    f.result()
        if self.on_step is not None:
            self.on_step(entries)
        return res

    def export_kv(self, pages: list[int], start_tok: int, end_tok: int) -> list[dict]:
        out: list[dict] = []
        with self._lock:
            for r in self.ranks:
                out.extend(r.export_kv(pages, start_tok, end_tok))
        return out

    def import_kv(self, pages: list[int], records: list[dict]) -> None:
        with self._lock:
            for r in self.ranks:
                r.import_kv(pages, records)

    def copy_page(self, src: int, dst: int) -> None:
        with self._lock:
            for r in self.ranks:
                r.copy_page(src, dst)

    def close(self) -> None:
        """Tear down the rank groups and the follower threads."""
        for r in self.ranks:
            r.close()
        self._pool.shutdown(wait=False)

    # -- compat conveniences (same contracts as the base backend) ------
    def prefill(self, prompt: list[int], pages: list[int]) -> int:
        return LlamaServingBackend.prefill(self, prompt, pages)  # type: ignore[arg-type]

    def decode(self, entries: list[tuple[int, int, list[int]]]) -> list[int]:
        return LlamaServingBackend.decode(self, entries)  # type: ignore[arg-type]
