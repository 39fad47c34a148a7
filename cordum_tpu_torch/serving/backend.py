"""The device half of the serving path: ONE ragged mixed prefill+decode step.

The PyTorch counterpart of ``cordum_tpu/serving/backend.py``.  One backend
per worker process owns the KV-page arena (``models/llama``
``init_kv_pages``) and runs every device call — a decode step over the
live sessions, a chunk of some prompt's prefill, a speculative draft row,
or any mix — through :meth:`LlamaServingBackend.step` with the same static
operand shapes:

  * a flat token buffer of ``max_batch_tokens`` slots (decode last-tokens
    and prefill chunk tokens interleaved, tail padded onto the null page);
  * per-sequence metadata: page tables ``[max_seqs + 1, pages_per_seq]``
    (the +1 row is the all-null padding row), per-token sequence ids and
    positions, and each sequence's sampling index.

The shapes never change, so ``compiled_programs()`` — the count of distinct
step shapes — stays 1, as in the JAX backend, and ``last_step_compiled``
marks only the first step.  PyTorch runs eagerly: nothing is compiled, and
the attention core is the hand-written paged-attention kernel on a card.

:meth:`step` is **blocking** (called from the worker's executor threads)
and serializes every arena mutation and read under one lock: the steps
update the arena in place.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import llama
from ..ops.paged_attention import build_plan

DEFAULT_MAX_SEQS = 16


@dataclass
class StepEntry:
    """One sequence's contribution to a mixed ragged step.

    A decode step feeds exactly one token (the session's last emitted
    token) at its current position; a prefill chunk feeds a slice of the
    prompt starting at ``start``.  ``sample=True`` asks for the next token
    from the last fed position (always for decode; only for the chunk that
    completes a prompt).

    ``draft > 0`` marks a speculative verification row (docs/SERVING.md
    §Speculative decoding): ``tokens`` is ``[last_token, d_1..d_k]`` — the
    session's last emitted token followed by ``draft`` drafted
    continuations — and :meth:`LlamaServingBackend.step` returns the
    per-position next-token predictions for ALL k+1 fed positions (a
    ``list[int]``) instead of the single sequence-final sample.  The row
    is prefill-shaped on the wire; only the result shape differs."""

    tokens: list[int]
    start: int  # global sequence position of tokens[0]
    pages: list[int]  # the session's page list (page-table row prefix)
    sample: bool = True
    phase: str = "decode"  # "prefill" | "decode" — observability + fakes
    key: str = ""  # session/job id — observability + fakes
    draft: int = 0  # >0: speculative row with this many drafted tokens


class LlamaServingBackend:
    # the ragged step returns per-position predictions for every buffer
    # row, so draft verification rows (StepEntry.draft > 0) are supported
    # natively — the engine gates its drafter on this capability flag
    supports_draft = True
    # sharded serving: follower ranks set this False and skip the lm_head
    # projection — rank 0 alone pays sampling
    sample_output = True
    # observation tap: called with the entry list after every successful
    # step
    on_step: Optional[Callable[[list["StepEntry"]], None]] = None
    # called with the entry list once the step's buffers are built, before
    # the device call: a serving-gang leader ships the entries to its
    # followers here, since the step's all-reduces wait for them
    before_step: Optional[Callable[[list["StepEntry"]], None]] = None
    # a tensor-parallel rank's group (serving/shard.py); None: one rank
    tp_group: Any = None

    def __init__(
        self,
        cfg: Any = None,
        *,
        num_pages: int = 128,
        page_size: int = 16,
        max_context: int = 0,
        max_seqs: int = 0,
        max_batch_tokens: int = 0,
        seed: int = 0,
        params_provider: Optional[Callable[[], Any]] = None,
        metrics: Any = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or llama.LlamaConfig.tiny()
        self.page_size = max(1, page_size)
        self.num_pages = max(2, num_pages)
        # static page-table width: the worst-case per-sequence footprint
        self.max_context = min(
            max_context or self.cfg.max_seq_len, self.cfg.max_seq_len
        )
        self.pages_per_seq = -(-self.max_context // self.page_size)
        # static ragged-step shapes: S sequence rows (+1 padding row) over a
        # T-slot flat token buffer.  T - S is the headroom prefill chunks
        # ride in when the decode set is full (the chunked-prefill budget).
        self.max_seqs = max(1, max_seqs or DEFAULT_MAX_SEQS)
        self.max_batch_tokens = max(
            self.max_seqs, max_batch_tokens or 2 * self.max_seqs
        )
        self._seed = seed
        self._params_provider = params_provider
        self._params: Any = None
        self._k_pages: Any = None
        self._v_pages: Any = None
        self._compiled_shapes: set = set()  # observability: step-shape count
        self._metrics = metrics
        self.last_step_compiled = False  # was the latest step a new shape?
        # host seconds spent building each step's paged-attention plan (card only)
        self.plan_seconds: deque = deque(maxlen=4096)
        # page-arena lock: steps update the K/V arenas in place from
        # executor threads, and exports must not read a half-written step
        self._dev_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _ensure(self) -> None:
        if self._params is not None:
            return
        self._params, self._k_pages, self._v_pages = self._init_state()

    def _init_state(self) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """The weights (injected, or drawn from the seed) and the empty
        page arenas.  A tensor-parallel rank overrides it to hold its
        slices only."""
        if self._params_provider is not None:
            params = self._params_provider()
        else:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            params = llama.init_params(self.cfg, generator=gen, device=self.device)
        k_pages, v_pages = llama.init_kv_pages(
            self.cfg, self.num_pages, self.page_size, device=self.device
        )
        return params, k_pages, v_pages

    def compiled_programs(self) -> int:
        return len(self._compiled_shapes)

    def _clamp(self, row: list[int]) -> list[int]:
        vmax = self.cfg.vocab_size - 1
        return [min(max(0, int(t)), vmax) for t in row]

    # ------------------------------------------------------------------
    def step(self, entries: list[StepEntry]) -> list[Any]:
        """One ragged mixed prefill+decode device call.

        Returns one value per entry, aligned: the next token (``int``) for
        sampled entries, ``None`` for prefill chunks that do not complete
        their prompt, and the per-position prediction list (``list[int]``,
        one next-token argmax per fed position) for draft verification
        rows (``entry.draft > 0``).  Blocking; call from an executor
        thread."""
        self._ensure()
        if not entries:
            return []
        t_buf, s_rows = self.max_batch_tokens, self.max_seqs
        if len(entries) > s_rows:
            raise ValueError(
                f"{len(entries)} sequences in one step; backend max_seqs is "
                f"{s_rows}"
            )
        total = sum(len(e.tokens) for e in entries)
        if total > t_buf:
            raise ValueError(
                f"{total} tokens in one step; backend max_batch_tokens is "
                f"{t_buf}"
            )
        tokens = np.zeros((t_buf,), np.int32)
        positions = np.zeros((t_buf,), np.int32)
        # padding tokens map to the padding row (all null pages): their
        # writes land on page 0 and no live sequence's attention sees them
        token_seq = np.full((t_buf,), s_rows, np.int32)
        tables = np.zeros((s_rows + 1, self.pages_per_seq), np.int32)
        out_idx = np.zeros((s_rows,), np.int32)
        ti = 0
        spans: list[tuple[int, int]] = []  # entry i's [lo, hi) buffer slots
        for i, e in enumerate(entries):
            row = self._clamp(e.tokens)
            n = len(row)
            if not n:
                raise ValueError("empty StepEntry.tokens")
            if e.start + n > self.max_context:
                raise ValueError(
                    f"entry spans positions [{e.start}, {e.start + n}); "
                    f"backend max_context is {self.max_context}"
                )
            tokens[ti:ti + n] = row
            positions[ti:ti + n] = np.arange(e.start, e.start + n)
            token_seq[ti:ti + n] = i
            tables[i, : len(e.pages)] = e.pages
            out_idx[i] = ti + n - 1
            spans.append((ti, ti + n))
            ti += n
        # the kernel indexes the arena with these ids unchecked
        if tables.min() < 0 or tables.max() >= self.num_pages:
            raise ValueError(
                f"page ids outside the arena's {self.num_pages} pages"
            )
        shape_key = ("ragged", t_buf, s_rows, self.pages_per_seq)
        self.last_step_compiled = shape_key not in self._compiled_shapes
        if self.last_step_compiled:
            self._compiled_shapes.add(shape_key)
            if self._metrics is not None:
                self._metrics.serving_compiles.inc(entry="ragged")
        dev = self.device
        plan = None
        if dev.type == "cuda":
            # the kernel's work list, once per step for every layer (the
            # CPU takes the plain version, which needs none)
            t0 = time.perf_counter()
            # the heads this rank attends with (all of them on one rank)
            tp = 1 if self.tp_group is None else self.tp_group.size
            plan = build_plan(
                token_seq, positions, page_size=self.page_size,
                pages_per_seq=self.pages_per_seq, n_heads=self.cfg.n_heads // tp,
                n_kv_heads=self.cfg.n_kv_heads // tp, dtype=self.cfg.dtype, device=dev,
            )
            self.plan_seconds.append(time.perf_counter() - t0)
        if self.before_step is not None:
            self.before_step(entries)
        with self._dev_lock:
            nxt, self._k_pages, self._v_pages = llama.ragged_step(
                self._params, self._k_pages, self._v_pages,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev),
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(token_seq).to(dev),
                torch.from_numpy(out_idx).to(dev),
                self.cfg, sample_logits=bool(self.sample_output), plan=plan,
                tp_group=self.tp_group,
            )
            out = nxt.cpu().numpy()
        # out is [T] per-position predictions: a sampled entry's token is
        # the prediction after its LAST fed slot; a draft row gets the
        # whole span — one verification vote per fed position
        res: list[Any] = []
        for e, (lo, hi) in zip(entries, spans):
            if e.draft > 0:
                res.append([int(t) for t in out[lo:hi]])
            elif e.sample:
                res.append(int(out[hi - 1]))
            else:
                res.append(None)
        if self.on_step is not None:
            self.on_step(entries)
        return res

    # ------------------------------------------------------------------
    # live KV-page migration (docs/PROTOCOL.md §Page transfer): pages leave
    # and enter the arena at their TRUE lengths — only the filled slots of
    # each page ride the wire, float32-upcast so the receiver can cast back
    # into its own arena dtype exactly.  The records are byte-compatible
    # with the JAX backend's, so sessions move between the two packages.
    def export_kv(
        self, pages: list[int], start_tok: int, end_tok: int
    ) -> list[dict]:
        """Records for the session pages covering positions
        ``[start_tok, end_tok)``.  ``pages`` is the session's full page
        list; record ``i`` is the page ORDINAL within it (the receiver maps
        ordinals onto its own freshly allocated arena blocks).  Blocking
        (device reads); call from an executor thread."""
        if end_tok <= start_tok:
            return []
        self._ensure()
        ps = self.page_size
        first, last = start_tok // ps, -(-end_tok // ps)
        ords = list(range(first, min(last, len(pages))))
        used = [min(ps, end_tok - o * ps) for o in ords]
        with self._dev_lock:
            blocks = llama.gather_kv_pages(
                self._k_pages, self._v_pages, [pages[o] for o in ords], used
            )
        return [
            {"i": o, "used": n, "k": k.tobytes(), "v": v.tobytes(),
             "shape": list(k.shape)}
            for o, n, (k, v) in zip(ords, used, blocks)
        ]

    def import_kv(self, pages: list[int], records: list[dict]) -> None:
        """Scatter migrated page records into freshly allocated arena
        blocks (``pages``, the receiving session's page list).  Blocking;
        call from an executor thread."""
        if not records:
            return
        if any("heads" in rec for rec in records):
            # per-rank records from a serving-gang source (serving/shard.py):
            # each rank exported its head slice of every page; merge them
            # back into full-head records, so a gang export imports here
            from .shard import merge_rank_records

            records = merge_rank_records(records)
        self._scatter_records(pages, records)

    def _scatter_records(self, pages: list[int], records: list[dict]) -> None:
        """Write records whose head axis matches this arena's."""
        self._ensure()
        ids, blocks = [], []
        for rec in records:
            o = int(rec["i"])
            if not 0 <= o < len(pages):
                raise ValueError(f"page ordinal {o} outside {len(pages)} pages")
            shape = tuple(rec["shape"])
            k = np.frombuffer(rec["k"], np.float32).reshape(shape)
            v = np.frombuffer(rec["v"], np.float32).reshape(shape)
            ids.append(pages[o])
            blocks.append((k, v))
        with self._dev_lock:
            self._k_pages, self._v_pages = llama.scatter_kv_pages(
                self._k_pages, self._v_pages, ids, blocks
            )

    def copy_page(self, src: int, dst: int) -> None:
        """Duplicate physical page ``src`` into ``dst`` on device — the
        copy-on-write half of prefix sharing (docs/SERVING.md §Prefix
        cache and tiering).  The engine calls this before any position
        inside a shared page would be written: the writer gets its own
        copy, every other table keeps attending to the original.
        Blocking; call from an executor thread."""
        self._ensure()
        with self._dev_lock:
            self._k_pages, self._v_pages = llama.copy_kv_page(
                self._k_pages, self._v_pages, src, dst
            )

    # ------------------------------------------------------------------
    # compat conveniences over step() — tests and benches drive these; the
    # engine always assembles mixed steps itself.
    def prefill(self, prompt: list[int], pages: list[int]) -> int:
        """Run a whole prompt through ragged prefill chunks (token-budget
        sized) and return the first generated token.  Blocking."""
        row = list(prompt)[: self.max_context]
        total = max(1, len(row)) or 1
        first: Optional[int] = None
        start = 0
        while start < total or first is None:
            chunk = row[start:start + self.max_batch_tokens] or [0]
            done = start + len(chunk) >= total
            (first,) = self.step([StepEntry(
                tokens=chunk, start=start, pages=pages, sample=done,
                phase="prefill",
            )])
            start += len(chunk)
            if done:
                break
        assert first is not None
        return first

    def decode(self, entries: list[tuple[int, int, list[int]]]) -> list[int]:
        """One decode step for a ragged batch of ``(last_token, position,
        pages)`` triples — one next token per entry.  Batches wider than
        the static shapes split across step() calls.  Blocking."""
        out: list[int] = []
        width = min(self.max_seqs, self.max_batch_tokens)
        for lo in range(0, len(entries), width):
            chunk = entries[lo:lo + width]
            res = self.step([StepEntry(
                tokens=[tok], start=pos, pages=pages, sample=True,
                phase="decode",
            ) for tok, pos, pages in chunk])
            out.extend(int(t) for t in res if t is not None)
        return out
