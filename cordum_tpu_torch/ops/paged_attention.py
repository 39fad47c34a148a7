"""Ragged paged GQA attention: the attention core of the serving step.

The functions of one computation live here:

  * :func:`paged_attention_reference` — the plain PyTorch version of the
    paged step: gather each token's whole page-table row out of the arena
    and attend under ``k_pos <= position`` (``ragged_step``'s
    ``k_pages[li][pt_tok]`` + ``_attention(q_offset=pos2)``) through
    :func:`.dense_attention.gqa_attention`, the dense plain version;
  * :func:`build_plan` — the kernel's work list for one step, built once
    per step on the host with numpy: tokens grouped by sequence (at most
    16 a group, at most 64 query rows), each group's pages cut into runs
    sized from the whole step's page count;
  * :func:`paged_attention_planned` — a plain emulation of the kernel's
    split and merge over a plan (per item: partial accumulator, max and
    sum; then the merge of a group's partials), used by the CPU tests to
    prove the partition and the merge arithmetic;
  * :func:`paged_attention` — the wrapper the serving step calls.  For CPU
    tensors it is the plain version; for CUDA tensors it launches the
    hand-written Hopper kernel in ``csrc/paged_attention.cu`` or raises.
    There is no fallback from the kernel to the plain version.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use and bound with ``ctypes``.  It is bounded by
device-memory bytes: the K/V pages each sequence needs, counted once, over
3.35 TB/s.  One block per (plan item, KV head) reads each page once for
all the tokens of its group; see the source's head comment.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import _build
from .dense_attention import gqa_attention

SOURCE = _build.CSRC / "paged_attention.cu"
#: head widths the kernel is built and checked for on the card: Llama-3-8B's
#: 128 and the small test configurations' 16
KERNEL_HEAD_DIMS = (16, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STAGES = 4  # pages in flight per block (kStages in the source)
_SMEM_LIMIT = 227 * 1024  # a block's shared memory on Hopper, with opt-in
#: query rows (tokens x GQA group) a block holds: four warps of 16 rows
MAX_GROUP_ROWS = 64
#: runs one group may be cut into: the merge pass's weights per row in
#: shared memory (kMaxRuns in the source); :func:`plan_capacity` caps the
#: plan's runs at this, whatever the page-table width
MAX_MERGE_RUNS = 1024
#: tokens of one sequence a plan group holds at most
MAX_GROUP_TOKENS = 16
#: blocks a step's plan aims at per SM: two, so that the runs (runs x KV
#: heads, plus one run more per group) fit in one wave of resident blocks
#: (3 an SM in bf16, 2 in fp32) with few, long runs
BLOCKS_PER_SM = 2
#: the SM count a plan assumes when it is built for no card (the H100's)
DEFAULT_SMS = 132
_ITEM_COLS = 4  # group, first page, end page, partial slot (-1: none)
_GROUP_COLS = 2 + MAX_GROUP_TOKENS  # sequence row, n tokens, token ids
_SPLIT_COLS = 3  # group, first item, n items

# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def paged_attention_reference(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_tables: torch.Tensor, token_seq: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """The plain version: ``q [T, h, hd]`` against one layer's arena
    ``[num_pages, ps, kvh, hd]``; returns ``[T, h, hd]``.  Materialises
    every token's whole page-table row, ``[T, P*ps, kvh, hd]``."""
    t = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    pt_tok = page_tables[token_seq.long()].long()  # [T, P]
    kc = k_pages[pt_tok].reshape(t, -1, kvh, hd)
    vc = v_pages[pt_tok].reshape(t, -1, kvh, hd)
    out = gqa_attention(q[:, None], kc, vc, q_offset=positions[:, None])
    return out[:, 0]


# ---------------------------------------------------------------------------
# the plan, and a plain emulation of the kernel's split and merge
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionPlan:
    """The kernel's work list for one step (see :func:`build_plan`).

    * ``items [cap_items, 4]``: group, first page, end page (exclusive) and
      partial slot — -1 when the item covers its group's whole row and
      writes the output itself; unused rows have group -1.  The kernel
      runs one block per (item, KV head).
    * ``groups [cap_groups, 2 + MAX_GROUP_TOKENS]``: page-table row, token
      count and the tokens' buffer indices (-1 past the count).
    * ``splits [cap_groups, 3]``: each group cut into more than one run —
      group, first item, item count; unused rows have group -1.

    The tensors' shapes follow only the step's shape (buffer size, KV
    heads), never its contents.  ``n_items``, ``n_splits`` and ``span``
    are the host's counts: the wrapper launches the merge only when a
    group was split."""

    items: torch.Tensor
    groups: torch.Tensor
    splits: torch.Tensor
    n_items: int
    n_splits: int
    span: int
    tokens_per_group: int


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: Optional[torch.device]) -> int:
    if device is None or device.type != "cuda":
        return DEFAULT_SMS
    return _card_sms(torch.cuda.current_device() if device.index is None else device.index)


def plan_capacity(n_tokens: int, n_kv_heads: int, device=None) -> tuple[int, int]:
    """``(cap_items, cap_groups)`` of a plan for an ``n_tokens`` buffer on
    ``device``: at most one group per token, and at most
    ``BLOCKS_PER_SM x SMs / n_kv_heads`` runs of the step's pages (capped
    at ``MAX_MERGE_RUNS``) plus one more per group."""
    dev = None if device is None else torch.device(device)
    runs = -(-BLOCKS_PER_SM * _sm_count(dev) // n_kv_heads)
    return min(runs, MAX_MERGE_RUNS) + n_tokens, n_tokens


def build_plan(
    token_seq, positions, *, page_size: int, pages_per_seq: int,
    n_heads: int, n_kv_heads: int, dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> AttentionPlan:
    """The work list of one step, from its ``[T]`` page-table rows and
    positions (numpy or CPU tensors), with vectorised numpy.

    Tokens are grouped by sequence — sorted by (row, position), so the
    buffer need not hold a sequence's tokens side by side — at most
    ``min(16, 64 // group)`` a group (at most 64 query rows); padding
    tokens on the null row group like any sequence.  A group needs pages
    ``0 .. max position // page_size``.  A page costs ``w`` units: 1 in
    bf16, and ``ceil(rows / 4)`` for the ``dtype`` float32 kernel, whose
    time per page grows with the rows a warp takes.  The run cost ``span``
    comes from the whole step's cost over the runs of
    :func:`plan_capacity` (two blocks per SM of ``device``); a group of
    ``n`` pages gets ``min(n, ceil(n * w / span))`` runs of near-equal
    length (they differ by at most one page), so with ``w = 1`` every item
    holds at most ``span`` pages and every item of a split group at least
    ``span // 2``.  The tensors go to a CUDA ``device`` in one copy that
    does not wait for the card."""
    seq = np.asarray(token_seq, np.int64).reshape(-1)
    pos = np.asarray(positions, np.int64).reshape(-1)
    t = seq.shape[0]
    if t < 1 or pos.shape != seq.shape:
        raise ValueError(f"plan: token_seq {seq.shape} and positions {pos.shape}")
    if n_heads % n_kv_heads or n_heads // n_kv_heads > MAX_GROUP_ROWS:
        raise ValueError(f"plan: {n_heads} query heads over {n_kv_heads} KV heads")
    tpg = min(MAX_GROUP_TOKENS, MAX_GROUP_ROWS // (n_heads // n_kv_heads))
    cap_items, cap_groups = plan_capacity(t, n_kv_heads, device)
    target_runs = cap_items - t

    order = np.lexsort((pos, seq))
    seq_s, pos_s = seq[order], pos[order]
    idx = np.arange(t)
    new_seq = np.ones(t, bool)
    new_seq[1:] = seq_s[1:] != seq_s[:-1]
    rank = idx - np.maximum.accumulate(np.where(new_seq, idx, 0))
    new_group = new_seq | (rank % tpg == 0)
    g_of = np.cumsum(new_group) - 1
    starts = np.flatnonzero(new_group)
    n_groups = starts.shape[0]
    groups = np.full((cap_groups, _GROUP_COLS), -1, np.int32)
    groups[:, :2] = 0
    groups[:n_groups, 0] = seq_s[starts]
    groups[:n_groups, 1] = np.bincount(g_of, minlength=n_groups)
    groups[g_of, 2 + rank % tpg] = order

    n_pages = np.minimum(np.maximum.reduceat(pos_s, starts) // page_size + 1,
                         pages_per_seq)
    group = n_heads // n_kv_heads
    weight = (-(-groups[:n_groups, 1] * group // 4) if dtype == torch.float32
              else np.ones(n_groups, np.int64))
    cost = n_pages * weight
    span = max(1, -(-int(cost.sum()) // target_runs))
    runs = np.minimum(n_pages, -(-cost // span))
    n_items = int(runs.sum())
    first_item = np.cumsum(runs) - runs
    run = np.arange(n_items) - np.repeat(first_item, runs)
    of_runs, of_pages = np.repeat(runs, runs), np.repeat(n_pages, runs)
    items = np.full((cap_items, _ITEM_COLS), -1, np.int32)
    items[:n_items, 0] = np.repeat(np.arange(n_groups), runs)
    items[:n_items, 1] = run * of_pages // of_runs
    items[:n_items, 2] = (run + 1) * of_pages // of_runs
    items[:n_items, 3] = np.where(of_runs > 1, np.arange(n_items), -1)
    split = np.flatnonzero(runs > 1)
    splits = np.full((cap_groups, _SPLIT_COLS), -1, np.int32)
    splits[:split.shape[0]] = np.stack([split, first_item[split], runs[split]], 1)

    parts = (items, groups, splits)
    flat = torch.from_numpy(np.concatenate([x.ravel() for x in parts]))
    if device is not None and torch.device(device).type == "cuda":
        # from pageable memory the copy returns once CUDA has staged the
        # bytes, without waiting for the stream's earlier work
        flat = flat.to(device, non_blocking=True)
    ends = np.cumsum([x.size for x in parts])
    return AttentionPlan(
        items=flat[:ends[0]].view(cap_items, _ITEM_COLS),
        groups=flat[ends[0]:ends[1]].view(cap_groups, _GROUP_COLS),
        splits=flat[ends[1]:].view(cap_groups, _SPLIT_COLS),
        n_items=n_items, n_splits=int(split.shape[0]), span=span,
        tokens_per_group=tpg,
    )


def paged_attention_planned(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_tables: torch.Tensor, positions: torch.Tensor, plan: AttentionPlan,
) -> torch.Tensor:
    """A plain emulation of the kernel's partition, for the tests: per plan
    item and KV head, the fp32 partial (accumulator, running max, sum of
    ``exp(score - max)``) over the item's pages under ``k_pos <= pos``; an
    item that covers its group's whole row writes ``acc / sum``, the
    partials of a split group are merged as the kernel's merge pass does.
    Returns ``[T, h, hd]`` in ``q``'s dtype."""
    t, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    g = h // kvh
    items, groups, splits = (x.cpu().numpy() for x in (plan.items, plan.groups, plan.splits))
    pos = positions.cpu().long()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    partial: dict[int, tuple] = {}
    for it in range(plan.n_items):
        grp, first, end, slot = (int(x) for x in items[it])
        row, n_tok = int(groups[grp, 0]), int(groups[grp, 1])
        toks = torch.from_numpy(groups[grp, 2:2 + n_tok].astype(np.int64))
        pages = page_tables[row, first:end].long()
        k = k_pages[pages].reshape(-1, kvh, hd).float()
        v = v_pages[pages].reshape(-1, kvh, hd).float()
        qg = q[toks].float().reshape(n_tok, kvh, g, hd)
        s = torch.einsum("tkgd,nkd->tkgn", qg, k) / math.sqrt(hd)
        k_pos = torch.arange(first * ps, end * ps)
        valid = k_pos[None, :] <= pos[toks][:, None]
        s = s.masked_fill(~valid[:, None, None, :], -math.inf)
        m = s.amax(-1)
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        acc = torch.einsum("tkgn,nkd->tkgd", p, v)
        if slot < 0:
            out[toks] = (acc / p.sum(-1)[..., None]).reshape(n_tok, h, hd).to(q.dtype)
        else:
            partial[it] = (toks, acc, m, p.sum(-1))
    for grp, first, n in splits[:plan.n_splits]:
        parts = [partial[i] for i in range(first, first + n)]
        toks = parts[0][0]
        m_all = torch.stack([pm for _, _, pm, _ in parts])
        w = torch.exp(m_all - m_all.amax(0))  # 0 for a run with no key of a row
        acc = sum(wi[..., None] * pa for wi, (_, pa, _, _) in zip(w, parts))
        den = sum(wi * pl for wi, (_, _, _, pl) in zip(w, parts))
        out[toks] = (acc / den[..., None]).reshape(len(toks), h, hd).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_attention_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


def smem_bytes(dtype: torch.dtype, page_size: int, head_dim: int) -> int:
    """A block's dynamic shared memory, as the source lays it out
    (``smem_bytes`` there): the
    group's query rows and ``_STAGES`` pages of K and V, each rounded up to
    16 keys; bf16 rows padded by 8 elements (``ldmatrix`` free of bank
    conflicts), fp32 K and Q rows by 4 floats."""
    keys = -(-page_size // 16) * 16
    if dtype == torch.bfloat16:
        row = (head_dim + 8) * 2
        return MAX_GROUP_ROWS * row + _STAGES * 2 * keys * row
    return (MAX_GROUP_ROWS * (head_dim + 4) + _STAGES * keys * (2 * head_dim + 4)) * 4


def check_kernel_args(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_tables: torch.Tensor, token_seq: torch.Tensor,
    positions: torch.Tensor,
) -> None:
    """Raise ``ValueError`` on any operand the kernel does not take: a
    dtype other than fp32/bf16 (int32 metadata), a shape or layout it does
    not index correctly, a head width it was not built and checked for, or
    a device other than one CUDA card (checked last)."""
    tensors = (q, k_pages, v_pages, page_tables, token_seq, positions)
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_attention kernel: q/k/v must share float32 or bfloat16, "
            f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    if any(x.dtype != torch.int32 for x in (page_tables, token_seq, positions)):
        raise ValueError("paged_attention kernel: metadata must be int32")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention kernel: operands must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_attention kernel: q [T,h,hd] and k/v [N,ps,kvh,hd], got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    t, h, hd = q.shape
    _, ps, kvh, khd = k_pages.shape
    if khd != hd or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel: head_dim {hd} (k/v {khd}); built for "
            f"{KERNEL_HEAD_DIMS}"
        )
    if h % kvh or h // kvh > MAX_GROUP_ROWS:
        raise ValueError(
            f"paged_attention kernel: {h} query heads over {kvh} KV heads"
        )
    if smem_bytes(q.dtype, ps, hd) > _SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel: page_size {ps} too large")
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_attention kernel: q/k/v must be 16-byte aligned")
    if t < 1 or page_tables.dim() != 2 or tuple(token_seq.shape) != (t,) \
            or tuple(positions.shape) != (t,):
        raise ValueError("paged_attention kernel: metadata shapes disagree")
    if any(x.device.type != "cuda" for x in tensors) or len(
        {x.device for x in tensors}
    ) != 1:
        raise ValueError("paged_attention kernel: all operands on one CUDA device")


def check_plan(plan: AttentionPlan, q: torch.Tensor, n_kv_heads: int) -> None:
    """Raise ``ValueError`` on a plan that was not built for this call's
    buffer size and heads, or that does not lie on ``q``'s card."""
    t, h, _ = q.shape
    cap_items, cap_groups = plan_capacity(t, n_kv_heads, q.device)
    want = min(MAX_GROUP_TOKENS, MAX_GROUP_ROWS // (h // n_kv_heads))
    if tuple(plan.items.shape) != (cap_items, _ITEM_COLS) \
            or tuple(plan.groups.shape) != (cap_groups, _GROUP_COLS) \
            or tuple(plan.splits.shape) != (cap_groups, _SPLIT_COLS) \
            or plan.tokens_per_group != want:
        raise ValueError(
            f"paged_attention kernel: the plan was built for another step shape "
            f"(items {tuple(plan.items.shape)}, {plan.tokens_per_group} tokens a group)"
        )
    if any(x.device != q.device or x.dtype != torch.int32
           for x in (plan.items, plan.groups, plan.splits)):
        raise ValueError("paged_attention kernel: the plan must be int32 on q's card")


def paged_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_tables: torch.Tensor, token_seq: torch.Tensor,
    positions: torch.Tensor, *, plan: Optional[AttentionPlan] = None,
) -> torch.Tensor:
    """``out[t] = attention(q[t], the pages of row token_seq[t] up to
    positions[t])`` for ``q [T, h, hd]`` over one layer's arena
    ``[num_pages, ps, kvh, hd]``.  The arena must already hold this step's
    K/V.  CPU tensors take the plain version (``plan`` is not used);
    CUDA tensors launch the kernel (counted in ``paged_attention.launches``)
    or raise.  ``plan`` is the step's :func:`build_plan`, built once per
    step by the caller; without it the wrapper builds one here, reading
    ``token_seq`` and ``positions`` back to the host."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_tables, token_seq, positions
        )
    check_kernel_args(q, k_pages, v_pages, page_tables, token_seq, positions)
    t, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    pages_per_seq = page_tables.shape[1]
    if plan is None:
        plan = build_plan(
            token_seq.cpu().numpy(), positions.cpu().numpy(), page_size=ps,
            pages_per_seq=pages_per_seq, n_heads=h, n_kv_heads=kvh,
            dtype=q.dtype, device=q.device,
        )
    check_plan(plan, q, kvh)
    fn = _build.load(SOURCE, _bind).paged_attention_launch
    cap_items = plan.items.shape[0]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        # partials (acc, max, sum) of the split groups' items, which the
        # merge pass combines; nothing when no group was split
        scratch = torch.empty(
            (cap_items, kvh, MAX_GROUP_ROWS, hd + 2) if plan.n_splits else (1,),
            dtype=torch.float32, device=q.device,
        )
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
            plan.items.data_ptr(), plan.groups.data_ptr(), plan.splits.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), cap_items, plan.n_splits,
            h, kvh, hd, ps,
            pages_per_seq, plan.tokens_per_group, stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0  # type: ignore[attr-defined]
