"""Ragged paged GQA attention: the attention core of the serving step.

Three functions of the same computation live here:

  * :func:`gqa_attention` — dense causal GQA attention with the JAX
    package's numerics (``cordum_tpu/models/llama.py`` ``_attention``):
    scores in the input dtype, then fp32 with a ``-1e30`` mask and an fp32
    softmax, probabilities cast back to the dtype before the PV product;
  * :func:`paged_attention_reference` — the plain PyTorch version of the
    paged step: gather each token's whole page-table row out of the arena
    and attend under ``k_pos <= position`` (``ragged_step``'s
    ``k_pages[li][pt_tok]`` + ``_attention(q_offset=pos2)``);
  * :func:`paged_attention` — the wrapper the serving step calls.  For CPU
    tensors it is the plain version; for CUDA tensors it launches the
    hand-written Hopper kernel in ``csrc/paged_attention.cu`` or raises.
    There is no fallback from the kernel to the plain version.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use and bound with ``ctypes``.  It is bounded by
device-memory bytes: the K/V pages each sequence needs, counted once, over
3.35 TB/s.  Its design is the simple one (a token's pages cut across up to
16 blocks per KV head, streamed through shared memory with ``cp.async``,
fp32 online softmax, a second pass merging the blocks' partials); see the
source's head comment.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "paged_attention.cu"
#: head widths the kernel is built and checked for on the card: Llama-3-8B's
#: 128 and the small test configurations' 16
KERNEL_HEAD_DIMS = (16, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STAGES = 4  # pages in flight per block (kStages in the source)
_MAX_SPLITS = 16  # blocks a token's pages are cut across, per KV head
_SMEM_LIMIT = 227 * 1024  # a block's shared memory on Hopper, with opt-in
_MAX_GROUP = 32  # one warp per query head: at most 1024 threads a block


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def gqa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense GQA attention; q ``[B, Tq, H, Dh]``, k/v ``[B, Tk, KVH, Dh]``.
    ``q_offset`` (``[Tq, 1]`` or ``[B, Tq]``) gives each query's global
    position; without it query ``i`` sits at position ``i``."""
    _, tq, h, hd = q.shape
    tk = k.shape[1]
    rep = h // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    if causal:
        dev = q.device
        q_pos = (
            torch.arange(tq, device=dev)[:, None] if q_offset is None
            else q_offset[:, :, None]
        )
        k_pos = torch.arange(tk, device=dev)[None, :]
        mask = q_pos >= k_pos  # [Tq, Tk] or [B, Tq, Tk]
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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
# the kernel
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_attention_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


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
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(
            f"paged_attention kernel: {h} query heads over {kvh} KV heads"
        )
    if _STAGES * 2 * ps * hd * q.element_size() > _SMEM_LIMIT:
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


def paged_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_tables: torch.Tensor, token_seq: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """``out[t] = attention(q[t], the pages of row token_seq[t] up to
    positions[t])`` for ``q [T, h, hd]`` over one layer's arena
    ``[num_pages, ps, kvh, hd]``.  The arena must already hold this step's
    K/V.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``paged_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_tables, token_seq, positions
        )
    check_kernel_args(q, k_pages, v_pages, page_tables, token_seq, positions)
    fn = _build.load(SOURCE, _bind).paged_attention_launch
    t, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    pages_per_seq = page_tables.shape[1]
    n_splits = min(_MAX_SPLITS, pages_per_seq)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        # per-split partials (acc, max, sum) the combine pass merges
        scratch = torch.empty((t, h, n_splits, hd + 2), dtype=torch.float32,
                              device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_tables.data_ptr(), token_seq.data_ptr(),
            positions.data_ptr(), out.data_ptr(), scratch.data_ptr(), t, h,
            kvh, hd, ps, pages_per_seq, n_splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0  # type: ignore[attr-defined]
