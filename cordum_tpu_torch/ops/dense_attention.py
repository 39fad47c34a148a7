"""Dense causal GQA self-attention and its gradient: the attention core of
the Llama ``forward`` that ``loss_fn`` differentiates and the ``infer`` op
runs, and of a sequence-parallel rank's forward, whose queries are its
chunk of the sequence at their global positions and whose keys and values
are the whole gathered sequence (``Tq`` query rows against ``Tk`` keys).

The functions of one computation live here:

  * :func:`gqa_attention` — the plain PyTorch version, with the JAX
    package's numerics (``cordum_tpu/models/llama.py`` ``_attention``):
    scores in the input dtype, then fp32 divided by ``sqrt(hd)`` with a
    ``-1e30`` causal mask and an fp32 softmax, probabilities cast back to
    the dtype before the PV product.  Autograd of it is the plain version of
    the gradient; the paged serving step's plain version calls it too;
  * :func:`dense_attention_fwd` and :func:`dense_attention_bwd` — the
    wrappers of the hand-written Hopper kernels in
    ``csrc/dense_attention.cu``: the forward returns the output and the
    per-row ``lse`` (fp32 ``[B, H, Tq]``); the backward recomputes the
    probabilities from ``lse`` (first the softmax gradient's ``D``: in bf16
    ``sum_k P dP`` from the fp32 weights, by a pass of the dQ kernel without
    its product; in fp32 ``rowsum(dO * out)``; then a dK/dV kernel that sums
    a KV head's query heads in registers, and a dQ kernel; deterministic).  bf16 at head_dim 64 and 128 runs on ``wgmma``
    with TMA (warp-specialised blocks; forward and dQ rows pack the query
    heads of a KV head), bf16 at head_dim 16 on ``mma.sync``, fp32 on CUDA
    cores with register tiles;
  * :func:`dense_attention_d` and ``dense_attention_bwd(..., d=)`` — the
    backward's two halves apart, for a ring chunk
    (:mod:`.ring_attention`), whose keys are one chunk of the row's:
    "D only" (bf16: the D pass over the chunk's keys under the row's
    ``lse``, a partial the ring sums; fp32: the pre-pass from the merged
    output) and "D given" (dK/dV and dQ with the caller's ``D``);
  * :func:`dense_attention_fwd_reference`, :func:`dense_attention_d_reference`
    and :func:`dense_attention_bwd_reference` — the plain versions of the
    three wrappers (``(out, lse)``; ``D``; ``(dq, dk, dv)`` by the kernels'
    formula, given ``D`` or not), which the ring's steps take on the CPU;
  * :class:`DenseAttention` — the ``torch.autograd.Function`` joining them:
    it saves q, k, v, the positions, the output and ``lse``, never the
    probabilities;
  * :func:`dense_attention` — the entry the model calls.  For CPU tensors
    it is the plain version (and autograd of it); for CUDA tensors it runs
    the kernels through :class:`DenseAttention` or raises.  There is no
    fallback from the kernels to the plain version.

The kernels are built by :mod:`._build` at first use (the TMA maps are
encoded at every call).  At the training shapes they are bound by the
operations (the tensor cores in bf16, the CUDA cores in fp32); key tiles
wholly above the causal diagonal are skipped.  See the source's head
comment; ``tests/test_torch_dense_schedule.py`` emulates the bf16 schedule.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "dense_attention.cu"
#: head widths the kernels are built for: ``LlamaConfig.tiny()``'s 16,
#: ``LlamaConfig()``'s 64 and Llama-3-8B's 128
KERNEL_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535  # batch rows and heads are grid dimensions


def gqa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense GQA attention; q ``[B, Tq, H, Dh]``, k/v ``[B, Tk, KVH, Dh]``.
    ``q_offset`` (``[Tq, 1]`` or ``[B, Tq]``) gives each query's global
    position; without it query ``i`` sits at position ``i``."""
    scores, _ = _masked_scores(q, k, causal, q_offset)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, _expand(v, q.shape[2]))


def _expand(kv: torch.Tensor, h: int) -> torch.Tensor:
    """K or V ``[B, Tk, KVH, hd]`` repeated to the ``h`` query heads."""
    return torch.repeat_interleave(kv, h // kv.shape[2], dim=2)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: Optional[torch.Tensor]) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`gqa_attention`'s fp32 scores ``[B, H, Tq, Tk]`` (the product
    in the input dtype, then divided by ``sqrt(hd)``), masked keys at
    ``-1e30``; and the mask (``True`` where a key is live, broadcastable to
    the scores), ``None`` when not causal."""
    tq, hd = q.shape[1], q.shape[3]
    tk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, _expand(k, q.shape[2])).float() / math.sqrt(hd)
    if not causal:
        return scores, None
    dev = q.device
    q_pos = (
        torch.arange(tq, device=dev)[:, None] if q_offset is None
        else q_offset[:, :, None]
    )
    k_pos = torch.arange(tk, device=dev)[None, :]
    mask = q_pos >= k_pos  # [Tq, Tk] or [B, Tq, Tk]
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    return scores.masked_fill(~mask, -1e30), mask


def dense_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """The plain version of :func:`dense_attention`: causal attention of
    ``q [B, Tq, H, hd]`` over ``k, v [B, Tk, KVH, hd]`` under ``k_index <=
    positions[b, q]``."""
    return gqa_attention(q, k, v, q_offset=positions)


def _kernel_scores(q: torch.Tensor, k: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scores as the kernels take them: :func:`_masked_scores` under
    ``k_index <= positions``, except that a row with no live key (a negative
    position) counts every score as 0, which gives the reference's uniform
    weights and an ``lse`` of ``log(Tk)``.  Returns the scores, the live
    mask and the rows' ``[B, 1, Tq, 1]`` no-live-key flags."""
    scores, mask = _masked_scores(q, k, True, positions)
    dead = (positions < 0)[:, None, :, None]
    return scores.masked_fill(dead, 0.0), mask & ~dead, dead


def dense_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`dense_attention_fwd`: the output of
    :func:`dense_attention_reference` and the rows' ``lse`` (fp32 ``[B,
    H, Tq]``; ``log(Tk)`` on a row with no live key, as the kernels')."""
    scores, _, _ = _kernel_scores(q, k, positions)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _expand(v, q.shape[2])).contiguous()
    return out, torch.logsumexp(scores, dim=-1)


def _weights(q, k, positions, lse):
    """fp32 ``P = exp(s - lse)`` over :func:`_kernel_scores` (0 on a masked
    key), and the rows' no-live-key flags."""
    scores, live, dead = _kernel_scores(q, k, positions)
    return torch.where(live | dead, torch.exp(scores - lse[..., None]), 0.0), dead


def dense_attention_d_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
) -> torch.Tensor:
    """The plain version of :func:`dense_attention_d`: fp32 ``[B, H,
    Tq]``; bf16 :func:`d_from_weights`, fp32 ``rowsum(dO * out)``."""
    if q.dtype == torch.float32:
        return (dout * out).sum(-1).transpose(1, 2).contiguous()
    return d_from_weights(q, k, v, positions, lse, dout)


def d_from_weights(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor,
) -> torch.Tensor:
    """``sum_k P dP`` over these keys, fp32 ``[B, H, Tq]``, in any dtype:
    ``P = exp(s - lse)`` from the scores as the dtype rounds them (0 on a
    masked key), ``dP = dO V^T`` unrounded.  Over a row's chunks the
    partials sum to the row's ``D``, which is ``rowsum(dO * out)`` in exact
    arithmetic."""
    p, _ = _weights(q, k, positions, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _expand(v, q.shape[2]).float())
    return (p * dp).sum(-1)


def dense_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
    d: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`dense_attention_bwd`, by the kernels'
    formula (``csrc/dense_attention.cu``'s head comment): ``P = exp(s -
    lse)`` in fp32, ``dP = dO V^T``, ``dS = P (dP - D) / sqrt(hd)`` rounded
    to the dtype (0 on a row with no live key), ``dQ = dS K``, ``dK = dS^T
    Q`` and ``dV = P^T dO`` with P rounded to the dtype, each summed in fp32
    (dK and dV over a KV head's query heads too) and rounded once.  ``d``
    is the caller's ``D``, else :func:`dense_attention_d_reference`'s."""
    dt, h, hd = q.dtype, q.shape[2], q.shape[3]
    b, tk, kvh = k.shape[0], k.shape[1], k.shape[2]
    if d is None:
        d = dense_attention_d_reference(q, k, v, positions, out, lse, dout)
    p, dead = _weights(q, k, positions, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _expand(v, h).float())
    ds = (p * (dp - d[..., None]) / math.sqrt(hd)).masked_fill(dead, 0.0).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand(k, h).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dout.float())
    dk, dv = (x.reshape(b, tk, kvh, h // kvh, hd).sum(3) for x in (dk, dv))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _bind(lib: ctypes.CDLL) -> None:
    fwd = lib.dense_attention_fwd
    fwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    bwd = lib.dense_attention_bwd
    bwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    only_d = lib.dense_attention_d
    only_d.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    only_d.restype = ctypes.c_int
    given = lib.dense_attention_bwd_given
    given.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    given.restype = ctypes.c_int


def check_kernel_args(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    *more: torch.Tensor,
) -> None:
    """Raise ``ValueError`` on any operand the kernels do not take: a dtype
    other than fp32/bf16 shared by q, k, v (and ``more``: the output and
    ``dO`` of the backward, of q's shape), q not ``[B, Tq, H, hd]`` beside
    k and v ``[B, Tk, KVH, hd]`` (any ``Tq``, ``Tk`` >= 1: a sequence
    chunk's queries against the gathered keys), positions other than int32
    ``[B, Tq]``, a head width not in :data:`KERNEL_HEAD_DIMS`, query heads
    not a multiple of the KV heads, a non-contiguous or misaligned operand,
    or a device other than one CUDA card (checked last).  A position at or
    past ``Tk`` reaches every key, in the kernels as in the plain
    version."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype \
            or any(x.dtype != q.dtype for x in more):
        raise ValueError(
            f"dense_attention kernel: q/k/v must share float32 or bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or any(x.shape != q.shape for x in more):
        raise ValueError(
            f"dense_attention kernel: q [B,Tq,H,hd], k/v [B,Tk,KVH,hd], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"dense_attention kernel: head_dim {hd}; built for {KERNEL_HEAD_DIMS}")
    if kvh < 1 or h % kvh or not 1 <= b <= _MAX_GRID_YZ or h > _MAX_GRID_YZ or tq < 1 \
            or tk < 1 or b * max(tq, tk) * h >= 2**31:
        raise ValueError(f"dense_attention kernel: B {b}, Tq {tq}, Tk {tk}, H {h}, KVH {kvh}")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (b, tq):
        raise ValueError(
            f"dense_attention kernel: positions must be int32 [B, Tq], got "
            f"{positions.dtype} {tuple(positions.shape)}"
        )
    tensors = (q, k, v, positions, *more)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("dense_attention kernel: every operand must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("dense_attention kernel: operands must be 16-byte aligned")
    if any(x.device.type != "cuda" for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError("dense_attention kernel: all operands on one CUDA device")


def dense_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(out [B, Tq, H, hd], lse [B, H, Tq] fp32)``.
    Counted in ``dense_attention_fwd.launches``, and a launch whose queries
    and keys differ in length (a sequence chunk's) also in
    ``dense_attention_fwd.chunk_launches``."""
    check_kernel_args(q, k, v, positions)
    fn = _build.load(SOURCE, _bind).dense_attention_fwd
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            positions.data_ptr(), out.data_ptr(), lse.data_ptr(), b, tq, tk, h,
            k.shape[2], 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_attention forward kernel launch failed: CUDA error {err}")
    dense_attention_fwd.launches += 1
    dense_attention_fwd.chunk_launches += tq != tk
    return out, lse


dense_attention_fwd.launches = 0  # type: ignore[attr-defined]
dense_attention_fwd.chunk_launches = 0  # type: ignore[attr-defined]


def _check_row_stat(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, tq, h, _ = q.shape
    if t.dtype != torch.float32 or tuple(t.shape) != (b, h, tq) or not t.is_contiguous() \
            or t.device != q.device:
        raise ValueError(f"dense_attention kernel: {name} must be a contiguous fp32 [B, H, Tq]")


def dense_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
    d: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (``D``, dK/dV, dQ, in that order on one
    stream): ``(dq, dk, dv)`` in the inputs' dtype, from what
    :func:`dense_attention_fwd` returned.  One call counts one in
    ``dense_attention_bwd.launches`` (and in ``chunk_launches`` where the
    queries and keys differ in length).

    ``d`` (fp32 ``[B, H, Tq]``): a ring chunk's "D given", dK/dV and dQ
    under the caller's ``lse`` and ``D`` (the row's over the whole ring),
    with no D pass (bf16) or pre-pass (fp32); ``out`` is not read.  Such a
    call counts in ``dense_attention_bwd.given_launches`` alone."""
    check_kernel_args(q, k, v, positions, out, dout)
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    _check_row_stat("lse", lse, q)
    if d is not None:
        _check_row_stat("d", d, q)
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (_DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                positions.data_ptr())
        tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, k.shape[2],
                1.0 / math.sqrt(hd), stream)
        if d is None:
            d_scratch = torch.empty_like(lse)
            err = lib.dense_attention_bwd(*head, out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                          d_scratch.data_ptr(), *tail)
        else:
            err = lib.dense_attention_bwd_given(*head, dout.data_ptr(), lse.data_ptr(),
                                                d.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"dense_attention backward kernel launch failed: CUDA error {err}")
    if d is None:
        dense_attention_bwd.launches += 1
        dense_attention_bwd.chunk_launches += tq != tk
    else:
        dense_attention_bwd.given_launches += 1
    return dq, dk, dv


dense_attention_bwd.launches = 0  # type: ignore[attr-defined]
dense_attention_bwd.chunk_launches = 0  # type: ignore[attr-defined]
dense_attention_bwd.given_launches = 0  # type: ignore[attr-defined]


def dense_attention_d(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
) -> torch.Tensor:
    """A ring chunk's "D only": the backward's softmax-gradient ``D``
    alone, fp32 ``[B, H, Tq]``, under the caller's ``lse`` (the row's over
    the whole ring).  bf16: the D pass over these keys, ``sum_k P dP`` over
    the chunk's live keys, a partial the ring sums over its chunks (``out``
    is not read); fp32: the pre-pass, ``rowsum(dO * out)`` of the whole row
    from the merged output (the keys are not read).  Counted in
    ``dense_attention_d.launches``."""
    check_kernel_args(q, k, v, positions, out, dout)
    b, tq, h, hd = q.shape
    _check_row_stat("lse", lse, q)
    fn = _build.load(SOURCE, _bind).dense_attention_d
    with torch.cuda.device(q.device):
        d = torch.empty_like(lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            positions.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), d.data_ptr(),
            b, tq, k.shape[1], h, k.shape[2], 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_attention D kernel launch failed: CUDA error {err}")
    dense_attention_d.launches += 1
    return d


dense_attention_d.launches = 0  # type: ignore[attr-defined]


class DenseAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves q, k, v, the
    positions, the output and ``lse`` (never the ``[B, H, T, T]``
    probabilities); the backward returns dq, dk, dv in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, positions):  # type: ignore[override]
        out, lse = dense_attention_fwd(q, k, v, positions)
        ctx.save_for_backward(q, k, v, positions, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        q, k, v, positions, out, lse = ctx.saved_tensors
        dq, dk, dv = dense_attention_bwd(q, k, v, positions, out, lse, dout.contiguous())
        return dq, dk, dv, None


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Causal GQA attention, ``q [B, Tq, H, hd]`` over ``k, v [B, Tk,
    KVH, hd]`` with key ``j`` live for query ``i`` when ``j <=
    positions[b, i]`` (``Tq == Tk`` for self-attention, ``Tq < Tk`` for a
    sequence chunk's queries against the gathered keys); returns ``[B, Tq,
    H, hd]``, differentiable in q, k and v.  CPU tensors take the plain version; CUDA tensors the kernels or a
    raise (``positions`` is made a contiguous int32 first: ``forward``
    hands an expanded ``arange``)."""
    if q.device.type == "cpu":
        return dense_attention_reference(q, k, v, positions)
    return DenseAttention.apply(q, k, v, positions.to(torch.int32).contiguous())
