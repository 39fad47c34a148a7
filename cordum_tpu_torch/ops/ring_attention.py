"""Ring attention: sequence-parallel exact attention over a training mesh's
``sp`` line, the port of ``cordum_tpu/ops/ring_attention.py``.

Each sp rank holds its contiguous chunk of the sequence's queries, keys and
values (``TrainMesh.sp_span``).  The K/V chunks travel round the sp ring one
hop a step (:meth:`..parallel.mesh.TrainMesh.shift`: to the next rank, from
the previous), so at step ``s`` rank ``r`` holds the chunk of rank ``owner
= (r - s) mod sp`` and no rank ever holds the whole sequence.  The
functions of one computation live here:

  * :func:`reference_attention` — the exact single-device attention (the
    reference's, fp32 inside);
  * :func:`_ring_attention_local` — the plain version of the ring: the
    reference's fp32 online softmax step for step (running max ``m``, sum
    ``l``, accumulator; K/V repeated to the query heads before the ring),
    masked by chunk ownership (``q_pos = sp_rank · Tq + i``, ``k_pos =
    owner · Tk + j``);
  * :func:`ring_merge` — the hand-written merge kernel (B6,
    ``csrc/ring_attention.cu``) that folds a chunk's ``(out_c, lse_c)``
    into the rank's fp32 accumulator and running ``lse``, and
    :func:`ring_merge_reference`, its plain version;
  * :class:`RingAttention` — the ``torch.autograd.Function`` of the ring,
    whose backward is written out (autograd does not differentiate through
    a send), and :func:`ring_attention`, the entry ``models/llama.py``
    calls.

A ring step is one B9 call on the visiting chunk (``ops/dense_attention``):

  * forward, causal: the rank's own diagonal chunk first; a chunk of an
    earlier rank has every key live, so B9 gets the queries' positions
    relative to the chunk's first key (``q_pos - owner · Tk >= Tk``: a
    position at or past ``Tk`` reaches every key); a chunk of a later rank
    is not launched (B9 makes a row with a negative position uniform over
    its keys, a spurious term), though its K/V travel on.  Non-causal:
    every chunk with positions ``Tk - 1``.  Each chunk's ``(out_c, lse_c)``
    is merged into the fp32 accumulator, cast once at the end; the
    backward keeps ``q``, the rank's own ``k`` and ``v``, the output and
    the global ``lse``;
  * backward, bf16: one ring pass of K/V summing each live chunk's "D
    only" partial (:func:`..dense_attention.dense_attention_d`) into the
    row's ``D = sum_k P dP`` over the whole ring (never ``rowsum(dO * O)``
    from the bf16 output, which misses a short row's own sum); fp32: ``D =
    rowsum(dO * out)`` once (the pre-pass).  Then one ring pass of K/V with
    fp32 dK/dV accumulators travelling beside them: "D given" on each live
    chunk (``dense_attention_bwd(..., d=D)``), dq summed here in fp32, the
    chunk's dk/dv into the accumulators, which reach their owner one hop
    after the last chunk.

GQA: the chunks travel with their ``KVH`` heads (B9 takes GQA; the
reference repeats them to ``H`` first: the same result with ``H / KVH``
times the bytes a hop), and a tensor-parallel rank rings its own head
slice.  For CPU tensors the steps are the plain versions
(:data:`PLAIN_STEPS`), for CUDA tensors the kernels (:data:`KERNEL_STEPS`)
or a raise.

Launches a layer, at sp rank ``r`` of ``n``, causal: ``r + 1`` forward
chunks and merges, ``r + 1`` "D given" and, in bf16, ``r + 1`` "D only"
(fp32: one); non-causal ``n`` of each.  Hops (``calls["p2p"]``): ``n - 1``
forward, ``n`` backward (the accumulators' return) and in bf16 ``n - 1``
more (the D pass).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from . import _build
from . import dense_attention as da

SOURCE = _build.CSRC / "ring_attention.cu"
_NEG = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Single-device exact attention, the reference's: fp32 scores over
    ``sqrt(hd)``, a ``-1e30`` causal mask, an fp32 softmax and PV, the
    output cast to q's dtype.  q ``[B, T, H, hd]``, k/v ``[B, T, KVH,
    hd]``."""
    scores, _ = da._masked_scores(q.float(), k.float(), causal, None)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, da._expand(v.float(), q.shape[2])).to(q.dtype)


def _ring_of(mesh: Any) -> tuple[int, int]:
    """``(n, rank)`` of the sp ring: one rank without a mesh."""
    return (1, 0) if mesh is None else (mesh.sp, mesh.sp_rank)


def _hop(mesh: Any, tensors: list) -> list:
    """One hop of the sp ring (``TrainMesh.shift``); a ring of one keeps
    its tensors."""
    return list(tensors) if mesh is None else mesh.shift(tensors)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *,
                          causal: bool = True) -> torch.Tensor:
    """The plain version of the ring (the reference's ``_ring_attention_local``
    step for step): this rank's q ``[B, Tq, H, hd]`` against every rank's
    k/v ``[B, Tk, KVH, hd]`` brought round the ring, through an fp32 online
    softmax.  Not differentiable (the hops are sends)."""
    n, idx = _ring_of(mesh)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    k, v = da._expand(k, h), da._expand(v, h)
    q32 = q.float()
    q_pos = idx * tq + torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    kv = [k, v]
    for step in range(n):
        owner = (idx - step) % n
        k_pos = owner * tk + torch.arange(tk, device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, kv[0].float()) / math.sqrt(d)
        if causal:
            scores = scores.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG)
        new_m = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        l = l * correction + p.sum(-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, kv[1].float())
        m = new_m
        if step < n - 1:
            kv = _hop(mesh, kv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# the merge (B6)
# ---------------------------------------------------------------------------


def _merge_weights(lse: torch.Tensor, lse_c: torch.Tensor):
    """``lse' = logaddexp(lse, lse_c)`` and the two terms' weights ``exp(lse
    - lse')`` and ``exp(lse_c - lse')``, a ``-inf`` term weighing 0 (and
    ``lse'`` ``-inf`` when both are)."""
    m = torch.maximum(lse, lse_c)
    none = m == -math.inf
    merged = torch.where(none, -math.inf, m + torch.log1p(torch.exp(-(lse - lse_c).abs())))

    def weight(x):
        return torch.where((x == -math.inf) | none, 0.0, torch.exp(x - merged))

    return merged, weight(lse), weight(lse_c)


def ring_merge_reference(acc: Optional[torch.Tensor], lse: Optional[torch.Tensor],
                         out_c: torch.Tensor, lse_c: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`ring_merge`: ``acc`` (fp32 ``[B, Tq, H,
    hd]``) and ``lse`` (fp32 ``[B, H, Tq]``) updated in place by a chunk's
    ``out_c`` (the dtype's ``[B, Tq, H, hd]``) and ``lse_c``; ``acc`` None
    starts them (``out_c`` in fp32, ``lse_c``)."""
    if acc is None:
        return out_c.float(), lse_c.clone()
    merged, wa, wb = _merge_weights(lse, lse_c)
    acc.mul_(wa.transpose(1, 2)[..., None]).add_(out_c.float() * wb.transpose(1, 2)[..., None])
    lse.copy_(merged)
    return acc, lse


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ring_merge
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def ring_merge(acc: Optional[torch.Tensor], lse: Optional[torch.Tensor], out_c: torch.Tensor,
               lse_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel: fold a chunk's ``(out_c [B, Tq, H, hd], lse_c [B,
    H, Tq])`` into ``acc`` (fp32, out_c's shape) and ``lse`` (fp32, lse_c's
    shape), in place (``lse' = logaddexp(lse, lse_c)``, ``acc' = acc
    e^(lse - lse') + out_c e^(lse_c - lse')``); ``acc`` None allocates and
    starts them from the chunk.  Returns ``(acc, lse)``.  Raises
    ``ValueError`` on an operand the kernel does not take (a dtype other
    than fp32/bf16 for out_c, a head width not in
    ``KERNEL_HEAD_DIMS``, other shapes, a non-contiguous or misaligned
    tensor, a device other than one CUDA card).  Counted in
    ``ring_merge.launches``."""
    if out_c.dtype not in da._DTYPE_CODES or out_c.dim() != 4 \
            or out_c.shape[3] not in da.KERNEL_HEAD_DIMS:
        raise ValueError(f"ring_merge kernel: out_c fp32/bf16 [B, Tq, H, hd] with hd in "
                         f"{da.KERNEL_HEAD_DIMS}, got {out_c.dtype} {tuple(out_c.shape)}")
    b, tq, h, hd = out_c.shape
    first = acc is None
    if first:
        acc = torch.empty(out_c.shape, dtype=torch.float32, device=out_c.device)
        lse = torch.empty(lse_c.shape, dtype=torch.float32, device=out_c.device)
    tensors = (acc, lse, out_c, lse_c)
    if tuple(acc.shape) != (b, tq, h, hd) or any(
            tuple(x.shape) != (b, h, tq) for x in (lse, lse_c)) or any(
            x.dtype != torch.float32 for x in (acc, lse, lse_c)):
        raise ValueError("ring_merge kernel: acc fp32 of out_c's shape, lse and lse_c fp32 "
                         "[B, H, Tq]")
    if not all(x.is_contiguous() for x in tensors) or any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("ring_merge kernel: every operand contiguous and 16-byte aligned")
    if any(x.device.type != "cuda" for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError("ring_merge kernel: all operands on one CUDA device")
    fn = _build.load(SOURCE, _bind).ring_merge
    with torch.cuda.device(out_c.device):
        stream = torch.cuda.current_stream(out_c.device).cuda_stream
        err = fn(da._DTYPE_CODES[out_c.dtype], hd, acc.data_ptr(), lse.data_ptr(), out_c.data_ptr(),
                 lse_c.data_ptr(), b, tq, h, int(first), stream)
    if err != 0:
        raise RuntimeError(f"ring_merge kernel launch failed: CUDA error {err}")
    ring_merge.launches += 1
    return acc, lse


ring_merge.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkSteps:
    """What a ring step runs on a visiting chunk: ``fwd(q, k, v, pos) ->
    (out_c, lse_c)``; ``merge(acc, lse, out_c, lse_c) -> (acc, lse)``;
    ``d(q, k, v, pos, out, lse, dout) -> D`` ("D only"); ``bwd(q, k, v,
    pos, out, lse, dout, d=D) -> (dq, dk, dv)`` ("D given")."""

    fwd: Callable
    merge: Callable
    d: Callable
    bwd: Callable


KERNEL_STEPS = ChunkSteps(da.dense_attention_fwd, ring_merge, da.dense_attention_d,
                          da.dense_attention_bwd)
PLAIN_STEPS = ChunkSteps(da.dense_attention_fwd_reference, ring_merge_reference,
                         da.dense_attention_d_reference, da.dense_attention_bwd_reference)


def chunk_steps(t: torch.Tensor) -> ChunkSteps:
    """The plain versions for a CPU tensor, the kernels otherwise."""
    return PLAIN_STEPS if t.device.type == "cpu" else KERNEL_STEPS


def chunk_positions(rank: int, owner: int, b: int, tq: int, tk: int, causal: bool,
                    device: torch.device) -> Optional[torch.Tensor]:
    """The positions B9 is given for sp rank ``rank``'s queries against
    the chunk of rank ``owner`` (int32 ``[B, Tq]``), ``None`` where no key
    is live (a later rank's chunk, causal): ``rank · Tq + i - owner · Tk``
    when causal (``>= Tk`` on an earlier rank's chunk: every key live;
    ``i`` on the rank's own), ``Tk - 1`` otherwise."""
    if not causal:
        return torch.full((b, tq), tk - 1, dtype=torch.int32, device=device)
    if owner > rank:
        return None
    first = rank * tq - owner * tk
    return torch.arange(first, first + tq, dtype=torch.int32, device=device).expand(b, tq) \
        .contiguous()


def _live_chunks(mesh: Any, q: torch.Tensor, tk: int, causal: bool):
    """``(step, positions or None)`` of each of the ring's steps."""
    n, r = _ring_of(mesh)
    b, tq = q.shape[:2]
    return [(step, chunk_positions(r, (r - step) % n, b, tq, tk, causal, q.device))
            for step in range(n)]


def _ring_forward(q, k, v, mesh, causal, steps):
    acc = lse = None
    kv = [k, v]
    chunks = _live_chunks(mesh, q, k.shape[1], causal)
    for step, pos in chunks:
        if pos is not None:
            out_c, lse_c = steps.fwd(q, kv[0], kv[1], pos)
            acc, lse = steps.merge(acc, lse, out_c, lse_c)
        if step < len(chunks) - 1:
            kv = _hop(mesh, kv)
    return acc.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, dout, mesh, causal, steps):
    chunks = _live_chunks(mesh, q, k.shape[1], causal)
    last = len(chunks) - 1
    if q.dtype == torch.float32:  # rowsum(dO * out): the pre-pass, once
        d = steps.d(q, k, v, chunks[0][1], out, lse, dout)
    else:  # sum_k P dP over the whole ring: each chunk's partial
        d, kv = None, [k, v]
        for step, pos in chunks:
            if pos is not None:
                part = steps.d(q, kv[0], kv[1], pos, out, lse, dout)
                d = part if d is None else d.add_(part)
            if step < last:
                kv = _hop(mesh, kv)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    travel = [k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
    for step, pos in chunks:
        if pos is not None:
            gq, gk, gv = steps.bwd(q, travel[0], travel[1], pos, out, lse, dout, d=d)
            dq.add_(gq)
            travel[2].add_(gk)
            travel[3].add_(gv)
        # the accumulators travel on with their chunk; after the last chunk
        # they alone make the hop home
        travel = _hop(mesh, travel if step < last else travel[2:])
    dk, dv = travel[-2:]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring under autograd (see the module note): the forward saves q,
    the rank's own k and v, the output and the global ``lse``; the backward
    runs the D ring (bf16) and the gradient ring and returns dq, dk, dv in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):  # type: ignore[override]
        out, lse = _ring_forward(q, k, v, mesh, causal, chunk_steps(q))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout.contiguous(), ctx.mesh, ctx.causal,
                                    chunk_steps(q))
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *,
                   causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention of this sp rank's chunk: q ``[B, Tq, H,
    hd]`` and k/v ``[B, Tk, KVH, hd]``, the rank's contiguous chunks of a
    sequence cut into equal chunks over ``mesh``'s sp line (``mesh`` None:
    a ring of one), the mask from chunk ownership (the global positions
    ``forward`` gives by default).  Returns the chunk's ``[B, Tq, H, hd]``,
    differentiable in q, k and v.  CPU tensors take the plain steps, CUDA
    tensors the kernels or a raise.  ``ValueError`` when the chunks'
    lengths differ."""
    if q.shape[1] != k.shape[1] or k.shape != v.shape:
        raise ValueError(f"ring_attention: q, k and v must be chunks of one length, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return RingAttention.apply(q, k, v, mesh, causal)
