"""Masked bidirectional attention: the attention core of the embedder.

Three functions of the same computation live here:

  * :func:`embed_attention_reference` — the plain PyTorch version, with the
    JAX package's numerics (``cordum_tpu/models/embedder.py`` ``forward``):
    scores in the input dtype, then fp32 divided by ``sqrt(hd)`` plus a
    ``-1e30`` bias on masked keys, an fp32 softmax, probabilities cast back
    to the dtype before the PV product;
  * :func:`embed_attention_tiled` — a plain emulation of the kernel's
    masked-tile skip (:func:`live_key_tiles`), for the tests;
  * :func:`embed_attention` — the wrapper the embedder calls.  For CPU
    tensors it is the plain version; for CUDA tensors it launches the
    hand-written Hopper kernel in ``csrc/embed_attention.cu`` or raises.
    There is no fallback from the kernel to the plain version.

The kernel is built by :mod:`._build` at first use.  At the embedder's
shapes it is bounded by the bytes of q, k, v and out in bf16 and by the
fp32 operations in fp32.  bf16 runs on the tensor cores (``mma.sync``),
two blocks of four warps (64 query rows each) per (batch row, head); fp32
on CUDA cores, one block of eight warps; both skip 16-key tiles whose keys
are all masked.  See the source's head comment.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = _build.CSRC / "embed_attention.cu"
#: the head width the kernel is built for (EmbedderConfig: d 256 over 4 heads)
KERNEL_HEAD_DIM = 64
#: the longest row the kernel takes (EmbedderConfig.max_len)
KERNEL_MAX_LEN = 128
#: keys per tile of the kernel's masked-tile skip
TILE_KEYS = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def embed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The plain version: ``q, k, v [B, L, h, hd]``, ``mask [B, L]`` (1 =
    real key, 0 = padding); returns ``[B, L, h, hd]``.  A row whose keys
    are all masked attends uniformly to all ``L`` keys, as the reference
    does (every score rounds to exactly ``-1e30``)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def live_key_tiles(mask: torch.Tensor) -> torch.Tensor:
    """``[B, ceil(L / 16)]`` bool: the 16-key tiles the kernel loads, scores
    and multiplies.  A row with a real key keeps the tiles holding one (a
    masked key's weight is exactly 0 there); a row with none (batch
    padding) keeps every tile, since it attends uniformly to its keys."""
    b, length = mask.shape
    n_tiles = -(-length // TILE_KEYS)
    real = torch.zeros((b, n_tiles * TILE_KEYS), dtype=torch.bool, device=mask.device)
    real[:, :length] = mask > 0
    tiles = real.reshape(b, n_tiles, TILE_KEYS).any(-1)
    return tiles | ~tiles.any(-1, keepdim=True)


def embed_attention_tiled(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """A plain emulation of the kernel's masked-tile skip, for the tests:
    the keys of the tiles :func:`live_key_tiles` drops, and the padding of
    the last tile past ``L``, are left out of every softmax (weight exactly
    0, as if never scored) and out of PV.  The reference's operations run
    in its order over the ``L`` keys, so where the skip is exact this
    equals :func:`embed_attention_reference` bit for bit."""
    hd = q.shape[-1]
    length = mask.shape[1]
    keep = live_key_tiles(mask).repeat_interleave(TILE_KEYS, dim=1)[:, :length]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
    scores = (scores + bias).masked_fill(~keep[:, None, None, :], -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.embed_attention_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


def check_kernel_args(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> None:
    """Raise ``ValueError`` on any operand the kernel does not take: a
    dtype other than fp32/bf16 (fp32 mask), a shape it was not built for,
    a layout it does not index (q, k and v must share their strides, with
    unit element stride and head stride ``hd``, rows 16-byte aligned; the
    mask contiguous), or a device other than one CUDA card (checked
    last)."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"embed_attention kernel: q/k/v must share float32 or bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if mask.dtype != torch.float32:
        raise ValueError(f"embed_attention kernel: mask must be float32, got {mask.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"embed_attention kernel: q/k/v [B,L,h,hd] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, length, h, hd = q.shape
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"embed_attention kernel: head_dim {hd}; built for {KERNEL_HEAD_DIM}")
    if not 1 <= length <= KERNEL_MAX_LEN or b < 1 or h < 1:
        raise ValueError(
            f"embed_attention kernel: B {b}, L {length} (1..{KERNEL_MAX_LEN}), h {h}"
        )
    if tuple(mask.shape) != (b, length) or not mask.is_contiguous():
        raise ValueError("embed_attention kernel: mask must be a contiguous [B, L]")
    if k.stride() != q.stride() or v.stride() != q.stride() \
            or q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError(
            f"embed_attention kernel: q/k/v strides {q.stride()}, {k.stride()}, "
            f"{v.stride()}; they must agree, with head stride {hd} and unit "
            f"element stride"
        )
    el = q.element_size()
    if any(x.data_ptr() % 16 for x in (q, k, v)) or (q.stride(0) * el) % 16 \
            or (q.stride(1) * el) % 16:
        raise ValueError(
            "embed_attention kernel: q/k/v rows must be 16-byte aligned "
            "(data pointers, batch and row strides)"
        )
    tensors = (q, k, v, mask)
    if any(x.device.type != "cuda" for x in tensors) or len(
        {x.device for x in tensors}
    ) != 1:
        raise ValueError("embed_attention kernel: all operands on one CUDA device")


def embed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd) + bias(mask)) v`` per batch row and head
    for ``q, k, v [B, L, h, hd]`` and ``mask [B, L]``; returns a contiguous
    ``[B, L, h, hd]``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``embed_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return embed_attention_reference(q, k, v, mask)
    check_kernel_args(q, k, v, mask)
    fn = _build.load(SOURCE, _bind).embed_attention_launch
    b, length, h, hd = q.shape
    with torch.cuda.device(q.device):
        out = torch.empty((b, length, h, hd), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, length, h, hd, q.stride(0),
            q.stride(1), math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"embed_attention kernel launch failed: CUDA error {err}")
    embed_attention.launches += 1
    return out


embed_attention.launches = 0  # type: ignore[attr-defined]
