"""Top-k routing, capacity-bounded dispatch and weighted combine of the MoE
FFN (``cordum_tpu/models/moe.py`` ``moe_ffn``, lines 80-107) and their
gradients.

The functions of one computation live here:

  * the plain versions, in the reference's own form:
    :func:`moe_route_reference` (top-k by a stable descending sort, ties to
    the lower index as ``lax.top_k`` breaks them; positions by the exclusive
    cumsum of the one-hot mask in (token, slot) order), and
    :func:`moe_dispatch_reference` / :func:`moe_combine_reference` (the
    ``nkec,nd->ecd`` and ``nkec,ecd->nd`` einsums over the dense one-hot
    tensor ``[N, k, E, C]`` in fp32, cast back).  Autograd of them is the
    plain version of the gradients.  The CPU tests and ``chip_smoke.py``'s
    checks use them; nothing on the card's main path does;
  * the wrappers of the hand-written Hopper kernels in
    ``csrc/moe_dispatch.cu``, one a launch mode, each counting its launches
    in ``<function>.launches``: :func:`moe_route_kernel` (a pick and a
    place launch over tiles of :data:`ROUTE_TILE` tokens, no atomics);
    :func:`moe_slot_gather` (each routed token to its kept capacity rows:
    the dispatch forward) and :func:`moe_slot_gather_scaled` (the same
    scaled by each slot's weight: the combine backward's ``d_out``);
    :func:`moe_token_gather` (a token from its kept slots, weighted: the
    combine forward), :func:`moe_token_sum` (unweighted: the dispatch
    backward) and :func:`moe_token_dot` (the combine backward's ``d_w``),
    the token-gather kernel body's three modes;
  * :class:`MoEDispatch` and :class:`MoECombine`, the
    ``torch.autograd.Function`` s whose backwards launch the kernels;
  * :func:`moe_route`, :func:`moe_dispatch` and :func:`moe_combine`, the
    entries the model calls: CPU tensors take the plain versions, CUDA
    tensors the kernels or a raise.  There is no fallback from the kernels
    to the plain versions.

A route is a :class:`MoERoute`: ``idx``, ``pos`` ``[N, k]`` int32 (the
expert of each slot and its position in the expert's queue before the
capacity cut), ``keep`` ``[N, k]`` bool (``pos < C``), ``counts`` ``[E]``
int32 (top-k hits before capacity: the aux loss's), ``slot_token`` and
``slot_k`` ``[E, C]`` int32 (the token and slot in each capacity row, -1
where the row is empty).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

SOURCE = _build.CSRC / "moe_dispatch.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: tokens a route block (``kRouteTile`` in the source)
ROUTE_TILE = 128
#: the most experts the route kernel takes (``kRouteMaxExperts``): a
#: block's rows, E x ROUTE_TILE fp32, sit in shared memory
ROUTE_MAX_EXPERTS = 448


class MoERoute(NamedTuple):
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    slot_token: torch.Tensor
    slot_k: torch.Tensor


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def moe_route_reference(probs: torch.Tensor, top_k: int, capacity: int) -> MoERoute:
    """The plain route of fp32 ``probs [N, E]``, as ``moe.py:82-94``
    computes it."""
    n, e = probs.shape
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    onehot = torch.nn.functional.one_hot(idx, e)  # [N, k, E] int64
    flat = onehot.reshape(n * top_k, e)
    pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(n, top_k)
    keep = pos < capacity
    slot_token = torch.full((e, capacity), -1, dtype=torch.int32, device=probs.device)
    slot_k = torch.full_like(slot_token, -1)
    tok = torch.arange(n, dtype=torch.int32, device=probs.device)[:, None].expand(n, top_k)
    slot = torch.arange(top_k, dtype=torch.int32, device=probs.device).expand(n, top_k)
    slot_token[idx[keep], pos[keep]] = tok[keep]
    slot_k[idx[keep], pos[keep]] = slot[keep]
    return MoERoute(idx.to(torch.int32), pos.to(torch.int32), keep,
                    flat.sum(0).to(torch.int32), slot_token, slot_k)


def dispatch_tensor(route: MoERoute) -> torch.Tensor:
    """The reference's dense fp32 ``dispatch [N, k, E, C]`` (``moe.py:91-94``):
    one where slot ``(n, s)`` is kept at row ``(idx, pos)``."""
    e, c = route.slot_token.shape
    keep = route.keep.float()
    within_cap = torch.nn.functional.one_hot(route.idx.long(), e).float() * keep[..., None]
    pos_idx = torch.where(route.keep, route.pos, 0).long()
    cap_onehot = torch.nn.functional.one_hot(pos_idx, c).float()
    return within_cap[..., None] * cap_onehot[:, :, None, :]


def moe_dispatch_reference(tokens: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``expert_in [E, C, D]`` as ``moe.py:96``: the einsum over the dense
    one-hot tensor in fp32, cast to the tokens' dtype."""
    return torch.einsum("nkec,nd->ecd", dispatch_tensor(route),
                        tokens.float()).to(tokens.dtype)


def moe_combine_reference(expert_out: torch.Tensor, w: torch.Tensor,
                          route: MoERoute) -> torch.Tensor:
    """``y [N, D]`` as ``moe.py:105-106``: the routing weights ``w [N, k]``
    folded into the one-hot tensor, the einsum in fp32, cast to the expert
    outputs' dtype."""
    combine = dispatch_tensor(route) * w[..., None, None]
    return torch.einsum("nkec,ecd->nd", combine, expert_out.float()).to(expert_out.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_route.argtypes = [ptr, i32, i32, i32, i32] + [ptr] * 7 + [i32, ptr]
    lib.moe_slot_gather.argtypes = [i32] + [ptr] * 6 + [i32] * 5 + [ptr, ptr]
    lib.moe_token_gather.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr, ptr]
    lib.moe_token_dot.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr, ptr]
    for fn in (lib.moe_route, lib.moe_slot_gather, lib.moe_token_gather, lib.moe_token_dot):
        fn.restype = ctypes.c_int


def _check(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every operand is contiguous and on one
    CUDA device (the last check)."""
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} kernel: every operand must be contiguous")
    if any(x.device.type != "cuda" for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError(f"{name} kernel: all operands on one CUDA device")


def _check_route(name: str, route: MoERoute, n: int, e: int, c: int) -> int:
    """Check a route's dtypes and shapes against ``n`` tokens, ``e``
    experts and capacity ``c``; returns k."""
    k = route.idx.shape[1] if route.idx.dim() == 2 else 0
    want = {"idx": (torch.int32, (n, k)), "pos": (torch.int32, (n, k)),
            "keep": (torch.bool, (n, k)), "counts": (torch.int32, (e,)),
            "slot_token": (torch.int32, (e, c)), "slot_k": (torch.int32, (e, c))}
    for field, (dtype, shape) in want.items():
        x = getattr(route, field)
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} kernel: route.{field} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if not 1 <= k <= e or n < 1 or n * k >= 2**31 or e * c >= 2**31:
        raise ValueError(f"{name} kernel: N {n}, k {k}, E {e}, C {c}")
    return k


def _check_rows(name: str, x: torch.Tensor, shape: tuple) -> None:
    """Raise ``ValueError`` unless ``x`` is fp32 or bf16 with leading dims
    ``shape`` and one trailing dim D."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel: float32 or bfloat16 rows, got {x.dtype}")
    if x.dim() != len(shape) + 1 or tuple(x.shape[:-1]) != tuple(shape) or x.shape[-1] < 1:
        raise ValueError(f"{name} kernel: rows {tuple(x.shape)}, {tuple(shape)} + (D,) expected")


def _check_weights(name: str, w: Optional[torch.Tensor], n: int, k: int) -> tuple:
    """``(w,)`` after checking it is fp32 ``[N, k]``; ``()`` without it."""
    if w is None:
        return ()
    if w.dtype != torch.float32 or tuple(w.shape) != (n, k):
        raise ValueError(f"{name} kernel: w must be fp32 {(n, k)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    return (w,)


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def route_tiles(n: int) -> int:
    """The route's blocks for ``n`` tokens: tiles of :data:`ROUTE_TILE`,
    the last one partial; the rows of its count table."""
    return -(-n // ROUTE_TILE)


def moe_route_kernel(probs: torch.Tensor, top_k: int, capacity: int) -> MoERoute:
    """The route kernels on fp32 ``probs [N, E]`` on the card: a pick and
    a place launch sharing a ``[route_tiles(N), E]`` int32 count table.
    Counted once in ``moe_route_kernel.launches``."""
    if probs.dtype != torch.float32 or probs.dim() != 2:
        raise ValueError(f"moe_route kernel: probs must be fp32 [N, E], got {probs.dtype} "
                         f"{tuple(probs.shape)}")
    n, e = probs.shape
    if not 1 <= top_k <= e or capacity < 1 or n < 1 or n * top_k >= 2**31 \
            or e * capacity >= 2**31:
        raise ValueError(f"moe_route kernel: N {n}, E {e}, top_k {top_k}, capacity {capacity}")
    if e > ROUTE_MAX_EXPERTS:
        raise ValueError(f"moe_route kernel: E {e} experts, at most {ROUTE_MAX_EXPERTS} (a "
                         "block's probability rows sit in shared memory)")
    _check("moe_route", probs)
    fn = _build.load(SOURCE, _bind).moe_route
    dev = probs.device
    with torch.cuda.device(dev):
        idx = torch.empty((n, top_k), dtype=torch.int32, device=dev)
        pos = torch.empty_like(idx)
        keep = torch.empty((n, top_k), dtype=torch.bool, device=dev)
        counts = torch.empty((e,), dtype=torch.int32, device=dev)
        slot_token = torch.empty((e, capacity), dtype=torch.int32, device=dev)
        slot_k = torch.empty_like(slot_token)
        tiles = route_tiles(n)
        table = torch.empty((tiles, e), dtype=torch.int32, device=dev)
        _launch(fn, "moe_route", probs.data_ptr(), n, e, top_k, capacity, idx.data_ptr(),
                pos.data_ptr(), keep.data_ptr(), counts.data_ptr(), slot_token.data_ptr(),
                slot_k.data_ptr(), table.data_ptr(), tiles,
                torch.cuda.current_stream(dev).cuda_stream)
    moe_route_kernel.launches += 1
    return MoERoute(idx, pos, keep, counts, slot_token, slot_k)


moe_route_kernel.launches = 0  # type: ignore[attr-defined]


def _slot_gather(name: str, src: torch.Tensor, route: MoERoute,
                 w: Optional[torch.Tensor]) -> torch.Tensor:
    e, c = route.slot_token.shape
    n = route.idx.shape[0]
    _check_rows(name, src, (n,))
    d = src.shape[1]
    k = _check_route(name, route, n, e, c)
    extra = _check_weights(name, w, n, k)
    _check(name, src, route.idx, route.pos, route.keep, route.counts, *extra)
    fn = _build.load(SOURCE, _bind).moe_slot_gather
    with torch.cuda.device(src.device):
        out = torch.empty((e, c, d), dtype=src.dtype, device=src.device)
        _launch(fn, name, _DTYPE_CODES[src.dtype], src.data_ptr(), route.idx.data_ptr(),
                route.pos.data_ptr(), route.keep.data_ptr(), route.counts.data_ptr(),
                w.data_ptr() if w is not None else None, n, k, e, c, d, out.data_ptr(),
                torch.cuda.current_stream(src.device).cuda_stream)
    return out


def moe_slot_gather(src: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``[E, C, D]``: each capacity row ``(e, c)`` is ``src[slot_token[e,
    c]]``, zeros where the row is empty.  ``src`` ``[N, D]``.  The kernel
    is token-major: each routed token is read once and written to its kept
    slots' rows ``(idx, pos)``; the rows past ``min(counts[e], C)`` are the
    empty ones.  Counted in ``moe_slot_gather.launches``."""
    out = _slot_gather("moe_slot_gather", src, route, None)
    moe_slot_gather.launches += 1
    return out


moe_slot_gather.launches = 0  # type: ignore[attr-defined]


def moe_slot_gather_scaled(src: torch.Tensor, route: MoERoute, w: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`moe_slot_gather` with each row times ``w[n, slot_k[e, c]]`` in
    fp32, rounded to ``src``'s dtype.  Counted in
    ``moe_slot_gather_scaled.launches``."""
    out = _slot_gather("moe_slot_gather_scaled", src, route, w)
    moe_slot_gather_scaled.launches += 1
    return out


moe_slot_gather_scaled.launches = 0  # type: ignore[attr-defined]


def _token_gather(name: str, src: torch.Tensor, route: MoERoute,
                  w: Optional[torch.Tensor]) -> torch.Tensor:
    e, c = route.slot_token.shape
    _check_rows(name, src, (e, c))
    n = route.idx.shape[0]
    k = _check_route(name, route, n, e, c)
    d = src.shape[-1]
    extra = _check_weights(name, w, n, k)
    _check(name, src, route.idx, route.pos, route.keep, *extra)
    fn = _build.load(SOURCE, _bind).moe_token_gather
    with torch.cuda.device(src.device):
        out = torch.empty((n, d), dtype=src.dtype, device=src.device)
        _launch(fn, name, _DTYPE_CODES[src.dtype], src.data_ptr(),
                route.idx.data_ptr(), route.pos.data_ptr(), route.keep.data_ptr(),
                w.data_ptr() if w is not None else None, n, k, c, d, out.data_ptr(),
                torch.cuda.current_stream(src.device).cuda_stream)
    return out


def moe_token_gather(src: torch.Tensor, route: MoERoute, w: torch.Tensor) -> torch.Tensor:
    """``[N, D]``: each token's fp32 sum over its kept slots, in slot order,
    of ``w[n, s]`` times ``src[idx[n, s], pos[n, s]]``, rounded to
    ``src``'s dtype.  ``src`` ``[E, C, D]``.  Counted in
    ``moe_token_gather.launches``."""
    out = _token_gather("moe_token_gather", src, route, w)
    moe_token_gather.launches += 1
    return out


moe_token_gather.launches = 0  # type: ignore[attr-defined]


def moe_token_sum(src: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """:func:`moe_token_gather` with every weight 1.  Counted in
    ``moe_token_sum.launches``."""
    out = _token_gather("moe_token_sum", src, route, None)
    moe_token_sum.launches += 1
    return out


moe_token_sum.launches = 0  # type: ignore[attr-defined]


def moe_token_dot(dy: torch.Tensor, src: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``d_w [N, k]`` fp32: ``keep * <dy[n], src[idx[n, s], pos[n, s]]>``
    (fp32 products and sums).  ``dy`` ``[N, D]``, ``src`` ``[E, C, D]`` of
    one dtype.  Counted in ``moe_token_dot.launches``."""
    e, c = route.slot_token.shape
    _check_rows("moe_token_dot", src, (e, c))
    n = route.idx.shape[0]
    _check_rows("moe_token_dot", dy, (n,))
    if dy.dtype != src.dtype or dy.shape[1] != src.shape[2]:
        raise ValueError(f"moe_token_dot kernel: dy {dy.dtype} {tuple(dy.shape)} and src "
                         f"{src.dtype} {tuple(src.shape)} differ in dtype or D")
    k = _check_route("moe_token_dot", route, n, e, c)
    _check("moe_token_dot", dy, src, route.idx, route.pos, route.keep)
    fn = _build.load(SOURCE, _bind).moe_token_dot
    with torch.cuda.device(src.device):
        dw = torch.empty((n, k), dtype=torch.float32, device=src.device)
        _launch(fn, "moe_token_dot", _DTYPE_CODES[src.dtype], dy.data_ptr(), src.data_ptr(),
                route.idx.data_ptr(), route.pos.data_ptr(), route.keep.data_ptr(), n, k, c,
                src.shape[-1], dw.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream)
    moe_token_dot.launches += 1
    return dw


moe_token_dot.launches = 0  # type: ignore[attr-defined]


class MoEDispatch(torch.autograd.Function):
    """Tokens ``[N, D]`` to capacity rows ``[E, C, D]``; the backward sums
    each token's kept rows of the gradient (:func:`moe_token_sum`)."""

    @staticmethod
    def forward(ctx, tokens, *route):  # type: ignore[override]
        route = MoERoute(*route)
        ctx.save_for_backward(*route)
        return moe_slot_gather(tokens, route)

    @staticmethod
    def backward(ctx, d_expert_in):  # type: ignore[override]
        route = MoERoute(*ctx.saved_tensors)
        return (moe_token_sum(d_expert_in.contiguous(), route),) + (None,) * len(route)


class MoECombine(torch.autograd.Function):
    """Expert outputs ``[E, C, D]`` and routing weights ``w [N, k]`` (fp32)
    to tokens ``[N, D]``; the backward gives ``d_out``
    (:func:`moe_slot_gather_scaled`) and ``d_w`` (:func:`moe_token_dot`,
    fp32 as ``w``)."""

    @staticmethod
    def forward(ctx, expert_out, w, *route):  # type: ignore[override]
        route = MoERoute(*route)
        ctx.save_for_backward(expert_out, w, *route)
        return moe_token_gather(expert_out, route, w)

    @staticmethod
    def backward(ctx, dy):  # type: ignore[override]
        expert_out, w, *saved = ctx.saved_tensors
        route = MoERoute(*saved)
        dy = dy.contiguous()
        d_out = moe_slot_gather_scaled(dy, route, w)
        d_w = moe_token_dot(dy, expert_out, route)
        return (d_out, d_w) + (None,) * len(route)


# ---------------------------------------------------------------------------
# the entries the model calls
# ---------------------------------------------------------------------------


def moe_route(probs: torch.Tensor, top_k: int, capacity: int) -> MoERoute:
    """Route fp32 ``probs [N, E]`` to ``top_k`` experts with ``capacity``
    rows each: the plain version for a CPU tensor, the kernel (or a raise)
    for a CUDA one."""
    if probs.device.type == "cpu":
        return moe_route_reference(probs, top_k, capacity)
    return moe_route_kernel(probs, top_k, capacity)


def moe_dispatch(tokens: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``expert_in [E, C, D]`` from ``tokens [N, D]``, differentiable in
    the tokens."""
    if tokens.device.type == "cpu":
        return moe_dispatch_reference(tokens, route)
    return MoEDispatch.apply(tokens, *route)


def moe_combine(expert_out: torch.Tensor, w: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``y [N, D]`` from ``expert_out [E, C, D]`` and the fp32 routing
    weights ``w [N, k]``, differentiable in both."""
    if expert_out.device.type == "cpu":
        return moe_combine_reference(expert_out, w, route)
    return MoECombine.apply(expert_out, w, *route)
