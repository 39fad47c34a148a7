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
    place launch over tiles of :data:`ROUTE_TILE` tokens, no atomics; a
    route with a room also counts in ``room_launches``);
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
where the row is empty), and ``room`` (``None``, or ``[E]`` int32).

The room is how a data-parallel rank routes its rows of the batch as the
reference routes the whole batch (``moe.py:85-93``: one capacity for all N
tokens, queue positions an exclusive cumsum over the whole batch, so dp
rank r's pairs queue behind every lower rank's): expert e keeps the rank's
pairs while ``pos < room[e] = max(0, C - prefix[e])``, ``prefix`` the
lower ranks' counts.  Rows stay the rank's own (row ``pos`` of expert e,
filled from 0 up), and the empty rows are those past ``min(counts[e],
room[e])``.  The prefix needs every rank's counts, which the route
computes: ``room`` is a function of this route's counts that returns the
room (the caller's all-gather), called between the kernels' pick and
place launches.  :func:`local_experts` is an expert-parallel rank's view
of a route: its ``E / ep`` experts, renumbered from 0.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

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
    room: Optional[torch.Tensor] = None


#: a route's room: a function of the route's counts ``[E]`` int32 that
#: returns the room ``[E]`` int32
Room = Optional[Callable[[torch.Tensor], torch.Tensor]]


def local_experts(route: MoERoute, first: int, count: int) -> MoERoute:
    """The route as an expert-parallel rank holding experts ``[first,
    first + count)`` sees it: ``idx - first``, each pair kept where the
    route keeps it and its expert is the rank's, and ``counts``,
    ``slot_token``, ``slot_k`` and ``room`` sliced on the expert axis (views:
    they stay contiguous).  A pair that is not kept may hold any ``idx``;
    the kernels and the plain versions never read it.  The whole route
    when ``count`` is every expert."""
    if first == 0 and count == route.counts.shape[0]:
        return route
    mine = (route.idx >= first) & (route.idx < first + count)
    cut = slice(first, first + count)
    return MoERoute(route.idx - first, route.pos, route.keep & mine, route.counts[cut],
                    route.slot_token[cut], route.slot_k[cut],
                    None if route.room is None else route.room[cut])


def route_equal(a: MoERoute, b: MoERoute) -> bool:
    """Every field of two routes equal (both rooms ``None``, or equal)."""
    return all((x is None and y is None) or (x is not None and y is not None
                                             and torch.equal(x, y)) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def moe_route_reference(probs: torch.Tensor, top_k: int, capacity: int,
                        room: Room = None) -> MoERoute:
    """The plain route of fp32 ``probs [N, E]``, as ``moe.py:82-94``
    computes it; with ``room``, a dp rank's (the module's note)."""
    n, e = probs.shape
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    onehot = torch.nn.functional.one_hot(idx, e)  # [N, k, E] int64
    flat = onehot.reshape(n * top_k, e)
    pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(n, top_k)
    counts = flat.sum(0).to(torch.int32)
    if room is None:
        keep = pos < capacity
    else:
        room = room(counts).to(device=probs.device, dtype=torch.int32)
        keep = pos < room.clamp(0, capacity).long()[idx]
    slot_token = torch.full((e, capacity), -1, dtype=torch.int32, device=probs.device)
    slot_k = torch.full_like(slot_token, -1)
    tok = torch.arange(n, dtype=torch.int32, device=probs.device)[:, None].expand(n, top_k)
    slot = torch.arange(top_k, dtype=torch.int32, device=probs.device).expand(n, top_k)
    slot_token[idx[keep], pos[keep]] = tok[keep]
    slot_k[idx[keep], pos[keep]] = slot[keep]
    return MoERoute(idx.to(torch.int32), pos.to(torch.int32), keep, counts, slot_token, slot_k,
                    room)


def dispatch_tensor(route: MoERoute) -> torch.Tensor:
    """The reference's dense fp32 ``dispatch [N, k, E, C]`` (``moe.py:91-94``):
    one where slot ``(n, s)`` is kept at row ``(idx, pos)``."""
    e, c = route.slot_token.shape
    keep = route.keep.float()
    idx = torch.where(route.keep, route.idx, 0).long()  # a pair not kept may hold any idx
    within_cap = torch.nn.functional.one_hot(idx, e).float() * keep[..., None]
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
    lib.moe_route_pick.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, i32, ptr]
    lib.moe_route_place.argtypes = [i32] * 4 + [ptr] * 7 + [i32, ptr, ptr]
    lib.moe_slot_gather.argtypes = [i32] + [ptr] * 7 + [i32] * 5 + [ptr, ptr]
    lib.moe_token_gather.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr, ptr]
    lib.moe_token_dot.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr, ptr]
    for fn in (lib.moe_route, lib.moe_route_pick, lib.moe_route_place, lib.moe_slot_gather,
               lib.moe_token_gather, lib.moe_token_dot):
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
    if route.room is not None:
        want["room"] = (torch.int32, (e,))
    for field, (dtype, shape) in want.items():
        x = getattr(route, field)
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} kernel: route.{field} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    # k may exceed E: an ep rank's view holds E / ep of the route's experts
    if k < 1 or n < 1 or n * k >= 2**31 or e * c >= 2**31:
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


def moe_route_kernel(probs: torch.Tensor, top_k: int, capacity: int,
                     room: Room = None) -> MoERoute:
    """The route kernels on fp32 ``probs [N, E]`` on the card: a pick and
    a place launch sharing a ``[route_tiles(N), E]`` int32 count table.
    Without a room the two launch as a programmatic-dependent pair; with
    one (the module's note), the pick launches alone, the counts are the
    table's column sums, and the place launches with the room the function
    returns.  Counted once in ``moe_route_kernel.launches``, and in
    ``room_launches`` too with a room."""
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
    lib = _build.load(SOURCE, _bind)
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = (idx.data_ptr(), pos.data_ptr(), keep.data_ptr(), counts.data_ptr(),
                slot_token.data_ptr(), slot_k.data_ptr(), table.data_ptr(), tiles)
        if room is None:
            _launch(lib.moe_route, "moe_route", probs.data_ptr(), n, e, top_k, capacity, *outs,
                    stream)
        else:
            _launch(lib.moe_route_pick, "moe_route", probs.data_ptr(), n, e, top_k,
                    idx.data_ptr(), pos.data_ptr(), table.data_ptr(), tiles, stream)
            room = room(table.sum(0, dtype=torch.int32))
            if room.dtype != torch.int32 or tuple(room.shape) != (e,) or room.device != dev \
                    or not room.is_contiguous():
                raise ValueError(f"moe_route kernel: the room must be contiguous int32 ({e},) "
                                 f"on {dev}, got {room.dtype} {tuple(room.shape)} on "
                                 f"{room.device}")
            _launch(lib.moe_route_place, "moe_route", n, e, top_k, capacity, *outs,
                    room.data_ptr(), stream)
    moe_route_kernel.launches += 1
    if room is not None:
        moe_route_kernel.room_launches += 1
    return MoERoute(idx, pos, keep, counts, slot_token, slot_k, room)


moe_route_kernel.launches = 0  # type: ignore[attr-defined]
moe_route_kernel.room_launches = 0  # type: ignore[attr-defined]


def _slot_gather(name: str, src: torch.Tensor, route: MoERoute,
                 w: Optional[torch.Tensor]) -> torch.Tensor:
    e, c = route.slot_token.shape
    n = route.idx.shape[0]
    _check_rows(name, src, (n,))
    d = src.shape[1]
    k = _check_route(name, route, n, e, c)
    extra = _check_weights(name, w, n, k)
    room = () if route.room is None else (route.room,)
    _check(name, src, route.idx, route.pos, route.keep, route.counts, *room, *extra)
    fn = _build.load(SOURCE, _bind).moe_slot_gather
    with torch.cuda.device(src.device):
        out = torch.empty((e, c, d), dtype=src.dtype, device=src.device)
        _launch(fn, name, _DTYPE_CODES[src.dtype], src.data_ptr(), route.idx.data_ptr(),
                route.pos.data_ptr(), route.keep.data_ptr(), route.counts.data_ptr(),
                route.room.data_ptr() if room else None,
                w.data_ptr() if w is not None else None, n, k, e, c, d, out.data_ptr(),
                torch.cuda.current_stream(src.device).cuda_stream)
    return out


def moe_slot_gather(src: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """``[E, C, D]``: each capacity row ``(e, c)`` is ``src[slot_token[e,
    c]]``, zeros where the row is empty.  ``src`` ``[N, D]``.  The kernel
    is token-major: each routed token is read once and written to its kept
    slots' rows ``(idx, pos)``; the rows past ``min(counts[e], C)`` (past
    ``min(counts[e], room[e])`` under a room) are the empty ones.  Counted
    in ``moe_slot_gather.launches``."""
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


def moe_route(probs: torch.Tensor, top_k: int, capacity: int, room: Room = None) -> MoERoute:
    """Route fp32 ``probs [N, E]`` to ``top_k`` experts with ``capacity``
    rows each (and ``room``, the module's note): the plain version for a
    CPU tensor, the kernel (or a raise) for a CUDA one."""
    if probs.device.type == "cpu":
        return moe_route_reference(probs, top_k, capacity, room)
    return moe_route_kernel(probs, top_k, capacity, room)


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
