"""The collectives of tensor-, sequence- and expert-parallel training, as
autograd functions over a :class:`.mesh.TrainMesh`.

The JAX package has no counterpart file: there GSPMD inserts these
collectives itself, from the shardings of ``param_specs`` and the batch's
``P('dp', 'sp')`` (``cordum_tpu/models/llama.py`` ``_block``).  Here each
rank holds its own slices and the model calls them where GSPMD puts them
(Megatron's layout):

  * :func:`copy_to_tp` — identity forward, all-reduce over tp backward: on
    the replicated ``rms_norm`` outputs that feed the column-parallel
    ``wq``/``wk``/``wv`` and ``w_gate``/``w_up``.  Each tp rank's products
    send back a partial gradient (its heads', its ``d_ff`` block's); the sum
    makes the norm weights' gradients, and the residual stream's, whole and
    equal on every tp rank;
  * :func:`reduce_from_tp` — all-reduce over tp forward, identity backward:
    after the row-parallel ``wo`` and ``w_down`` products, whose outputs
    are partial sums;
  * :func:`gather_seq` — all-gather over sp along the sequence forward,
    reduce-scatter backward: on K and V after RoPE (the all-gather flavour
    of sequence parallelism), so a rank's queries, its ``T / sp`` chunk,
    attend over the whole sequence; every rank's queries send gradient into
    every key, and the reduce-scatter sums them and hands each rank its
    chunk's;
  * :func:`copy_to_expert_plane` and :func:`reduce_from_expert_plane` —
    the first two over the tp × ep plane (``mesh.EXPERT_PLANE``), one
    collective for both lines: the MoE layer's tokens into the dispatch and
    its routing weights into the combine are whole on every rank of the
    plane, and their gradients partial (a rank holds ``E / ep`` experts and
    a ``d_ff / tp`` block of each), so the backward sums them; the
    combine's output is partial the same way, so the forward sums it;
  * :func:`exchange_counts` — the dp line's all-gather of each rank's
    per-expert hit counts ``[E]`` int32 (no gradient): the exclusive prefix
    of the lower dp ranks' counts and the global counts, the reference's
    global routing (its queue positions are an exclusive cumsum over the
    whole batch, dp rank r's tokens behind every lower rank's).

Each is the identity, with no autograd node, where its line or plane has
one rank (or there is no mesh), so a one-rank model runs exactly the
one-card operations.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .mesh import AXIS_DP, AXIS_SP, AXIS_TP, EXPERT_PLANE, TrainMesh


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, over):  # type: ignore[override]
        ctx.mesh, ctx.over = mesh, over
        return x

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        # a private copy: the incoming gradient may be shared with another
        # branch of the graph, and the sum is taken in place
        return (ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.over),
                None, None)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, over):  # type: ignore[override]
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), over)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):  # type: ignore[override]
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, AXIS_SP, dim)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return ctx.mesh.reduce_scatter(g, AXIS_SP, ctx.dim), None, None


def _active(mesh: Optional[TrainMesh], axis: str) -> bool:
    return mesh is not None and mesh._line_size(axis) > 1


def copy_to_tp(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` unchanged; its gradient summed over the tp line."""
    return _CopyTo.apply(x, mesh, AXIS_TP) if _active(mesh, AXIS_TP) else x


def reduce_from_tp(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` summed over the tp line (a new tensor); its gradient passed
    through to every rank unchanged."""
    return _ReduceFrom.apply(x, mesh, AXIS_TP) if _active(mesh, AXIS_TP) else x


def copy_to_expert_plane(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` unchanged; its gradient summed over the tp × ep plane."""
    return _CopyTo.apply(x, mesh, EXPERT_PLANE) if _active(mesh, EXPERT_PLANE) else x


def reduce_from_expert_plane(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` summed over the tp × ep plane (a new tensor); its gradient
    passed through to every rank unchanged."""
    return _ReduceFrom.apply(x, mesh, EXPERT_PLANE) if _active(mesh, EXPERT_PLANE) else x


def exchange_counts(counts: torch.Tensor, mesh: Optional[TrainMesh]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(prefix, total)`` of this rank's per-expert counts ``[E]`` int32
    over the dp line, one all-gather: the sum of the counts of the dp ranks
    before this one, and of all of them, each ``[E]`` int32 on ``counts``'
    device.  Without a dp line: zeros and the counts."""
    if not _active(mesh, AXIS_DP):
        return torch.zeros_like(counts), counts
    every = mesh.all_gather(counts.detach().reshape(1, -1), AXIS_DP, 0)  # [dp, E]
    return (every[:mesh.dp_rank].sum(0, dtype=torch.int32),
            every.sum(0, dtype=torch.int32))


def gather_seq(x: torch.Tensor, mesh: Optional[TrainMesh], dim: int = 1) -> Any:
    """Every sp rank's ``x`` joined along ``dim`` (the sequence) in the
    order of their chunks; its gradient summed over the sp line and cut
    back to this rank's chunk."""
    return _GatherSeq.apply(x, mesh, dim) if _active(mesh, AXIS_SP) else x
