"""The collectives of tensor- and sequence-parallel training, as autograd
functions over a :class:`.mesh.TrainMesh`.

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
    chunk's.

Each is the identity, with no autograd node, where its line has one rank
(or there is no mesh), so a one-rank model runs exactly the one-card
operations.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .mesh import AXIS_SP, AXIS_TP, TrainMesh


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):  # type: ignore[override]
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        # a private copy: the incoming gradient may be shared with another
        # branch of the graph, and the sum is taken in place
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), AXIS_TP), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):  # type: ignore[override]
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), AXIS_TP)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):  # type: ignore[override]
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, AXIS_SP, dim)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return ctx.mesh.reduce_scatter(g, AXIS_SP, ctx.dim), None, None


def _active(mesh: Optional[TrainMesh], axis: str) -> bool:
    return mesh is not None and mesh.sizes[axis] > 1


def copy_to_tp(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` unchanged; its gradient summed over the tp line."""
    return _CopyToTP.apply(x, mesh) if _active(mesh, AXIS_TP) else x


def reduce_from_tp(x: torch.Tensor, mesh: Optional[TrainMesh]) -> Any:
    """``x`` summed over the tp line (a new tensor); its gradient passed
    through to every rank unchanged."""
    return _ReduceFromTP.apply(x, mesh) if _active(mesh, AXIS_TP) else x


def gather_seq(x: torch.Tensor, mesh: Optional[TrainMesh], dim: int = 1) -> Any:
    """Every sp rank's ``x`` joined along ``dim`` (the sequence) in the
    order of their chunks; its gradient summed over the sp line and cut
    back to this rank's chunk."""
    return _GatherSeq.apply(x, mesh, dim) if _active(mesh, AXIS_SP) else x
