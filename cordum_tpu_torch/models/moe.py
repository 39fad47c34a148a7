"""Mixture-of-Experts decoder in PyTorch: the counterpart of
``cordum_tpu/models/moe.py``, on one card and over a rank mesh.

The Llama-family decoder (:mod:`.llama`) with a switch-style MoE FFN in
every layer: an fp32 router, top-k routing, each (token, slot) placed in
its expert's queue in (token, slot) order and dropped to the residual path
past ``capacity``, the experts' SwiGLU over the capacity buffer ``[E, C,
D]``, the weighted combine and the Switch aux loss.  The same names,
shapes and numerics as the JAX module, over a dictionary of tensors (each
layer's ``w_gate``, ``w_up`` and ``w_down`` replaced by ``layer["moe"]``).

The routing, dispatch and combine go through :mod:`..ops.moe_dispatch`
(B7): the hand-written Hopper kernels for CUDA tensors, the reference's
dense one-hot einsums for CPU ones; ``kernels=False`` takes the plain
versions on the card too (an oracle that does not run the kernels it
judges).  The expert products are ``torch.bmm`` over the capacity buffer,
as the JAX package leaves its E-batched einsums to XLA.  Attention is
:func:`.llama._attention`: B9 for CUDA tensors.

Over a :class:`..parallel.mesh.TrainMesh` of dp × tp × ep ranks (the
reference's ``moe_layer_specs``/``param_specs`` and its jitted step over
``P('dp', 'sp')`` batches) a rank holds its ``E / ep`` experts with their
``d_ff / tp`` columns of ``w_gate``/``w_up`` and rows of ``w_down``, its
``n_heads / tp`` attention heads as the Llama family's tp ranks do, the
router, norms, ``embed`` and ``lm_head`` whole, and ``B / dp`` rows of the
batch.  The ranks of an ep line hold the same tokens (the reference shards
the batch over dp alone), so each runs its own experts on the tokens it
has, and the experts' partial outputs are summed over the tp × ep plane
(:func:`..parallel.collectives.reduce_from_expert_plane`); no token moves
between ranks.  Routing stays the reference's, global: the capacity is
taken from the whole batch's token count, and a dp rank routes with a
room, the rows the lower dp ranks' tokens leave each expert (their counts
by one all-gather over dp, :func:`..parallel.collectives.exchange_counts`);
the aux loss is each dp rank's share of the global product, so the shares
summed over dp are the reference's.  sp above 1 is refused (ROADMAP A12b):
with sequence chunks the reference's queue order interleaves them row by
row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import optim
from ..device import DeviceLike, resolve_device
from ..ops.moe_dispatch import (local_experts, moe_combine, moe_combine_reference,
                                moe_dispatch, moe_dispatch_reference, moe_route,
                                moe_route_reference)
from ..parallel.collectives import (copy_to_expert_plane, exchange_counts,
                                    reduce_from_expert_plane)
from ..parallel.mesh import AXIS_EP, AXIS_TP, TrainMesh
from . import llama
from .llama import LlamaConfig, Params, rms_norm

#: the aux loss's weight in :func:`loss_fn` (the reference's default)
AUX_WEIGHT = 0.01


@dataclass(frozen=True)
class MoEConfig:
    base: LlamaConfig = LlamaConfig.tiny()
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    d_expert: int = 0  # 0 → base.d_ff

    @property
    def d_ff(self) -> int:
        return self.d_expert or self.base.d_ff

    @classmethod
    def tiny(cls) -> "MoEConfig":
        return cls(base=LlamaConfig.tiny(), n_experts=4, top_k=2)


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Rows per expert for ``n_tokens`` tokens (``moe.py:85``)."""
    return max(1, int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


#: a shard: ``(coords, sizes)`` of a mesh rank (``TrainMesh.coords`` and
#: ``.sizes``), the axes :func:`moe_layer_specs` names
Shard = tuple[dict, dict]


def moe_layer_specs() -> dict:
    """The reference's ``moe_layer_specs`` (``moe.py:63-70``): for each leaf
    of ``layer["moe"]``, the mesh axis each of its dims splits over
    (``None``: whole).  Experts over ep on their first axis, their
    ``d_ff`` over tp; the router whole."""
    return {
        "router": (None, None),
        "w_gate": (AXIS_EP, None, AXIS_TP),
        "w_up": (AXIS_EP, None, AXIS_TP),
        "w_down": (AXIS_EP, AXIS_TP, None),
    }


def param_specs(cfg: MoEConfig) -> Params:
    """:func:`.llama.param_specs` of the base (each leaf's tp axis) with
    each layer's dense FFN replaced by ``"moe"``: :func:`moe_layer_specs`
    (``moe.py:132-139``)."""
    specs = llama.param_specs(cfg.base)
    for layer in specs["layers"]:
        for name in ("w_gate", "w_up", "w_down"):
            layer.pop(name)
        layer["moe"] = moe_layer_specs()
    return specs


def shard_leaf(w: torch.Tensor, spec: tuple, shard: Shard) -> torch.Tensor:
    """The rank's slice of one MoE leaf ``w`` under ``spec`` (a
    :func:`moe_layer_specs` entry): each dim cut into its axis's size, the
    rank's block by its coordinate on the axis."""
    coords, sizes = shard
    for dim, axis in enumerate(spec):
        if axis is not None and sizes[axis] > 1:
            w = llama._slice(w, dim, coords[axis], sizes[axis])
    return w


def check_shard(cfg: MoEConfig, sizes: dict) -> None:
    """Raise ``ValueError`` when ``cfg`` does not split over the mesh
    ``sizes``: ep must divide the experts, tp the heads and ``d_ff`` (the
    base's, for the attention, and the experts')."""
    ep, tp = sizes[AXIS_EP], sizes[AXIS_TP]
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} does not divide {cfg.n_experts} experts")
    if cfg.d_ff % tp:
        raise ValueError(f"tp={tp} does not divide the experts' d_ff {cfg.d_ff}")
    llama.check_tp(cfg.base, tp)


def shard_params(params: Params, cfg: MoEConfig, shard: Shard) -> Params:
    """A mesh rank's slices of whole ``params``: :func:`.llama.shard_params`
    of the base leaves (heads over tp; norms, ``embed`` and ``lm_head``
    whole) and each MoE leaf by :func:`moe_layer_specs`."""
    coords, sizes = shard
    check_shard(cfg, sizes)
    base = llama.shard_params({**params, "layers": [
        {k: v for k, v in layer.items() if k != "moe"} for layer in params["layers"]]},
        cfg.base, coords[AXIS_TP], sizes[AXIS_TP])
    specs = moe_layer_specs()
    for layer, whole in zip(base["layers"], params["layers"]):
        layer["moe"] = {k: shard_leaf(v, specs[k], shard) for k, v in whole["moe"].items()}
    return base


def gather_params(params: Params, cfg: MoEConfig, mesh: Optional[TrainMesh]) -> Params:
    """The inverse of :func:`shard_params` over a mesh rank's lines: the
    base leaves by :func:`.llama.gather_params` (tp), then each MoE leaf
    joined dim by dim over the axis :func:`moe_layer_specs` gives it (ep,
    then tp), from the slices of the ranks that differ from this one on
    that axis.  Every rank of the mesh must call it (a collective) and gets
    the whole tree; any tree of the params' structure (the AdamW moments
    too), detached.  No mesh, or tp and ep 1: ``params``."""
    if mesh is None or mesh.tp == mesh.ep == 1:
        return params
    whole = llama.gather_params({**params, "layers": [
        {k: v for k, v in layer.items() if k != "moe"} for layer in params["layers"]]},
        cfg.base, mesh)
    specs = moe_layer_specs()
    for layer, sliced in zip(whole["layers"], params["layers"]):
        layer["moe"] = {}
        for k, w in sliced["moe"].items():
            for dim, axis in enumerate(specs[k]):
                if axis is not None and mesh.sizes[axis] > 1:
                    w = mesh.all_gather(w, axis, dim)
            layer["moe"][k] = w
    return whole


def init_moe_layer(cfg: MoEConfig, *, generator: torch.Generator,
                   device: DeviceLike = None, shard: Optional[Shard] = None) -> dict:
    """One layer's router and experts, the shapes and scale of the JAX
    ``init_moe_layer``: the router rounded to the base dtype and kept in
    fp32, the experts ``[E, in, out]`` in the base dtype.  ``shard``: the
    rank's slices (:func:`shard_leaf`), each leaf drawn whole in fp32,
    sliced and cast before the next."""
    dev = resolve_device(device)
    d, f, e = cfg.base.d_model, cfg.d_ff, cfg.n_experts
    specs = moe_layer_specs()

    def dense(name, shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        w = w.div_(math.sqrt(scale_dim))
        if shard is not None:
            w = shard_leaf(w, specs[name], shard)
        return w.to(cfg.base.dtype)

    return {
        "router": dense("router", (d, e), d).float(),  # fp32 routing
        "w_gate": dense("w_gate", (e, d, f), d),
        "w_up": dense("w_up", (e, d, f), d),
        "w_down": dense("w_down", (e, f, d), f),
    }


def init_params(cfg: MoEConfig, *, generator: torch.Generator,
                device: DeviceLike = None, shard: Optional[Shard] = None) -> Params:
    """:func:`.llama.init_params` of the base with each layer's dense FFN
    replaced by ``layer["moe"]`` (``moe.py:121-129``).  ``shard``: a mesh
    rank's slices of the same weights (:func:`shard_params` of the whole
    draw, bit for bit), drawn a leaf at a time, so no rank holds the whole
    model at once."""
    if shard is not None:
        check_shard(cfg, shard[1])
    tp_shard = None if shard is None or shard[1][AXIS_TP] == 1 else (
        shard[0][AXIS_TP], shard[1][AXIS_TP])
    params = llama.init_params(cfg.base, generator=generator, device=device, shard=tp_shard,
                               dense_ffn=False)
    for layer in params["layers"]:
        layer["moe"] = init_moe_layer(cfg, generator=generator, device=device, shard=shard)
    return params


def params_from_jax(tree: Params, *, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The weights bridge for a JAX MoE param tree (leaves as numpy arrays,
    or anything ``np.asarray`` takes): :func:`.llama.params_from_jax`'s
    layout with each layer's nested ``"moe"`` dict.  ``dtype`` casts every
    leaf but the router, which stays fp32."""
    dev = resolve_device(device)

    def conv(x, dt=dtype):
        return llama._tensor_from_numpy(x, dev, dt)

    def layer_of(layer):
        out = {k: conv(v) for k, v in layer.items() if k != "moe"}
        out["moe"] = {k: conv(v, torch.float32 if k == "router" else dtype)
                      for k, v in layer["moe"].items()}
        return out

    return {
        "embed": conv(tree["embed"]),
        "layers": [layer_of(layer) for layer in tree["layers"]],
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def moe_ffn(x: torch.Tensor, layer: dict, cfg: MoEConfig, *, kernels: bool = True,
            mesh: Optional[TrainMesh] = None):
    """``x [B, T, D]`` → ``(y [B, T, D], {"moe_aux_loss"})``.

    The router product and softmax in fp32; the top-k weights gathered from
    the probabilities and renormalised by ``max(sum, 1e-9)`` (autograd
    carries the router's gradient through them and through the aux loss);
    the route (indices: no gradient), dispatch and combine through B7; the
    experts' SwiGLU as three ``torch.bmm`` over the capacity buffer, whose
    empty rows are zeros.  ``kernels=False``: the plain versions of the
    route, dispatch and combine whatever the device.

    ``mesh`` (a rank of a dp × tp × ep mesh, ``layer`` its slices, ``x`` its
    ``B / dp`` rows) makes it the rank's share of the reference's global
    layer: the capacity from the whole batch's ``dp × B × T`` tokens; with
    dp above 1 the route takes a room, ``max(0, C - prefix)`` from the
    lower dp ranks' counts (one all-gather over dp between the route's two
    launches); the rank's experts see the route through
    :func:`..ops.moe_dispatch.local_experts`; the tokens into the dispatch
    and the weights into the combine go through
    :func:`..parallel.collectives.copy_to_expert_plane` (their gradients
    are partial on each rank: its experts, its ``d_ff`` block), the
    combine's output through ``reduce_from_expert_plane``.  The aux loss is
    the rank's share, ``E Σ_e (Σ_rows probs[:, e] / N) (counts[e] / N)``
    with N and the counts global: summed over dp it is the reference's
    product of global means (the tp and ep ranks of a dp index hold equal
    shares)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    tokens = x.reshape(n, d)
    logits = torch.matmul(tokens.float(), layer["router"])
    probs = torch.softmax(logits, dim=-1)
    route_fn, dispatch_fn, combine_fn = (
        (moe_route, moe_dispatch, moe_combine) if kernels
        else (moe_route_reference, moe_dispatch_reference, moe_combine_reference))
    if mesh is None:
        route = route_fn(probs.detach(), k, capacity(cfg, n))
    else:
        route, counts = _mesh_route(route_fn, probs.detach(), cfg, mesh)
    w = torch.gather(probs, 1, route.idx.long())
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    mine = route
    if mesh is not None:
        tokens, w = copy_to_expert_plane(tokens, mesh), copy_to_expert_plane(w, mesh)
        per = e // mesh.ep
        mine = local_experts(route, mesh.ep_rank * per, per)
    expert_in = dispatch_fn(tokens, mine)
    gate = torch.nn.functional.silu(torch.bmm(expert_in, layer["w_gate"]))
    up = torch.bmm(expert_in, layer["w_up"])
    out = torch.bmm(gate * up, layer["w_down"])  # [E, C, D]: a rank's [E / ep, C, D]
    y = combine_fn(out, w, mine)
    if mesh is None:
        # Switch aux loss: E * sum_e (mean router prob) * (top-k hits / N)
        aux = e * torch.sum(probs.mean(0) * (route.counts.float() / n))
    else:
        y = reduce_from_expert_plane(y, mesh)
        n_all = n * mesh.dp
        aux = e * torch.sum(probs.sum(0) / n_all * (counts.float() / n_all))
    return y.reshape(b, t, d).to(x.dtype), {"moe_aux_loss": aux}


def _mesh_route(route_fn: Callable, probs: torch.Tensor, cfg: MoEConfig, mesh: TrainMesh):
    """A mesh rank's route of its rows' ``probs [N, E]`` and the global
    per-expert counts: the capacity of the whole batch's ``dp × N`` tokens,
    and with dp above 1 the room ``max(0, C - prefix)`` from the lower dp
    ranks' counts, exchanged between the route's two launches."""
    cap, total = capacity(cfg, probs.shape[0] * mesh.dp), {}

    def room(counts: torch.Tensor) -> torch.Tensor:
        prefix, total["counts"] = exchange_counts(counts, mesh)
        return torch.clamp_min(cap - prefix, 0).to(torch.int32)

    route = route_fn(probs, cfg.top_k, cap, room if mesh.dp > 1 else None)
    return route, total.get("counts", route.counts)


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
            attention: Callable = llama._attention, kernels: bool = True,
            mesh: Optional[TrainMesh] = None):
    """``[B, T]`` → ``(logits [B, T, V], {"moe_aux_loss"})``: the layer loop
    of ``moe.py:142-176``, the aux loss averaged over the layers.
    ``attention`` and ``kernels`` as in :func:`.llama.forward` and
    :func:`moe_ffn`.  ``mesh``: a rank's forward on its rows (``params`` its
    slices), the attention's tp collectives as the Llama family's and the
    MoE layers' as :func:`moe_ffn`'s; the aux loss is the rank's share."""
    base = cfg.base
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)
    x = params["embed"][tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        x = llama._attention_residual(x, layer, base, positions, attention, mesh)
        ffn_in = rms_norm(x, layer["mlp_norm"], base.norm_eps)
        y, aux = moe_ffn(ffn_in, layer["moe"], cfg, kernels=kernels, mesh=mesh)
        aux_total = aux_total + aux["moe_aux_loss"]
        x = x + y
    x = rms_norm(x, params["final_norm"], base.norm_eps)
    return x @ params["lm_head"], {"moe_aux_loss": aux_total / max(1, base.n_layers)}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
            aux_weight: float = AUX_WEIGHT, attention: Callable = llama._attention,
            kernels: bool = True, mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Next-token cross entropy (as :func:`.llama.loss_fn`) plus
    ``aux_weight`` times the aux loss (``moe.py:179-185``).

    ``mesh``: one rank's share, from the whole batch ``tokens [B, T]``: its
    ``B / dp`` rows through :func:`forward`, their nll summed and divided
    by the global count ``B × (T - 1)``, plus ``aux_weight`` times its aux
    share; the shares summed over dp are the loss."""
    if mesh is None:
        logits, aux = forward(params, tokens, cfg, attention=attention, kernels=kernels)
        return llama.next_token_loss(logits, tokens) + aux_weight * aux["moe_aux_loss"]
    b, t = tokens.shape
    rows = mesh.dp_rows(tokens)
    logits, aux = forward(params, rows, cfg, attention=attention, kernels=kernels, mesh=mesh)
    nll = torch.nn.functional.cross_entropy(
        logits[:, :-1].float().reshape(-1, logits.shape[-1]), rows[:, 1:].reshape(-1).long(),
        reduction="sum")
    return nll / (b * (t - 1)) + aux_weight * aux["moe_aux_loss"]


def check_mesh(cfg: MoEConfig, mesh: TrainMesh) -> None:
    """Raise ``ValueError`` for a mesh the MoE family does not train over:
    pp above 1 (the pipeline family's), sp above 1 (ROADMAP A12b: with
    sequence chunks the reference's queue order interleaves the chunks of
    each row, so a rank's prefix is a row's), or an E, ``d_ff`` or head
    count its axis does not split (:func:`check_shard`)."""
    if mesh.pp != 1:
        raise ValueError(f"the moe family has no pipeline stages (mesh pp {mesh.pp}); "
                         "the pipeline family trains over pp")
    if mesh.sp != 1:
        raise ValueError(f"the moe family over sp {mesh.sp} is not supported yet (ROADMAP "
                         "A12b, MoE over sp: the reference's queue order interleaves the "
                         "sequence chunks of each row); dp, tp and ep only")
    check_shard(cfg, mesh.sizes)


def make_mesh_grad(cfg: MoEConfig, mesh: TrainMesh, *, attention: Callable = llama._attention,
                   kernels: bool = True):
    """``value_and_grad(params, tokens [B, T]) -> (loss, grads)`` of one
    rank of a dp × tp × ep mesh (``params`` its slices): :func:`loss_fn`
    with the mesh and its gradients, then both summed over dp
    (:func:`.llama._mesh_sum`; never over tp or ep: the router, the norms
    and the whole attention leaves come out whole and equal on every rank
    of a plane, their inputs' gradients summed by the plane and tp
    operators, and each expert slice lives on one rank of it).
    ``ValueError`` for a mesh :func:`check_mesh` refuses, or a batch dp
    does not split."""
    check_mesh(cfg, mesh)

    def value_and_grad(params: Params, tokens: torch.Tensor):
        value = loss_fn(params, tokens, cfg, attention=attention, kernels=kernels, mesh=mesh)
        grads = torch.autograd.grad(value, optim.tree_leaves(params))
        return llama._mesh_sum(value.detach(), grads, mesh)

    return value_and_grad


def make_train_step(cfg: MoEConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None, mesh: Optional[TrainMesh] = None):
    """The train step, :func:`.llama.make_train_step`'s contract: ``init(seed)
    -> (params, opt_state)`` with leaf params that require grad,
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
    updating both in place (AdamW by default).

    ``mesh`` (a :class:`TrainMesh` of dp × tp × ep ranks) makes it a rank's
    step (``moe.py:188-215``): every rank draws the whole params from the
    seed a leaf at a time and keeps its slices (:func:`init_params`
    ``shard=``), takes its ``B / dp`` rows of the whole batch, and sums its
    share of the loss and its gradients over dp before the update
    (:func:`make_mesh_grad`), so every rank returns the global loss and its
    updated slices are the slices of the one-process update (AdamW is
    elementwise).  No mesh, or one of one rank: one card."""
    if mesh is None or mesh.size == 1:
        return llama.train_step_of(
            lambda gen, dev: init_params(cfg, generator=gen, device=dev),
            lambda params, tokens: loss_fn(params, tokens, cfg), optimizer, device)
    value_and_grad = make_mesh_grad(cfg, mesh)
    shard = (mesh.coords, mesh.sizes)
    return llama.train_step_of(
        lambda gen, dev: init_params(cfg, generator=gen, device=dev, shard=shard), None,
        optimizer, mesh.device if device is None else device, value_and_grad=value_and_grad)
