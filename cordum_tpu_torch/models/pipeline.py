"""Pipeline parallelism (``pp``) in PyTorch: the counterpart of
``cordum_tpu/models/pipeline.py``, on one process and over a rank mesh.

The reference runs a GPipe microbatch pipeline as a ``shard_map`` program:
each ``pp`` rank owns a contiguous stage of decoder layers (the stage
params stacked ``[S, L/S, ...]`` and sharded on the stage axis), and at
every tick of the ``M + S - 1``-tick schedule each stage applies its layers
to the activation it holds, the last stage adds the finished microbatch's
loss, and the activations ``ppermute`` one hop down the ring.  Here the
same schedule runs on one process: :func:`_tick` is the stage program of
one tick, :func:`_hop` the hop (a rotation of the list of held
activations; the multi-rank pipeline puts its point-to-point send and
receive there), and autograd differentiates through the whole schedule,
as ``jax.grad`` does through the ``ppermute`` chain.

A stage's layers are :func:`.llama._block`, the reference's inline block
to the operation (rms_norm, QKV, RoPE, GQA causal attention with an fp32
softmax, ``wo``, the SwiGLU MLP and both residuals).  Its attention is
:func:`.llama._attention`: the B9 kernels, forward and backward, for CUDA
tensors, the plain version for CPU ones; ``attention=`` takes another
core, as :func:`.llama.forward` does.

The stacked layout, the scales and the dtypes are the reference's
(``init_params``); the numbers come from a torch generator
(:func:`params_from_jax` carries the JAX package's weights across).

Over a :class:`..parallel.mesh.TrainMesh` of ``dp × pp`` ranks
(``make_train_step(..., mesh=)``) each rank holds its stage's slice of the
stacked leaves, ``[1, L/S, ...]`` (:func:`stage_slice`, the reference's
``P('pp', ...)``), and runs the per-rank program of the reference's
``_pipeline_local`` on its rows of every microbatch (``P(None, 'dp',
None)``): the hop is a point-to-point send and receive between pp
neighbours, and the backward is an explicit drain in reverse microbatch
order, each stage sending its input's gradient back (:func:`make_rank_grad`).
Where the reference replicates ``embed``, ``final_norm`` and ``lm_head`` on
every rank and sums their gradients over both axes, here ``embed`` lives on
the first stage's ranks and ``final_norm`` and ``lm_head`` on the last
stage's, their gradients summed over dp alone: the other stages'
contributions are exact zeros, so the update is the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import optim
from ..device import DeviceLike, resolve_device
from ..parallel.mesh import AXIS_PP, TrainMesh
from . import llama
from .llama import LlamaConfig, Params, rms_norm

#: the stacked stage leaves, in the order :func:`init_params` draws them
#: (the norms are ones and draw nothing)
STAGE_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class PipelineConfig:
    base: LlamaConfig = LlamaConfig.tiny()
    n_stages: int = 2
    n_microbatches: int = 2

    @property
    def layers_per_stage(self) -> int:
        if self.n_stages < 1 or self.base.n_layers % self.n_stages:
            raise ValueError(f"n_layers {self.base.n_layers} must divide into "
                             f"{self.n_stages} stages")
        return self.base.n_layers // self.n_stages


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: PipelineConfig, *, generator: torch.Generator,
                device: DeviceLike = None, mesh: Optional[TrainMesh] = None) -> Params:
    """Random weights in the reference's stacked layout: ``embed [V, D]``,
    ``stages`` with every leaf ``[S, L/S, ...]``, ``final_norm [D]`` and
    ``lm_head [D, V]``; standard normal over ``sqrt(fan_in)`` drawn in fp32
    and cast to the base dtype, norms at one (``pipeline.py:47-75``).
    ``generator`` must live on ``device``.

    With ``mesh`` the rank's :func:`stage_slice` of the same weights, bit
    for bit: each leaf is drawn whole in fp32 and sliced before the next,
    so no more than one whole leaf is held at a time (``lm_head``, the last
    draw, only on the last stage)."""
    base = cfg.base
    dev = resolve_device(device)
    d, h, kvh, hd, f = base.d_model, base.n_heads, base.n_kv_heads, base.head_dim, base.d_ff
    s, lps = cfg.n_stages, cfg.layers_per_stage
    stage = None if mesh is None else _mesh_stage(cfg, mesh)
    held = _held_leaves(cfg, stage)

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(scale_dim)).to(base.dtype)

    def stack(shape, scale_dim):
        w = torch.randn((s, lps, *shape), generator=generator, dtype=torch.float32, device=dev)
        w = w.div_(math.sqrt(scale_dim))
        return w.to(base.dtype) if stage is None else w[stage:stage + 1].to(base.dtype, copy=True)

    def ones(shape):
        return torch.ones(shape, dtype=base.dtype, device=dev)

    lead = s if stage is None else 1
    # drawn on every stage (the later leaves' numbers follow it), kept on the first
    embed = dense((base.vocab_size, d), d)
    params = {"embed": embed} if "embed" in held else {}
    del embed
    params["stages"] = {
        "attn_norm": ones((lead, lps, d)),
        "wq": stack((d, h * hd), d),
        "wk": stack((d, kvh * hd), d),
        "wv": stack((d, kvh * hd), d),
        "wo": stack((h * hd, d), h * hd),
        "mlp_norm": ones((lead, lps, d)),
        "w_gate": stack((d, f), d),
        "w_up": stack((d, f), d),
        "w_down": stack((f, d), f),
    }
    if "lm_head" in held:
        params.update(final_norm=ones((d,)), lm_head=dense((d, base.vocab_size), d))
    return params


def _mesh_stage(cfg: PipelineConfig, mesh: TrainMesh) -> int:
    """The mesh rank's stage; ``ValueError`` unless the mesh's pp axis is
    the config's stage count."""
    if mesh.pp != cfg.n_stages:
        raise ValueError(f"mesh pp {mesh.pp} != the pipeline's {cfg.n_stages} stages")
    return mesh.pp_rank


def _held_leaves(cfg: PipelineConfig, stage: Optional[int]) -> set:
    """The top-level leaves a stage's ranks hold (all on one process)."""
    held = {"stages"}
    if stage is None or stage == 0:
        held.add("embed")
    if stage is None or stage == cfg.n_stages - 1:
        held.update(("final_norm", "lm_head"))
    return held


def stage_slice(params: Params, cfg: PipelineConfig, stage: int) -> Params:
    """The full stacked tree's part on stage ``stage``'s ranks: every
    stage leaf's ``[stage:stage + 1]`` (views: the reference's ``P('pp',
    ...)`` shard), ``embed`` on stage 0, ``final_norm`` and ``lm_head`` on
    the last stage."""
    held = _held_leaves(cfg, stage)
    out = {k: params[k] for k in ("embed", "final_norm", "lm_head") if k in held}
    out["stages"] = {k: v[stage:stage + 1] for k, v in params["stages"].items()}
    return out


def gather_params(slices: list[Params]) -> Params:
    """The inverse of :func:`stage_slice`: the slices of stages ``0 .. S-1``
    in order → the full stacked tree (for tests and checkpoints)."""
    return {
        "embed": slices[0]["embed"],
        "stages": {k: torch.cat([sl["stages"][k] for sl in slices], 0)
                   for k in slices[0]["stages"]},
        "final_norm": slices[-1]["final_norm"],
        "lm_head": slices[-1]["lm_head"],
    }


def restack(params: Params, n_stages: int) -> Params:
    """The same tree with every stage leaf ``[S, L/S, ...]`` reshaped to
    ``[n_stages, L/n_stages, ...]``: the layers stay in order, so a tree
    of one stage count is the tree of another (``n_stages=1``: the
    one-card layout checkpoints keep)."""
    return {**params, "stages": {k: v.reshape(n_stages, -1, *v.shape[2:])
                                 for k, v in params["stages"].items()}}


def gather_stages(params: Params, cfg: PipelineConfig,
                  mesh: Optional[TrainMesh]) -> Optional[Params]:
    """The inverse of :func:`stage_slice` over a mesh rank's pp line: the
    whole stacked tree on the line's first stage (``None`` on its other
    ranks) — every stage leaf gathered over pp along its stage axis, and
    ``final_norm`` and ``lm_head`` sent from the last stage.  Every rank of
    the mesh must call it (collectives); any tree of the params' structure
    (the AdamW moments too), detached.  No mesh, or pp 1: ``params``."""
    if mesh is None or mesh.pp == 1:
        return params
    stages = {k: mesh.all_gather(v, AXIS_PP, 0) for k, v in params["stages"].items()}
    last = mesh.pp - 1
    if mesh.pp_rank == last:
        for tag, name in enumerate(("final_norm", "lm_head")):
            mesh.send(params[name], 0, tag)
        return None
    if mesh.pp_rank != 0:
        return None
    d, v, dtype = cfg.base.d_model, cfg.base.vocab_size, cfg.base.dtype
    final_norm, lm_head = (mesh.recv(shape, dtype, last, tag)
                           for tag, shape in enumerate(((d,), (d, v))))
    return {"embed": params["embed"], "stages": stages, "final_norm": final_norm,
            "lm_head": lm_head}


def params_from_jax(tree: Params, *, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The weights bridge for a JAX pipeline param tree (leaves as numpy
    arrays, or anything ``np.asarray`` takes), in the same stacked layout.
    ``dtype`` casts every leaf; ``None`` keeps each leaf's own."""
    dev = resolve_device(device)

    def conv(x):
        return llama._tensor_from_numpy(x, dev, dtype)

    return {
        "embed": conv(tree["embed"]),
        "stages": {k: conv(tree["stages"][k]) for k in STAGE_LEAVES},
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


def layer_views(stacked: Params) -> list[Params]:
    """A dict of stacked leaves as a list along their leading axis, each
    entry a dict of views, from one ``unbind`` a leaf.  Under autograd each
    leaf's gradient is then one ``stack`` of the slices' gradients; indexing
    a slice at a time would make each slice's gradient a zero-filled copy of
    the whole leaf, summed over the slices."""
    names = sorted(stacked)
    return [dict(zip(names, values))
            for values in zip(*(stacked[k].unbind(0) for k in names))]


def unstacked(params: Params) -> Params:
    """The same weights in :mod:`.llama`'s layout, ``layers`` in stage
    order (views of the stacked leaves): the oracle the pipeline's loss is
    held to, :func:`.llama.loss_fn` over every layer in one pass."""
    layers = [layer for stage in layer_views(params["stages"]) for layer in layer_views(stage)]
    return {"embed": params["embed"], "layers": layers,
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


# ---------------------------------------------------------------------------
# the stage program and the schedule
# ---------------------------------------------------------------------------


def _stage_apply(stage_params: Params, x: torch.Tensor, positions: torch.Tensor,
                 base: LlamaConfig, *, attention: Callable = llama._attention) -> torch.Tensor:
    """Apply a stage's ``L/S`` layers (``stage_params``: leaves ``[L/S,
    ...]``) in order to ``x [mb, T, D]`` (the reference scans them,
    ``pipeline.py:95-121``)."""
    for layer in layer_views(stage_params):
        x = llama._block(x, layer, base, positions, attention)
    return x


def microbatch(tokens: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, T]`` → ``[M, B/M, T]``; ``ValueError`` when ``n_micro`` does
    not divide the batch (the reference asserts it, ``pipeline.py:227-231``)."""
    b, t = tokens.shape
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return tokens.reshape(n_micro, b // n_micro, t)


def microbatch_nll(y: torch.Tensor, tokens: torch.Tensor, params: Params,
                   base: LlamaConfig) -> torch.Tensor:
    """The last stage's head on one finished microbatch: ``Σ nll`` of the
    next tokens under the log-softmax of fp32 logits (the reference's
    per-tick loss, ``pipeline.py:155-166``; :func:`.llama.next_token_loss`'s
    cross entropy, summed)."""
    h = rms_norm(y, params["final_norm"], base.norm_eps)
    logits = (h @ params["lm_head"])[:, :-1].float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long(), reduction="sum")


def _hop(outputs: list) -> list:
    """Pass every stage's output one stage down the ring: stage ``s + 1``
    receives stage ``s``'s, stage 0 the last stage's (which it never reads:
    it takes a new microbatch).  The reference's ``ppermute`` over
    ``(i, i + 1 mod S)``; on one process a rotation of the list (over a
    mesh, :func:`_hop_forward`)."""
    return outputs[-1:] + outputs[:-1]


def _tick(params: Params, stages: list[Params], held: list, tokens_mb: torch.Tensor, tick: int,
          positions: torch.Tensor, cfg: PipelineConfig, attention: Callable) -> list:
    """One tick of the schedule: each stage (``stages[s]``, its leaves
    ``[L/S, ...]``) applies its layers to what it holds (stage 0 to
    microbatch ``tick``'s embedding).  A stage whose
    microbatch ``tick - s`` lies outside ``[0, M)`` is in a bubble and is
    skipped (``None``) rather than computed and masked out, as the
    reference does: the loss and gradients are the same."""
    m, s = tokens_mb.shape[0], cfg.n_stages
    outputs: list = [None] * s
    for stage in range(s):
        if not 0 <= tick - stage < m:
            continue
        x = params["embed"][tokens_mb[tick].long()] if stage == 0 else held[stage]
        outputs[stage] = _stage_apply(stages[stage], x, positions, cfg.base,
                                      attention=attention)
    return outputs


def make_loss_fn(cfg: PipelineConfig, *, attention: Callable = llama._attention):
    """``loss(params, tokens_mb [M, mb, T])``: the mean next-token loss the
    reference's ``_pipeline_local`` + ``make_loss_fn`` compute over a ``pp
    × dp`` mesh (``pipeline.py:124-193``), on one process and device: the
    explicit ``M + S - 1``-tick GPipe schedule (:func:`_tick`, then
    :func:`_hop`), the last stage adding each finished microbatch's ``Σ
    nll``, divided by the tokens counted.  Bubble ticks are skipped, so a
    step runs each stage's layers once a microbatch: ``layers × M`` calls
    of the attention, not ``layers × (M + S - 1)``."""
    base, s = cfg.base, cfg.n_stages

    def loss(params: Params, tokens_mb: torch.Tensor) -> torch.Tensor:
        m, mb, t = tokens_mb.shape
        positions = torch.arange(t, dtype=torch.int32, device=tokens_mb.device).expand(mb, t)
        stages = layer_views(params["stages"])
        held: list = [None] * s
        nll_sum = torch.zeros((), dtype=torch.float32, device=tokens_mb.device)
        count = 0
        for tick in range(m + s - 1):
            outputs = _tick(params, stages, held, tokens_mb, tick, positions, cfg, attention)
            done = tick - (s - 1)
            if done >= 0:
                nll_sum = nll_sum + microbatch_nll(outputs[s - 1], tokens_mb[done], params, base)
                count += mb * (t - 1)
            held = _hop(outputs)
        return nll_sum / max(count, 1)

    return loss


def _hop_forward(mesh: TrainMesh, y: torch.Tensor, m: int) -> None:
    """The forward hop of microbatch ``m``: this stage's output to the
    next stage (the reference's ``ppermute``, less its wrap-around, which
    stage 0 never reads)."""
    mesh.send(y, mesh.pp_rank + 1, m)


def make_rank_grad(cfg: PipelineConfig, mesh: TrainMesh, *,
                   attention: Callable = llama._attention):
    """``value_and_grad(params, tokens_mb [M, mb, T]) -> (loss, grads)`` of
    one mesh rank (``params``: its :func:`stage_slice`; ``tokens_mb``: the
    whole batch, as every rank is given it): the per-rank program of the
    reference's ``_pipeline_local`` and its gradient.

    The rank takes its dp block of every microbatch's rows.  Fill: for each
    microbatch in order, stage 0 embeds its tokens and the other stages
    receive the previous stage's output; the stage applies its layers
    (:func:`_stage_apply`, B9 on CUDA) and sends the result on
    (:func:`_hop_forward`), or, on the last stage, adds
    :func:`microbatch_nll`.  Drain: in reverse microbatch order, each stage
    runs ``torch.autograd.backward`` from what it saved (the last stage
    from its nll with the gradient ``1 / count``, the others from their
    output with the gradient the next stage sent back) and sends its
    input's gradient to the previous stage.  The
    order of every send is fixed by this loop, the same on both sides of
    each hop, not by autograd's engine.  ``count`` is the global
    ``M × mb × (T - 1)``, so the rank's gradients are those of its partial
    sum; they are summed over dp, and the nll sum over the world, which
    makes the loss every rank returns the reference's replicated mean.
    ``grads`` follow ``optim.tree_leaves(params)``."""
    base, s = cfg.base, cfg.n_stages
    stage = _mesh_stage(cfg, mesh)
    first, last = stage == 0, stage == s - 1

    def value_and_grad(params: Params, tokens_mb: torch.Tensor):
        m, mb, t = tokens_mb.shape
        local = mesh.dp_rows(tokens_mb, 1)
        rows, count = local.shape[1], m * mb * (t - 1)
        positions = torch.arange(t, dtype=torch.int32, device=local.device).expand(rows, t)
        (layers,) = layer_views(params["stages"])
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.grad = None
        nll_sum = torch.zeros((), dtype=torch.float32, device=local.device)
        saved = []
        for i in range(m):
            if first:
                x = params["embed"][local[i].long()]
            else:
                x = mesh.recv((rows, t, base.d_model), base.dtype, stage - 1, i).requires_grad_()
            y = _stage_apply(layers, x, positions, base, attention=attention)
            if last:
                y = microbatch_nll(y, local[i], params, base)
                nll_sum += y.detach()
            else:
                _hop_forward(mesh, y, i)
            saved.append((x, y))
        for i in reversed(range(m)):
            x, y = saved.pop()
            g = (torch.ones_like(y) / count if last
                 else mesh.recv(tuple(y.shape), y.dtype, stage + 1, i))
            torch.autograd.backward(y, g)
            if not first:  # the backward hop: the input's gradient to the previous stage
                mesh.send(x.grad, stage - 1, i)
            del x, y, g
        grads = []
        for p in leaves:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            grads.append(mesh.all_reduce(g, "dp"))
        mesh.all_reduce(nll_sum, "world")
        return nll_sum / count, grads

    return value_and_grad


def make_train_step(cfg: PipelineConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None, attention: Callable = llama._attention,
                    mesh: Optional[TrainMesh] = None):
    """The pipeline train step, :func:`.llama.make_train_step`'s contract
    over ``tokens_mb [M, mb, T]``: ``init(seed) -> (params, opt_state)``,
    ``step(params, opt_state, tokens_mb) -> (params, opt_state, loss)``
    updating both in place.  The default optimizer is the reference's
    ``optax.adamw(3e-4)``, whose weight decay is optax's default 1e-4 (not
    the Llama family's 0.01).

    With a ``mesh`` of more than one rank (dp × pp, pp the config's stage
    count) it is the rank's step: ``init`` draws the rank's slice of the
    one-process weights (:func:`init_params` ``mesh=``), ``step`` takes the
    whole batch, runs :func:`make_rank_grad` and updates the leaves the
    rank holds; ``device`` defaults to the mesh's.  With no mesh, or a mesh
    of one rank, it is the one-process schedule on one device."""
    optimizer = optimizer or optim.adamw(weight_decay=optim.OPTAX_WEIGHT_DECAY)
    if mesh is None or mesh.size == 1:
        return llama.train_step_of(
            lambda gen, dev: init_params(cfg, generator=gen, device=dev),
            make_loss_fn(cfg, attention=attention), optimizer, device)
    return llama.train_step_of(
        lambda gen, dev: init_params(cfg, generator=gen, device=dev, mesh=mesh),
        None, optimizer, mesh.device if device is None else device,
        value_and_grad=make_rank_grad(cfg, mesh, attention=attention))
