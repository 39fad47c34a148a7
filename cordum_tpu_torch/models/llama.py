"""Llama-family decoder in PyTorch: the serving and training halves of
``cordum_tpu/models/llama.py``.

The same architecture and numerics as the JAX module — GQA attention with
RoPE (split-halves rotation), RMSNorm, SwiGLU — over a plain dictionary of
tensors in the ``[in, out]`` layout used as ``x @ W`` (no ``nn.Linear``
transpose), so :func:`params_from_jax` hands the JAX package's weights over
unchanged and the two packages compute the same thing.

Device placement is explicit: :func:`init_params` and
:func:`init_kv_pages` take a ``device`` (``None`` = the current CUDA card,
raising when there is none); every other function runs where its tensors
live.  The ragged serving step's attention core goes through
:func:`..ops.paged_attention.paged_attention`, and the dense ``forward``'s
(the one :func:`loss_fn` differentiates) through
:func:`..ops.dense_attention.dense_attention`: each launches its
hand-written Hopper kernels for CUDA tensors and runs the plain version for
CPU ones.

Training (:func:`make_train_step`) keeps the params as leaf tensors with
``requires_grad`` and updates them and the optimizer state in place.  Over a
:class:`..parallel.mesh.TrainMesh` of dp × tp × sp ranks a rank holds its
tensor-parallel slices of the weights, its rows of the batch and its chunk
of the sequence, and :mod:`..parallel.collectives` moves activations and
gradients between ranks where the reference's GSPMD does; with
``use_ring_attention`` the sp ranks bring K/V round a ring instead
(:mod:`..ops.ring_attention`).

Unlike JAX's functional ``.at[].set``, the paged-arena functions here
update the K/V arenas IN PLACE (and return them, for call-site symmetry
with the JAX module).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import optim
from ..device import DeviceLike, resolve_device
from ..ops.dense_attention import dense_attention, gqa_attention
from ..ops.paged_attention import AttentionPlan, paged_attention
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import copy_to_tp, gather_seq, reduce_from_tp
from ..parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP, TrainMesh

Params = dict


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1536
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # long-context: ring attention over a sequence-parallel mesh's sp line
    # (K/V chunks rotate round the ring, no rank holds the whole sequence)
    # instead of the K/V all-gather; without sp it changes nothing, as in JAX
    use_ring_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, rope_theta=500000.0, max_seq_len=8192,
        )

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig, *, generator: torch.Generator, device: DeviceLike = None,
    shard: Optional[tuple[int, int]] = None, lm_head: bool = True, dense_ffn: bool = True,
) -> Params:
    """Random weights: standard normal over ``sqrt(fan_in)``, norms at one
    — the shapes and scale of the JAX ``init_params``.  ``generator`` must
    live on ``device``; the numbers differ from ``jax.random``'s (use
    :func:`params_from_jax` to share weights between the packages).

    ``shard=(rank, tp)`` gives the rank's slices of the same weights
    (:func:`shard_params` of the full draw, bit for bit), drawn leaf by
    leaf: each leaf is drawn whole in fp32, sliced and cast before the
    next, so no more than one whole leaf is ever held.  ``lm_head=False``
    leaves it out (``None``): a rank that never samples.  ``dense_ffn=False``
    draws each layer's ``w_gate``, ``w_up`` and ``w_down`` and drops them at
    once (the MoE family's layers, which replace them; every other leaf
    keeps its numbers)."""
    dev = resolve_device(device)
    if shard is not None:
        check_tp(cfg, shard[1])
    d, h, kvh, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    specs = param_specs(cfg)["layers"][0]

    def dense(shape, scale_dim, axis=None):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        w = w.div_(math.sqrt(scale_dim))
        if shard is not None and axis is not None:
            w = _slice(w, axis, *shard)
        return w.to(cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(d),
            "wq": dense((d, h * hd), d, specs["wq"]),
            "wk": dense((d, kvh * hd), d, specs["wk"]),
            "wv": dense((d, kvh * hd), d, specs["wv"]),
            "wo": dense((h * hd, d), h * hd, specs["wo"]),
            "mlp_norm": ones(d),
        }
        for name, shape, fan_in in (("w_gate", (d, f), d), ("w_up", (d, f), d),
                                    ("w_down", (f, d), f)):
            w = dense(shape, fan_in, specs[name])
            if dense_ffn:
                layer[name] = w
        layers.append(layer)
    return {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones(d),
        # the last leaf drawn: skipping it leaves every other leaf's numbers
        "lm_head": dense((d, cfg.vocab_size), d) if lm_head else None,
    }


# ---------------------------------------------------------------------------
# tensor-parallel layout (serving gangs)
# ---------------------------------------------------------------------------


def param_specs(cfg: LlamaConfig) -> Params:
    """The reference's Megatron layout (``param_specs`` of the JAX module)
    as the axis of each leaf that splits over the ``tp`` ranks, ``None``
    for a replicated leaf: column-parallel ``wq``/``wk``/``wv`` (by head)
    and ``w_gate``/``w_up`` (by ``d_ff``), row-parallel ``wo`` and
    ``w_down``; ``embed`` on the vocabulary rows, ``lm_head`` on its
    columns.  :func:`shard_params` follows it except for ``embed`` and
    ``lm_head``, which it keeps whole (see there)."""
    layer = {
        "attn_norm": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
        "mlp_norm": None, "w_gate": 1, "w_up": 1, "w_down": 0,
    }
    return {
        "embed": 0,
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": None,
        "lm_head": 1,
    }


def _slice(w: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = w.shape[axis]
    if n % tp:
        raise ValueError(f"dimension {n} does not split over tp={tp}")
    per = n // tp
    return w.narrow(axis, rank * per, per).contiguous()


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Raise ``ValueError`` when ``cfg`` cannot split over ``tp`` ranks:
    the KV heads (and with them the query heads of each GQA group) and
    ``d_ff`` must divide evenly."""
    if tp < 1 or cfg.n_kv_heads % tp or cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} does not divide {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads "
            f"and d_ff {cfg.d_ff}")


def shard_params(params: Params, cfg: LlamaConfig, rank: int, tp: int) -> Params:
    """Rank ``rank``'s slices of full ``params`` under a ``tp``-way split,
    per :func:`param_specs`: ``wq`` on its query heads' columns, ``wk`` and
    ``wv`` on its KV heads' columns, ``wo`` on the matching rows, ``w_gate``
    and ``w_up`` on a ``d_ff / tp`` block of columns and ``w_down`` on the
    matching rows; norms whole.  Unlike the reference, ``embed`` and
    ``lm_head`` stay whole on every rank: only rank 0 samples, and a
    vocabulary-split argmax would need a cross-rank (max, index) reduction
    that keeps argmax's first-index rule.  With ``tp == 1`` the leaves are
    returned as they are."""
    check_tp(cfg, tp)
    if tp == 1:
        return params
    specs = param_specs(cfg)["layers"][0]
    return {
        "embed": params["embed"],
        "layers": [
            {k: (v if specs[k] is None else _slice(v, specs[k], rank, tp)) for k, v in layer.items()}
            for layer in params["layers"]
        ],
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }


def gather_params(params: Params, cfg: LlamaConfig, mesh: Optional[TrainMesh]) -> Params:
    """The inverse of :func:`shard_params` over a mesh rank's tp line: each
    sliced layer leaf joined from the line's slices along its
    :func:`param_specs` axis (``TrainMesh.all_gather``), in the order of
    the ranks' tp coordinates; the whole leaves as they are.  Every rank of
    the line gets the whole tree, and every rank of the mesh must call it
    (a collective).  Works on any tree of the params' structure (the AdamW
    moments too); pass detached tensors.  No mesh, or tp 1: ``params``."""
    if mesh is None or mesh.tp == 1:
        return params
    specs = param_specs(cfg)["layers"][0]
    return {
        **params,
        "layers": [
            {k: (v if specs.get(k) is None else mesh.all_gather(v, AXIS_TP, specs[k]))
             for k, v in layer.items()}
            for layer in params["layers"]
        ],
    }


def shard_serving_state(
    cfg: LlamaConfig, rank: int, tp: int, *, num_pages: int, page_size: int,
    params: Optional[Params] = None, generator: Optional[torch.Generator] = None,
    lm_head: bool = True, device: DeviceLike = None,
) -> tuple[Params, torch.Tensor, torch.Tensor]:
    """A tensor-parallel rank's serving state: its slices of the weights
    — :func:`shard_params` of the full ``params`` when given, else drawn
    leaf by leaf from ``generator`` (:func:`init_params` ``shard=``), so the
    whole model is never held — and empty page arenas ``[L, pages, ps,
    kvh / tp, hd]`` on its KV heads (axis 3), matching the column-parallel
    ``wk``/``wv``, so every page write and read of the ragged step stays on
    the rank.  ``lm_head=False`` drops the head (a rank that never
    samples)."""
    if params is not None:
        params = shard_params(params, cfg, rank, tp)
        if not lm_head:
            params = {**params, "lm_head": None}
    else:
        params = init_params(cfg, generator=generator, device=device, shard=(rank, tp),
                             lm_head=lm_head)
    k_pages, v_pages = init_kv_pages(cfg, num_pages, page_size, device=device, tp=tp)
    return params, k_pages, v_pages


def _tensor_from_numpy(a: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a)  # a private, writable copy: JAX buffers are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the raw bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(
    tree: Params, *, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Params:
    """The weights bridge: the JAX param pytree (leaves given as numpy
    arrays, or anything ``np.asarray`` takes) as this package's tensors, in
    the same ``[in, out]`` layout.  ``dtype`` casts every leaf; ``None``
    keeps each leaf's own."""
    dev = resolve_device(device)

    def conv(x):
        return _tensor_from_numpy(x, dev, dtype)

    return {
        "embed": conv(tree["embed"]),
        "layers": [{k: conv(v) for k, v in layer.items()} for layer in tree["layers"]],
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: [B, T, H, Dh], positions: [B, T]."""
    hd = x.shape[-1]
    freqs = 1.0 / (
        theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    )
    angles = positions[..., None].float() * freqs  # [B, T, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attention(q, k, v, cfg: LlamaConfig, *, causal: bool = True, q_offset=None):
    """GQA attention with the JAX ``_attention``'s numerics (an einsum in
    the input dtype, an fp32 softmax).  Every causal call with positions
    (``_block``'s, also a sequence-parallel rank's chunk of queries against
    the gathered keys) goes through :func:`dense_attention`: the B9 kernels
    for CUDA tensors, the plain version for CPU ones; a call without a mask
    or without positions is the plain einsum, which the kernels do not
    compute.  The head counts come from the shapes (``cfg`` stays for
    signature parity)."""
    if causal and q_offset is not None:
        return dense_attention(q, k, v, q_offset)
    return gqa_attention(q, k, v, causal=causal, q_offset=q_offset)


def _mlp(x: torch.Tensor, layer: dict, cfg: LlamaConfig,
         mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    return x + reduce_from_tp(_mlp_out(x, layer, cfg, mesh), mesh)


def _mlp_out(x: torch.Tensor, layer: dict, cfg: LlamaConfig,
             mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """The SwiGLU branch of :func:`_mlp`, without the residual: on a
    tensor-parallel rank (its ``d_ff`` block of ``w_gate``/``w_up`` and
    rows of ``w_down``, whatever their width) a partial sum, which the
    caller reduces; ``mesh`` sums the norm's input gradient over tp
    (:func:`copy_to_tp`)."""
    mlp_in = copy_to_tp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), mesh)
    gate = torch.nn.functional.silu(mlp_in @ layer["w_gate"])
    up = mlp_in @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


def _attention_residual(x, layer, cfg: LlamaConfig, positions, attention=_attention,
                        mesh: Optional[TrainMesh] = None):
    """``x`` plus the block's self-attention of ``rms_norm(x)``: the first
    half of :func:`_block`, which the MoE blocks share.  The head counts
    come from the weights (a tensor-parallel rank's ``wq``/``wk``/``wv``
    hold its ``n_heads / tp`` and ``n_kv_heads / tp`` heads).  ``mesh``
    (a rank of a dp × tp × sp mesh) adds the reference's collectives:
    :func:`copy_to_tp` on the norm's output, K and V gathered over sp after
    RoPE (:func:`gather_seq`: the chunk's queries, at their global
    ``positions``, attend over the whole sequence) and the ``wo`` product's
    partial sums reduced over tp (:func:`reduce_from_tp`).  With
    ``cfg.use_ring_attention`` and sp above 1, K and V are not gathered:
    :func:`..ops.ring_attention.ring_attention` brings them round the sp
    ring, its mask from chunk ownership (``forward``'s default global
    positions; ``attention`` is not called: the ring's chunk steps are
    the kernels for CUDA tensors, the plain versions for CPU ones)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h, kvh = layer["wq"].shape[1] // hd, layer["wk"].shape[1] // hd

    attn_in = copy_to_tp(rms_norm(x, layer["attn_norm"], cfg.norm_eps), mesh)
    q = (attn_in @ layer["wq"]).reshape(b, t, h, hd)
    k = (attn_in @ layer["wk"]).reshape(b, t, kvh, hd)
    v = (attn_in @ layer["wv"]).reshape(b, t, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.use_ring_attention and mesh is not None and mesh.sp > 1:
        attn = ring_attention(q, k, v, mesh)
    else:
        attn = attention(q, gather_seq(k, mesh), gather_seq(v, mesh), cfg, q_offset=positions)
    return x + reduce_from_tp(attn.reshape(b, t, h * hd) @ layer["wo"], mesh)


def _block(x, layer, cfg: LlamaConfig, positions, attention=_attention,
           mesh: Optional[TrainMesh] = None):
    return _mlp(_attention_residual(x, layer, cfg, positions, attention, mesh), layer, cfg,
                mesh)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    attention=_attention,
    mesh: Optional[TrainMesh] = None,
) -> torch.Tensor:
    """Logits for next-token prediction; tokens: [B, T] int → [B, T, V].
    The dense path (no KV cache): the serving oracle, the ``infer`` op and
    the train step.  ``attention`` is the attention core, called as
    ``attention(q, k, v, cfg, q_offset=positions)``; a caller holding the
    kernels to their plain version passes one that computes
    :func:`gqa_attention`.

    ``mesh`` (a rank of a dp × tp × sp mesh, with ``params`` its slices)
    makes it the rank's forward: ``tokens`` are its rows' chunk of ``T /
    sp`` positions, by default at their global positions ``sp_rank · T / sp
    + arange(T / sp)``; ``embed`` and ``lm_head`` are whole on every rank,
    so the logits are the chunk's, for every token of the vocabulary."""
    b, t = tokens.shape
    if positions is None:
        start = 0 if mesh is None else mesh.sp_rank * t
        positions = torch.arange(start, start + t, dtype=torch.int32,
                                 device=tokens.device).expand(b, t)
    x = params["embed"][tokens.long()]
    for layer in params["layers"]:
        x = _block(x, layer, cfg, positions, attention, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            attention=_attention, mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Next-token cross entropy over all positions but the last: logits cast
    to fp32, log-softmax, the next token's log-probability, mean over
    ``[B, T-1]`` (``cross_entropy`` is that sequence in one call; the last
    position is cut before the cast, which changes no value and saves an
    fp32 copy of the logits).

    ``mesh``: one rank's share of that mean, from the whole batch
    ``tokens [B, T]``: the rank's ``B / dp`` rows and ``T / sp`` chunk go
    through :func:`forward`, and the nll of the chunk's targets whose
    global position is below ``T - 1`` (the next tokens, the last chunk's
    one fewer) is summed and divided by the global count ``B × (T - 1)``;
    the sum of the ranks' shares over sp and dp is the mean (a tp line's
    ranks hold the same share)."""
    if mesh is None:
        return next_token_loss(forward(params, tokens, cfg, attention=attention), tokens)
    b, t = tokens.shape
    rows = mesh.dp_rows(tokens)
    start, n = mesh.sp_span(t)
    logits = forward(params, rows[:, start:start + n], cfg, attention=attention, mesh=mesh)
    targets = rows[:, start + 1:start + n + 1]
    nll = torch.nn.functional.cross_entropy(
        logits[:, :targets.shape[1]].float().reshape(-1, logits.shape[-1]),
        targets.reshape(-1).long(), reduction="sum")
    return nll / (b * (t - 1))


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn`'s cross entropy of ``logits [B, T, V]`` against the
    next tokens."""
    logits = logits[:, :-1].float()
    vocab = logits.shape[-1]
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, vocab), tokens[:, 1:].reshape(-1).long())


def make_train_step(cfg: LlamaConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None, attention=_attention,
                    mesh: Optional[TrainMesh] = None):
    """The train step: ``init(seed) -> (params, opt_state)`` and
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``, with
    ``optimizer`` an ``(init(params), update(grads, state, params))`` pair,
    by default :func:`optim.adamw_init` and :func:`optim.adamw_update`.

    ``init`` draws the weights from a torch generator seeded with ``seed``
    on ``device`` (``None``: the current CUDA card) and marks them as leaves
    that require grad.  ``step`` takes the gradients of :func:`loss_fn` and
    updates the params and the optimizer state IN PLACE under
    ``torch.no_grad()`` (it returns the same objects): this takes the place
    of the JAX step's buffer donation (``donated_train_step``), so one copy
    of the params and the moments lives on the card.

    ``mesh`` (a :class:`TrainMesh` of dp × tp × sp ranks, pp and ep 1)
    makes it a rank's step: every rank draws the whole params from the seed
    and keeps its tensor-parallel slices (:func:`init_params` ``shard=``,
    the slices of :func:`shard_params`: ``embed``, ``lm_head`` and the
    norms whole), takes its ``B / dp`` rows and ``T / sp`` chunk of the
    batch (the reference's ``P('dp', 'sp')``) and sums its share of the
    loss and its gradients over dp and sp before the update
    (:func:`make_mesh_grad`), so every rank returns the global loss.
    AdamW is elementwise: the updated slices are the slices of the
    one-process update.  No mesh, or one of one rank: one card."""
    if mesh is None or mesh.size == 1:
        return train_step_of(lambda gen, dev: init_params(cfg, generator=gen, device=dev),
                             lambda params, tokens: loss_fn(params, tokens, cfg,
                                                            attention=attention),
                             optimizer, device)
    value_and_grad = make_mesh_grad(cfg, mesh, attention=attention)
    shard = (mesh.tp_rank, mesh.tp) if mesh.tp > 1 else None

    def init_fn(gen, dev):
        return init_params(cfg, generator=gen, device=dev, shard=shard)

    return train_step_of(init_fn, None, optimizer, mesh.device if device is None else device,
                         value_and_grad=value_and_grad)


def check_mesh(cfg: LlamaConfig, mesh: TrainMesh) -> None:
    """Raise ``ValueError`` for a mesh the Llama family does not train
    over: pp above 1 (that is the pipeline family's) or a tp that does not
    split the heads and ``d_ff`` (:func:`check_tp`).  sp above 1 trains
    in either flavour of sequence parallelism: the K/V all-gather, or the
    ring with ``cfg.use_ring_attention``."""
    if mesh.pp != 1:
        raise ValueError(f"the llama family has no pipeline stages (mesh pp {mesh.pp}); "
                         "the pipeline family trains over pp")
    check_tp(cfg, mesh.tp)


def make_mesh_grad(cfg: LlamaConfig, mesh: TrainMesh, *, attention=_attention):
    """``value_and_grad(params, tokens [B, T]) -> (loss, grads)`` of one
    rank of a dp × tp × sp mesh (``params`` its slices): :func:`loss_fn`
    with the mesh (the rank's rows and chunk, its nll sum over the global
    count) and its gradients, then both summed over dp and sp
    (:func:`_mesh_sum`).  ``ValueError`` for a mesh :func:`check_mesh`
    refuses, or a batch dp or a sequence sp does not split."""
    check_mesh(cfg, mesh)

    def value_and_grad(params: Params, tokens: torch.Tensor):
        value = loss_fn(params, tokens, cfg, attention=attention, mesh=mesh)
        grads = torch.autograd.grad(value, optim.tree_leaves(params))
        return _mesh_sum(value.detach(), grads, mesh)

    return value_and_grad


def _mesh_sum(value: torch.Tensor, grads, mesh: TrainMesh):
    """The loss and every gradient summed over the dp and sp lines, in
    place (the gradients).  Never over tp: a tp line's ranks hold the same
    loss, the same whole gradients of the replicated leaves (their inputs'
    gradients are summed by :func:`copy_to_tp`) and each its own slices'."""
    value = value.clone()
    for axis in (AXIS_DP, AXIS_SP):
        for g in grads:
            mesh.all_reduce(g, axis)
        mesh.all_reduce(value, axis)
    return value, grads


def train_step_of(init_fn: Callable, loss: Optional[Callable],
                  optimizer: Optional[tuple[Callable, Callable]] = None,
                  device: DeviceLike = None, *, value_and_grad: Optional[Callable] = None):
    """The ``(init, step)`` pair of :func:`make_train_step` for any model:
    ``init_fn(generator, device)`` draws the params, ``loss(params,
    tokens)`` is the scalar the step differentiates, or
    ``value_and_grad(params, tokens) -> (loss, grads)`` (grads in
    ``optim.tree_leaves`` order) computes both, as a mesh rank's program
    does.  ``step(..., grads_out=list)`` also appends the gradients the
    update took to ``grads_out``."""
    opt_init, opt_update = optimizer or (optim.adamw_init, optim.adamw_update)
    dev = resolve_device(device)
    if value_and_grad is None:
        def value_and_grad(params: Params, tokens: torch.Tensor):
            value = loss(params, tokens)
            return value, torch.autograd.grad(value, optim.tree_leaves(params))

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = init_fn(gen, dev)
        for p in optim.tree_leaves(params):
            p.requires_grad_(True)
        return params, opt_init(params)

    def step(params: Params, opt_state: dict, tokens: torch.Tensor, *,
             grads_out: Optional[list] = None):
        value, grads = value_and_grad(params, tokens.to(dev))
        if grads_out is not None:
            grads_out.extend(grads)
        with torch.no_grad():
            opt_update(grads, opt_state, params)
        return params, opt_state, value.detach()

    return init, step


# ---------------------------------------------------------------------------
# paged KV cache: the ragged mixed prefill+decode entry (serving subsystem)
# ---------------------------------------------------------------------------
#
# The arena is [L, num_pages, page_size, kvh, hd]; a sequence's logical
# position ``p`` lives at page ``page_table[p // ps]``, slot ``p % ps``.
# Page 0 is the NULL page: padding rows and padded page-table tails point
# at it, so their writes land in slots no live sequence attends to.  The
# attention walks ONLY the page-table row handed to each token, so two
# tables may alias one physical page (copy-on-write prefix sharing); the
# serving layer keeps an aliased page read-only (``copy_kv_page`` before
# any write into it) and shares it only between identical token prefixes
# (docs/SERVING.md §Prefix cache and tiering).


def init_kv_pages(
    cfg: LlamaConfig, num_pages: int, page_size: int, dtype: Optional[torch.dtype] = None,
    *, device: DeviceLike = None, tp: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preallocated page arenas for K and V: [L, num_pages, page_size, kvh
    / tp, hd] (``tp``: a tensor-parallel rank's share of the KV heads)."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads // tp, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    return (
        torch.zeros(shape, dtype=dt, device=dev),
        torch.zeros(shape, dtype=dt, device=dev),
    )


def copy_kv_page(
    k_pages: torch.Tensor, v_pages: torch.Tensor, src: int, dst: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Duplicate one arena page on device, in place — the copy-on-write
    half of prefix sharing.  The copy never leaves the device."""
    k_pages[:, dst] = k_pages[:, src]
    v_pages[:, dst] = v_pages[:, src]
    return k_pages, v_pages


def gather_kv_pages(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_ids: list[int],
    used: list[int],
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Read pages out of the arena at their TRUE lengths — the export half
    of live KV-page migration (docs/PROTOCOL.md §Page transfer).

    ``page_ids[i]`` is an arena page index and ``used[i]`` how many of its
    ``page_size`` token slots hold live positions.  Returns per-page
    ``(k, v)`` numpy arrays of shape ``[L, used, kvh, hd]`` upcast to
    float32 — the wire format, an exact round trip for bf16/fp32 arenas."""
    out = []
    for pid, n in zip(page_ids, used):
        k = k_pages[:, pid, :n].float().cpu().numpy()
        v = v_pages[:, pid, :n].float().cpu().numpy()
        out.append((k, v))
    return out


def scatter_kv_pages(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_ids: list[int],
    blocks: list[tuple[Any, Any]],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write migrated pages into the arena, in place — the import half of
    live KV-page migration.  ``blocks[i]`` is the ``(k, v)`` pair
    :func:`gather_kv_pages` produced for ``page_ids[i]``.  Slots past a
    block's true length are zero-filled: the causal mask makes them
    unreachable and the resumed session overwrites them as it decodes."""
    ps = k_pages.shape[2]
    for pid, (k, v) in zip(page_ids, blocks):
        for arena, blk in ((k_pages, k), (v_pages, v)):
            src = torch.from_numpy(np.array(blk, np.float32))
            n = src.shape[1]
            arena[:, pid, :n] = src.to(device=arena.device, dtype=arena.dtype)
            if n < ps:
                arena[:, pid, n:] = 0
    return k_pages, v_pages


def ragged_step(
    params: Params,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    page_tables: torch.Tensor,
    token_seq: torch.Tensor,
    out_idx: torch.Tensor,
    cfg: LlamaConfig,
    *,
    sample_logits: bool = True,
    plan: Optional[AttentionPlan] = None,
    tp_group: Any = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ragged mixed prefill+decode step over the paged KV cache.

    The batch dimension is **tokens, not sequences**: decode steps, prefill
    chunks and speculative draft rows share one flat buffer.  ``tokens``,
    ``positions`` and ``token_seq`` are ``[T]`` int32; ``page_tables`` is
    ``[S+1, P]`` int32 with row S the all-null padding row (padding tokens
    map to it and write on the null page); ``out_idx`` ``[S]`` is kept for
    signature parity (the per-row argmax below covers every position).

    Each token writes its K/V at ``(page_tables[token_seq[t]][pos // ps],
    pos % ps)`` — IN PLACE into ``k_pages``/``v_pages`` — before the
    attention runs, so a prefill chunk's tokens see each other and a decode
    token sees itself; the attention (:func:`paged_attention`) then walks
    only the token's own page-table row up to its position.  The write and
    the attention are separate device calls on one stream: inside a single
    kernel the writes of one chunk would race its reads.

    Returns ``(next_tokens [T] int32, k_pages, v_pages)``: the argmax after
    every fed buffer position (speculative verification reads a draft row's
    whole span).  ``sample_logits=False`` (serving-gang followers) skips
    the lm_head projection and returns zeros; the arena writes are the
    same.  ``plan`` is the step's paged-attention work list
    (:func:`..ops.paged_attention.build_plan`), built once per step and
    handed to every layer's kernel; without it the kernel wrapper builds
    one per layer.

    ``tp_group`` (a :class:`..parallel.mesh.TPGroup`) runs one rank of a
    tensor-parallel gang: ``params`` and the arenas are the rank's slices
    (:func:`shard_serving_state`), the rank attends with its ``n_heads /
    tp`` query heads over its ``n_kv_heads / tp`` KV heads, and the
    row-parallel products ``attn @ wo`` and ``(gate * up) @ w_down`` are
    partial sums: each is all-reduced over the group before its one
    residual add, two all-reduces a layer.  ``None`` is the single-rank
    step (the same operations, with no reduction)."""
    t_buf = tokens.shape[0]
    tp = 1 if tp_group is None else tp_group.size
    reduce = (lambda t: t) if tp_group is None else tp_group.all_reduce
    h, kvh, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    ps = k_pages.shape[2]
    pos2 = positions[:, None]  # [T, 1]
    pt_tok = page_tables[token_seq.long()]  # [T, P] — each token's own row
    page_idx = torch.gather(pt_tok, 1, (pos2 // ps).long())[:, 0].long()  # [T]
    slot = (positions % ps).long()
    x = params["embed"][tokens.long()][:, None, :]  # [T, 1, d]
    for li, layer in enumerate(params["layers"]):
        attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = (attn_in @ layer["wq"]).reshape(t_buf, 1, h, hd)
        k = (attn_in @ layer["wk"]).reshape(t_buf, 1, kvh, hd)
        v = (attn_in @ layer["wv"]).reshape(t_buf, 1, kvh, hd)
        q = rope(q, pos2, cfg.rope_theta)
        k = rope(k, pos2, cfg.rope_theta)
        k_pages[li, page_idx, slot] = k[:, 0]
        v_pages[li, page_idx, slot] = v[:, 0]
        attn = paged_attention(
            q[:, 0], k_pages[li], v_pages[li], page_tables, token_seq, positions,
            plan=plan,
        )
        x = x + reduce(attn.reshape(t_buf, 1, h * hd) @ layer["wo"])
        x = x + reduce(_mlp_out(x, layer, cfg))
    if not sample_logits:
        return torch.zeros((t_buf,), dtype=torch.int32, device=tokens.device), k_pages, v_pages
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0] @ params["lm_head"]  # [T, V]
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pages, v_pages
