"""Pipeline parallelism (``pp``) in PyTorch: the counterpart of
``cordum_tpu/models/pipeline.py`` on one process and one device.

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
``param_specs`` (the stage axis over a ``pp`` mesh) is not ported: one
device applies no sharding (ROADMAP A9b, the multi-rank pipeline).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import optim
from ..device import DeviceLike, resolve_device
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
                device: DeviceLike = None) -> Params:
    """Random weights in the reference's stacked layout: ``embed [V, D]``,
    ``stages`` with every leaf ``[S, L/S, ...]``, ``final_norm [D]`` and
    ``lm_head [D, V]``; standard normal over ``sqrt(fan_in)`` drawn in fp32
    and cast to the base dtype, norms at one (``pipeline.py:47-75``).
    ``generator`` must live on ``device``."""
    base = cfg.base
    dev = resolve_device(device)
    d, h, kvh, hd, f = base.d_model, base.n_heads, base.n_kv_heads, base.head_dim, base.d_ff
    s, lps = cfg.n_stages, cfg.layers_per_stage

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(scale_dim)).to(base.dtype)

    def stack(shape, scale_dim):
        return dense((s, lps, *shape), scale_dim)

    def ones(shape):
        return torch.ones(shape, dtype=base.dtype, device=dev)

    embed = dense((base.vocab_size, d), d)
    stages = {
        "attn_norm": ones((s, lps, d)),
        "wq": stack((d, h * hd), d),
        "wk": stack((d, kvh * hd), d),
        "wv": stack((d, kvh * hd), d),
        "wo": stack((h * hd, d), h * hd),
        "mlp_norm": ones((s, lps, d)),
        "w_gate": stack((d, f), d),
        "w_up": stack((d, f), d),
        "w_down": stack((f, d), f),
    }
    return {"embed": embed, "stages": stages, "final_norm": ones((d,)),
            "lm_head": dense((d, base.vocab_size), d)}


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
    ``(i, i + 1 mod S)``; on one process a rotation of the list."""
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


def make_train_step(cfg: PipelineConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None, attention: Callable = llama._attention):
    """The single-device pipeline train step, :func:`.llama.make_train_step`'s
    contract over ``tokens_mb [M, mb, T]``: ``init(seed) -> (params,
    opt_state)``, ``step(params, opt_state, tokens_mb) -> (params,
    opt_state, loss)`` updating both in place.  The default optimizer is the
    reference's ``optax.adamw(3e-4)``, whose weight decay is optax's default
    1e-4 (not the Llama family's 0.01)."""
    return llama.train_step_of(
        lambda gen, dev: init_params(cfg, generator=gen, device=dev),
        make_loss_fn(cfg, attention=attention),
        optimizer or optim.adamw(weight_decay=optim.OPTAX_WEIGHT_DECAY), device)
