"""Mixture-of-Experts decoder in PyTorch: the counterpart of
``cordum_tpu/models/moe.py`` on one card.

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

No mesh yet: ``moe_layer_specs`` and ``param_specs`` (expert parallelism
over ``ep``) come with the multi-rank work (ROADMAP A6/A11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.moe_dispatch import (moe_combine, moe_combine_reference, moe_dispatch,
                                moe_dispatch_reference, moe_route, moe_route_reference)
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


def init_moe_layer(cfg: MoEConfig, *, generator: torch.Generator,
                   device: DeviceLike = None) -> dict:
    """One layer's router and experts, the shapes and scale of the JAX
    ``init_moe_layer``: the router rounded to the base dtype and kept in
    fp32, the experts ``[E, in, out]`` in the base dtype."""
    dev = resolve_device(device)
    d, f, e = cfg.base.d_model, cfg.d_ff, cfg.n_experts

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(scale_dim)).to(cfg.base.dtype)

    return {
        "router": dense((d, e), d).float(),  # fp32 routing
        "w_gate": dense((e, d, f), d),
        "w_up": dense((e, d, f), d),
        "w_down": dense((e, f, d), f),
    }


def init_params(cfg: MoEConfig, *, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """:func:`.llama.init_params` of the base with each layer's dense FFN
    replaced by ``layer["moe"]`` (``moe.py:121-129``)."""
    params = llama.init_params(cfg.base, generator=generator, device=device)
    for layer in params["layers"]:
        for name in ("w_gate", "w_up", "w_down"):
            layer.pop(name, None)
        layer["moe"] = init_moe_layer(cfg, generator=generator, device=device)
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


def moe_ffn(x: torch.Tensor, layer: dict, cfg: MoEConfig, *, kernels: bool = True):
    """``x [B, T, D]`` → ``(y [B, T, D], {"moe_aux_loss"})``.

    The router product and softmax in fp32; the top-k weights gathered from
    the probabilities and renormalised by ``max(sum, 1e-9)`` (autograd
    carries the router's gradient through them and through the aux loss);
    the route (indices: no gradient), dispatch and combine through B7; the
    experts' SwiGLU as three ``torch.bmm`` over the capacity buffer, whose
    empty rows are zeros.  ``kernels=False``: the plain versions of the
    route, dispatch and combine whatever the device."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    tokens = x.reshape(n, d)
    logits = torch.matmul(tokens.float(), layer["router"])
    probs = torch.softmax(logits, dim=-1)
    route_fn, dispatch_fn, combine_fn = (
        (moe_route, moe_dispatch, moe_combine) if kernels
        else (moe_route_reference, moe_dispatch_reference, moe_combine_reference))
    route = route_fn(probs.detach(), k, capacity(cfg, n))
    w = torch.gather(probs, 1, route.idx.long())
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    expert_in = dispatch_fn(tokens, route)
    gate = torch.nn.functional.silu(torch.bmm(expert_in, layer["w_gate"]))
    up = torch.bmm(expert_in, layer["w_up"])
    out = torch.bmm(gate * up, layer["w_down"])  # [E, C, D]
    y = combine_fn(out, w, route)
    # Switch aux loss: E * sum_e (mean router prob) * (top-k hits / N)
    aux = e * torch.sum(probs.mean(0) * (route.counts.float() / n))
    return y.reshape(b, t, d).to(x.dtype), {"moe_aux_loss": aux}


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
            attention: Callable = llama._attention, kernels: bool = True):
    """``[B, T]`` → ``(logits [B, T, V], {"moe_aux_loss"})``: the layer loop
    of ``moe.py:142-176``, the aux loss averaged over the layers.
    ``attention`` and ``kernels`` as in :func:`.llama.forward` and
    :func:`moe_ffn`."""
    base = cfg.base
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)
    x = params["embed"][tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        x = llama._attention_residual(x, layer, base, positions, attention)
        ffn_in = rms_norm(x, layer["mlp_norm"], base.norm_eps)
        y, aux = moe_ffn(ffn_in, layer["moe"], cfg, kernels=kernels)
        aux_total = aux_total + aux["moe_aux_loss"]
        x = x + y
    x = rms_norm(x, params["final_norm"], base.norm_eps)
    return x @ params["lm_head"], {"moe_aux_loss": aux_total / max(1, base.n_layers)}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
            aux_weight: float = AUX_WEIGHT, attention: Callable = llama._attention,
            kernels: bool = True) -> torch.Tensor:
    """Next-token cross entropy (as :func:`.llama.loss_fn`) plus
    ``aux_weight`` times the aux loss (``moe.py:179-185``)."""
    logits, aux = forward(params, tokens, cfg, attention=attention, kernels=kernels)
    return llama.next_token_loss(logits, tokens) + aux_weight * aux["moe_aux_loss"]


def make_train_step(cfg: MoEConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None):
    """The single-card train step, :func:`.llama.make_train_step`'s
    contract: ``init(seed) -> (params, opt_state)`` with leaf params that
    require grad, ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)`` updating both in place (AdamW by default)."""
    return llama.train_step_of(
        lambda gen, dev: init_params(cfg, generator=gen, device=dev),
        lambda params, tokens: loss_fn(params, tokens, cfg), optimizer, device)
