"""Batched text embedder: the context engine's device compute path.

The PyTorch counterpart of ``cordum_tpu/models/embedder.py``: a small
transformer encoder with mean pooling and L2 normalisation, fed by a
deterministic hashing tokenizer (no external vocab files — embeddings are
for similarity/recall inside the control plane, not for generation).  The
tokenizer is the reference's, so ids match byte for byte; the weights keep
the reference's ``[in, out]`` layout, so :func:`params_from_jax` moves them
across unchanged.

The attention core is :func:`~cordum_tpu_torch.ops.embed_attention.embed_attention`:
the hand-written kernel on CUDA tensors, its plain version on CPU tensors.
The rounding order around it follows the reference: the embedding sum in
the param dtype, LayerNorm in fp32 with population variance cast back
before the weight multiply, GELU in its tanh form (``jax.nn.gelu``'s
default), pooling over ``max(sum(mask), 1)`` and a norm clamped at 1e-6.
"""
from __future__ import annotations

import hashlib
import math
import re
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.embed_attention import embed_attention
from ..optim import tree_map
from .llama import _tensor_from_numpy

Params = dict


@dataclass(frozen=True)
class EmbedderConfig:
    vocab_size: int = 32768  # hash buckets
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 128
    dtype: torch.dtype = torch.bfloat16


_TOKEN_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def tokenize(text: str, cfg: EmbedderConfig) -> list[int]:
    """Deterministic hashing tokenizer: lowercase word/punct split, each
    token hashed into [2, vocab); 0 = pad, 1 = CLS."""
    toks = _TOKEN_RE.findall(text.lower())[: cfg.max_len - 1]
    ids = [1]
    for t in toks:
        h = int.from_bytes(hashlib.blake2b(t.encode(), digest_size=4).digest(), "big")
        ids.append(2 + h % (cfg.vocab_size - 2))
    return ids


def token_count(text: str, cfg: EmbedderConfig) -> int:
    """Exact tokenized length of ``text`` (CLS included, capped at max_len)
    without building the row — the micro-batcher's length-bucket key."""
    return min(1 + len(_TOKEN_RE.findall(text.lower())), cfg.max_len)


def batch_tokenize(
    texts: Sequence[str], cfg: EmbedderConfig, *, max_len: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(ids [B, L] int32, mask [B, L] float32); ``L`` = ``max_len`` (bucket
    length, capped at the model max) or the model max when 0."""
    length = min(max_len, cfg.max_len) if max_len else cfg.max_len
    b = len(texts)
    ids = np.zeros((b, length), np.int32)
    mask = np.zeros((b, length), np.float32)
    for i, t in enumerate(texts):
        row = tokenize(t, cfg)[:length]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1.0
    return ids, mask


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(
    cfg: EmbedderConfig, *, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random weights: standard normal over ``sqrt(fan_in)``, norms at one
    — the shapes and scale of the JAX ``init_params``.  ``generator`` must
    live on ``device``; the numbers differ from ``jax.random``'s (use
    :func:`params_from_jax` to share weights between the packages)."""
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(scale_dim)).to(cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    layers = [
        {
            "norm1": ones(d),
            "wqkv": dense((d, 3 * d), d),
            "wo": dense((d, d), d),
            "norm2": ones(d),
            "w1": dense((d, f), d),
            "w2": dense((f, d), f),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": dense((cfg.vocab_size, d), d),
        "pos": dense((cfg.max_len, d), d),
        "layers": layers,
        "final_norm": ones(d),
    }


def params_from_jax(
    tree: Params, *, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Params:
    """The weights bridge: the JAX embedder's param pytree (leaves given as
    numpy arrays, or anything ``np.asarray`` takes) as this package's
    tensors, in the same ``[in, out]`` layout.  ``dtype`` casts every leaf;
    ``None`` keeps each leaf's own."""
    dev = resolve_device(device)

    def conv(x):
        return _tensor_from_numpy(x, dev, dtype)

    return {
        "embed": conv(tree["embed"]),
        "pos": conv(tree["pos"]),
        "layers": [{k: conv(v) for k, v in layer.items()} for layer in tree["layers"]],
        "final_norm": conv(tree["final_norm"]),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def forward(
    params: Params, ids: torch.Tensor, mask: torch.Tensor, cfg: EmbedderConfig,
    *, attention: Callable[..., torch.Tensor] = embed_attention,
) -> torch.Tensor:
    """[B, L] ids + fp32 mask → [B, d_model] L2-normalised fp32 embeddings.
    ``attention`` is the attention core; a check may pass its plain version
    to run the whole forward without the kernel on a CUDA tensor."""
    b, t = ids.shape
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    x = params["embed"][ids.long()] + params["pos"][None, :t]
    for layer in params["layers"]:
        y = _layer_norm(x, layer["norm1"])
        qkv = (y @ layer["wqkv"]).reshape(b, t, 3, h, hd)
        attn = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask)
        x = x + attn.reshape(b, t, cfg.d_model) @ layer["wo"]
        y = _layer_norm(x, layer["norm2"])
        x = x + torch.nn.functional.gelu(y @ layer["w1"], approximate="tanh") @ layer["w2"]
    x = _layer_norm(x, params["final_norm"]).float()
    pooled = (x * mask[..., None]).sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)


class Embedder:
    """Params plus the forward.  ``params`` (e.g. from
    :func:`params_from_jax`) are used as given; otherwise they are drawn
    from a torch generator seeded with ``seed`` on ``device``
    (``device=None`` is the current CUDA card and raises without one).

    ``devices`` (a worker's local cards) with ``tp``: the reference's
    ``simple_mesh(tp)`` over them, the params replicated and the batch
    split over its dp axis (``n / tp`` blocks, ``cordum_tpu/models/
    embedder.py:140-170``): one replica of the params on each of the first
    ``n / tp`` devices, the batch padded to a multiple of ``n`` as the
    reference pads it to the mesh, and each block's forward on its own
    device, all launched before any is read back.  One process, no
    collective; every row's embedding is computed as on one device."""

    def __init__(
        self, cfg: Optional[EmbedderConfig] = None, *, seed: int = 0,
        device: DeviceLike = None, params: Optional[Params] = None,
        devices: Optional[Sequence[DeviceLike]] = None, tp: int = 1,
    ):
        self.cfg = cfg or EmbedderConfig()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, generator=gen, device=self.device)
        self.params = params
        devs = [self.device] if devices is None else [torch.device(d) for d in devices]
        if tp < 1 or len(devs) % tp:
            raise ValueError(f"{len(devs)} devices do not split over tp={tp}")
        self.mesh_size = len(devs)
        self.replicas = [(d, tree_map(lambda t, d=d: t.to(d), params))
                         for d in devs[:len(devs) // tp]]

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        ids, mask = batch_tokenize(texts, self.cfg)
        return self.embed_tokens(ids, mask)

    def embed_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Forward pre-tokenized (already padded/bucketed) rows — the
        micro-batcher's entry point; ``embed`` is tokenizer + this."""
        b = ids.shape[0]
        pad = -b % self.mesh_size
        ids = np.pad(ids, ((0, pad), (0, 0)))
        mask = np.pad(np.asarray(mask, np.float32), ((0, pad), (0, 0)))
        rows = (b + pad) // len(self.replicas)
        with torch.no_grad():
            outs = [forward(
                params,
                torch.from_numpy(np.ascontiguousarray(ids[i * rows:(i + 1) * rows])).to(dev),
                torch.from_numpy(np.ascontiguousarray(mask[i * rows:(i + 1) * rows])).to(dev),
                self.cfg,
            ) for i, (dev, params) in enumerate(self.replicas)]
            return torch.cat([o.cpu() for o in outs]).numpy()[:b]
