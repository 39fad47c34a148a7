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
``requires_grad`` and updates them and the optimizer state in place.

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
    # long-context ring attention over a sequence-parallel mesh: kept for
    # field parity with the JAX config; this package has no mesh yet
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
    cfg: LlamaConfig, *, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random weights: standard normal over ``sqrt(fan_in)``, norms at one
    — the shapes and scale of the JAX ``init_params``.  ``generator`` must
    live on ``device``; the numbers differ from ``jax.random``'s (use
    :func:`params_from_jax` to share weights between the packages)."""
    dev = resolve_device(device)
    d, h, kvh, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(scale_dim)).to(cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "attn_norm": ones(d),
                "wq": dense((d, h * hd), d),
                "wk": dense((d, kvh * hd), d),
                "wv": dense((d, kvh * hd), d),
                "wo": dense((h * hd, d), h * hd),
                "mlp_norm": ones(d),
                "w_gate": dense((d, f), d),
                "w_up": dense((d, f), d),
                "w_down": dense((f, d), f),
            }
        )
    return {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones(d),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


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
    the input dtype, an fp32 softmax).  Causal self-attention with
    positions (``_block``'s call) goes through :func:`dense_attention`: the
    B9 kernels for CUDA tensors, the plain version for CPU ones; any other
    call (queries and keys of other lengths, no mask, no positions) is the
    plain einsum, which the kernels do not compute.  The head counts come
    from the shapes (``cfg`` stays for signature parity)."""
    if causal and q_offset is not None and q.shape[1] == k.shape[1]:
        return dense_attention(q, k, v, q_offset)
    return gqa_attention(q, k, v, causal=causal, q_offset=q_offset)


def _mlp(x: torch.Tensor, layer: dict, cfg: LlamaConfig) -> torch.Tensor:
    mlp_in = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = torch.nn.functional.silu(mlp_in @ layer["w_gate"])
    up = mlp_in @ layer["w_up"]
    return x + ((gate * up) @ layer["w_down"])


def _attention_residual(x, layer, cfg: LlamaConfig, positions, attention=_attention):
    """``x`` plus the block's self-attention of ``rms_norm(x)``: the first
    half of :func:`_block`, which the MoE blocks share."""
    b, t, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = (attn_in @ layer["wq"]).reshape(b, t, h, hd)
    k = (attn_in @ layer["wk"]).reshape(b, t, kvh, hd)
    v = (attn_in @ layer["wv"]).reshape(b, t, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, cfg, q_offset=positions)
    return x + (attn.reshape(b, t, h * hd) @ layer["wo"])


def _block(x, layer, cfg: LlamaConfig, positions, attention=_attention):
    return _mlp(_attention_residual(x, layer, cfg, positions, attention), layer, cfg)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    attention=_attention,
) -> torch.Tensor:
    """Logits for next-token prediction; tokens: [B, T] int → [B, T, V].
    The dense path (no mesh, no KV cache): the serving oracle, the
    ``infer`` op and the train step.  ``attention`` is the attention core,
    called as ``attention(q, k, v, cfg, q_offset=positions)``; a caller
    holding the kernels to their plain version passes one that computes
    :func:`gqa_attention`."""
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)
    x = params["embed"][tokens.long()]
    for layer in params["layers"]:
        x = _block(x, layer, cfg, positions, attention)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            attention=_attention) -> torch.Tensor:
    """Next-token cross entropy over all positions but the last: logits cast
    to fp32, log-softmax, the next token's log-probability, mean over
    ``[B, T-1]`` (``cross_entropy`` is that sequence in one call; the last
    position is cut before the cast, which changes no value and saves an
    fp32 copy of the logits)."""
    return next_token_loss(forward(params, tokens, cfg, attention=attention), tokens)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn`'s cross entropy of ``logits [B, T, V]`` against the
    next tokens."""
    logits = logits[:, :-1].float()
    vocab = logits.shape[-1]
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, vocab), tokens[:, 1:].reshape(-1).long())


def make_train_step(cfg: LlamaConfig, optimizer: Optional[tuple[Callable, Callable]] = None,
                    *, device: DeviceLike = None, attention=_attention):
    """The single-card train step: ``init(seed) -> (params, opt_state)`` and
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``, with
    ``optimizer`` an ``(init(params), update(grads, state, params))`` pair,
    by default :func:`optim.adamw_init` and :func:`optim.adamw_update`.

    ``init`` draws the weights from a torch generator seeded with ``seed``
    on ``device`` (``None``: the current CUDA card) and marks them as leaves
    that require grad.  ``step`` takes the gradients of :func:`loss_fn` and
    updates the params and the optimizer state IN PLACE under
    ``torch.no_grad()`` (it returns the same objects): this takes the place
    of the JAX step's buffer donation (``donated_train_step``), so one copy
    of the params and the moments lives on the card.  There is no mesh:
    one card (ROADMAP A6/A11 for more)."""
    return train_step_of(
        lambda gen, dev: init_params(cfg, generator=gen, device=dev),
        lambda params, tokens: loss_fn(params, tokens, cfg, attention=attention),
        optimizer, device)


def train_step_of(init_fn: Callable, loss: Callable,
                  optimizer: Optional[tuple[Callable, Callable]] = None,
                  device: DeviceLike = None):
    """The ``(init, step)`` pair of :func:`make_train_step` for any model:
    ``init_fn(generator, device)`` draws the params, ``loss(params,
    tokens)`` is the scalar the step differentiates."""
    opt_init, opt_update = optimizer or (optim.adamw_init, optim.adamw_update)
    dev = resolve_device(device)

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = init_fn(gen, dev)
        for p in optim.tree_leaves(params):
            p.requires_grad_(True)
        return params, opt_init(params)

    def step(params: Params, opt_state: dict, tokens: torch.Tensor):
        leaves = optim.tree_leaves(params)
        value = loss(params, tokens.to(dev))
        grads = torch.autograd.grad(value, leaves)
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
    *, device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preallocated page arenas for K and V: [L, num_pages, page_size, kvh, hd]."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
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
    one per layer."""
    t_buf = tokens.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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
        x = x + (attn.reshape(t_buf, 1, h * hd) @ layer["wo"])
        x = _mlp(x, layer, cfg)
    if not sample_logits:
        return torch.zeros((t_buf,), dtype=torch.int32, device=tokens.device), k_pages, v_pages
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0] @ params["lm_head"]  # [T, V]
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pages, v_pages
