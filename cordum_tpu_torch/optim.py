"""AdamW on plain tensors: the port's counterpart of the optimizer the JAX
package takes from optax, ``optax.adamw(3e-4, weight_decay=0.01)``.

It follows optax 0.2.6 step for step (``scale_by_adam`` with b1 0.9, b2
0.999, eps 1e-8, eps_root 0; then ``add_decayed_weights`` on every leaf,
norms and the embedding included; then ``scale_by_learning_rate``), so the
same gradients give the same moments and params:

  * ``mu = (1 - b1) g + b1 mu``; ``nu = (1 - b2) g^2 + b2 nu``;
  * ``count += 1`` (int32, held at its largest value);
  * ``mu_hat = mu / (1 - b1^count)``, ``nu_hat = nu / (1 - b2^count)``, the
    corrections computed in fp32 and cast to the leaf's dtype;
  * ``u = mu_hat / (sqrt(nu_hat) + eps) + wd p``; ``p = p + (-lr) u``.

``mu`` and ``nu`` keep each param's dtype (optax's ``mu_dtype=None``).  Not
``torch.optim.AdamW``: its decoupled decay is applied to the param before
the Adam step, which rounds in another order.

A param tree is what the models use: dicts (keys in sorted order) and lists
of tensors.  The state is ``{"count", "mu", "nu"}`` with ``mu`` and ``nu``
trees of the params' shape.  :func:`adamw_update` works in place.

:func:`adamw` builds the ``(init, update)`` pair a train step takes for
another weight decay: the pipeline family's is optax's default
``optax.adamw(3e-4)``, whose ``weight_decay`` is 1e-4
(:data:`OPTAX_WEIGHT_DECAY`), where the Llama and MoE families pass 0.01.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

# optax.adamw(3e-4, weight_decay=0.01) with its defaults
LEARNING_RATE = 3e-4
B1, B2 = 0.9, 0.999
EPS = 1e-8
WEIGHT_DECAY = 0.01
#: optax.adamw's own default weight decay (the pipeline family's optimizer)
OPTAX_WEIGHT_DECAY = 1e-4
_COUNT_MAX = 2**31 - 1


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order (dict keys
    sorted): the flattening the train step and the optimizer share."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [x for item in tree for x in tree_leaves(item)]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of a tree of dicts and lists, in the
    tree's own structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def adamw_init(params: Any) -> dict:
    """A fresh state: ``count`` 0 (int32, on the params' device) and zero
    moments in each param's dtype."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
    }


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` in fp32 (optax computes it in fp32 and casts
    to the moment's dtype only for the division)."""
    base = torch.tensor(decay, dtype=torch.float32, device=count.device)
    return 1 - torch.pow(base, count.to(torch.float32))


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, *,
                 weight_decay: float = WEIGHT_DECAY) -> None:
    """One AdamW step, in place on ``params`` and ``state``.  ``grads`` is a
    dict tree of the params' shape, or a list of its leaves in
    :func:`tree_leaves` order (what ``torch.autograd.grad`` returns)."""
    p_leaves = tree_leaves(params)
    g_leaves: Sequence[torch.Tensor] = (
        list(grads) if isinstance(grads, (list, tuple)) else tree_leaves(grads))
    mu_leaves, nu_leaves = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    if not len(g_leaves) == len(p_leaves) == len(mu_leaves) == len(nu_leaves):
        raise ValueError("grads, params and the optimizer state differ in structure")
    count = state["count"]
    count.copy_(torch.where(count < _COUNT_MAX, count + 1, count))
    bc1 = _bias_correction(B1, count)
    bc2 = _bias_correction(B2, count)
    for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
        mu.copy_((1 - B1) * g + B1 * mu)
        nu.copy_((1 - B2) * (g * g) + B2 * nu)
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)  # eps_root is 0
        u = u + weight_decay * p
        p.add_((-LEARNING_RATE) * u)


def adamw(weight_decay: float = WEIGHT_DECAY) -> tuple[Callable[[Any], dict], Callable[..., None]]:
    """The ``(init, update)`` pair of ``optax.adamw(3e-4,
    weight_decay=weight_decay)``: :func:`adamw_init` and
    :func:`adamw_update` with that decay."""
    return adamw_init, functools.partial(adamw_update, weight_decay=weight_decay)
