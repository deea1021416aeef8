"""AdamW with optax's defaults and its order of operations, in plain torch,
and the parameter-tree helpers the train step and the checkpoint share.

Counterpart of `optax.adamw(learning_rate)` (optax 0.2.6) as
`picha_tpu/models/vit.py::make_train_step` (:243-260) uses it: the chain
`scale_by_adam` -> `add_decayed_weights` -> `scale_by_learning_rate`, then
`apply_updates`. Per leaf, in f32:

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    count += 1                                  (int32, saturating)
    u  = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count) + eps_root) + eps)
    u  = u + weight_decay * p
    p  = p + (-learning_rate) * u

The decay reaches every leaf, LayerNorm scales and biases and `pos_embed`
included (the reference's `mask=None`). The defaults are optax's
(weight_decay 1e-4), not `torch.optim.AdamW`'s. `count` is a 0-d int32
tensor kept on the host, so the bias corrections are host scalars computed
in float32 as JAX computes them (`pow` in f32, then `1 -`), and the
divisions by them are IEEE divisions by a tensor on the leaves' device.
The optimizer is plain jnp in the reference, not a kernel; the elementwise
passes go through `torch._foreach_*` to cut launches.

The state is `AdamWState(count, mu, nu)`, whose leaves in tree order
(`tree_leaves`: dict keys sorted, lists in order, None skipped) are
optax's: count, every mu leaf, every nu leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's order:
    dict keys sorted, sequences in order, None holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """`template`'s structure with its leaves replaced, in `tree_leaves`
    order, by `leaves`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


class AdamWState(NamedTuple):
    count: torch.Tensor      # 0-d int32, on the host
    mu: Any
    nu: Any


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _bias_correction(decay: float, count: int) -> np.float32:
    """1 - decay**count in float32, as optax computes it under JAX."""
    return np.float32(1.0) - np.float32(decay) ** np.float32(count)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """`(init, update)`: `init(params) -> AdamWState`;
    `update(grads, state, params) -> (updates, state)`, the updates to
    add with `apply_updates` (see the module doc)."""

    def init(params):
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_unflatten(params, zeros),
                          tree_unflatten(params, [z.clone() for z in zeros]))

    def update(grads, state, params):
        g, p = tree_leaves(grads), tree_leaves(params)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul(tree_leaves(state.mu), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(tree_leaves(state.nu), b2))
        n = min(int(state.count) + 1, INT32_MAX)
        count = torch.tensor(n, dtype=torch.int32)
        u = []
        if g:
            dev = g[0].device
            c1, c2 = (torch.tensor(float(_bias_correction(b, n)),
                                   dtype=torch.float32, device=dev)
                      for b in (b1, b2))
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
                [v / c2 for v in nu], eps_root)), eps)
            u = torch._foreach_div([m / c1 for m in mu], den)
            u = torch._foreach_add(u, torch._foreach_mul(p, weight_decay))
            u = torch._foreach_mul(u, -learning_rate)
        return (tree_unflatten(params, u),
                AdamWState(count, tree_unflatten(params, mu),
                           tree_unflatten(params, nu)))

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))
