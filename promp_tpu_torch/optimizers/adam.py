"""Full-batch Adam for the MAML outer step (port of
promp_tpu/optimizers/adam.py).

TF1 conventions (lr 1e-3, beta1 0.9, beta2 0.999, eps 1e-8 outside the bias
correction). An update whose gradient holds a NaN or inf is skipped, all of
it, and counted in ``skipped`` (the SkippedUpdates metric), without a host
round trip: the choice is a ``torch.where`` on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


def tree_map(fn, *trees):
    """Map over the leaves of nested dicts and tuples of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        items = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class AdamState(NamedTuple):
    count: torch.Tensor    # int32 scalar
    mu: dict
    nu: dict
    skipped: torch.Tensor  # int32 scalar


@dataclass(frozen=True)
class Adam:
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        device = tree_leaves(params)[0].device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return AdamState(zero, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params), zero.clone())

    def update(self, grads, state, params):
        """Returns (new_params, new_state)."""
        count = state.count + 1
        b1, b2 = self.beta1, self.beta2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        c = count.to(tree_leaves(grads)[0].dtype)
        lr_t = self.learning_rate * torch.sqrt(1 - b2 ** c) / (1 - b1 ** c)
        new_params = tree_map(
            lambda p, m, v: p - lr_t * m / (torch.sqrt(v) + self.eps),
            params, mu, nu)
        finite = torch.stack([torch.isfinite(g).all()
                              for g in tree_leaves(grads)]).all()

        def keep(new, old):
            return tree_map(lambda n, o: torch.where(finite, n, o), new, old)

        return (keep(new_params, params),
                AdamState(torch.where(finite, count, state.count),
                          keep(mu, state.mu), keep(nu, state.nu),
                          state.skipped + (~finite).to(torch.int32)))
