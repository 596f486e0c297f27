"""Discounted returns, GAE and advantage normalization (port of
promp_tpu/ops/discounting.py).

Batched over leading axes on fixed-shape (..., T) buffers, with episode
boundaries given by a ``reset`` indicator (1 at the last step of an
episode).
"""
from __future__ import annotations

import torch


def discount_cumsum(x, discount, reset=None):
    """Reverse discounted cumulative sum along the last axis:
    y_t = x_t + discount * (1 - reset_t) * y_{t+1}.

    Runs as a log2(T)-step scan over affine maps y -> a*y + b, the same
    composition the JAX package hands to ``lax.associative_scan``.
    """
    b = torch.flip(x, dims=(-1,))
    if reset is None:
        a = torch.full_like(b, discount)
    else:
        a = discount * (1.0 - torch.flip(reset.to(x.dtype), dims=(-1,)))
    n = b.shape[-1]
    shift = 1
    while shift < n:
        # compose each position with the one ``shift`` earlier: a prefix of
        # affine maps after log2(T) rounds; the offset is y at that position
        b = torch.cat([b[..., :shift], b[..., shift:] + a[..., shift:]
                       * b[..., :-shift]], dim=-1)
        a = torch.cat([a[..., :shift], a[..., shift:] * a[..., :-shift]],
                      dim=-1)
        shift *= 2
    return torch.flip(b, dims=(-1,))


def gae_advantages(rewards, baselines, discount, gae_lambda, reset=None):
    """GAE on (..., T) buffers: deltas = r + discount * V(s') - V(s), with
    V = 0 past the final step and across episode boundaries."""
    next_baselines = torch.cat(
        [baselines[..., 1:], torch.zeros_like(baselines[..., :1])], dim=-1)
    if reset is not None:
        next_baselines = next_baselines * (1.0 - reset.to(rewards.dtype))
    deltas = rewards + discount * next_baselines - baselines
    return discount_cumsum(deltas, discount * gae_lambda, reset=reset)


def normalize_advantages(advantages, mask=None):
    """Zero-mean unit-std normalization over the whole tensor (population
    std), over the entries where ``mask`` is 1 when it is given."""
    if mask is None:
        mean = torch.mean(advantages)
        std = torch.std(advantages, correction=0)
    else:
        mask = mask.to(advantages.dtype)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        mean = torch.sum(advantages * mask) / denom
        var = torch.sum(torch.square(advantages - mean) * mask) / denom
        std = torch.sqrt(var)
    return (advantages - mean) / (std + 1e-8)


def shift_advantages_to_positive(advantages):
    return (advantages - torch.min(advantages)) + 1e-8
