"""Diagonal Gaussian distribution ops (port of promp_tpu/ops/distributions.py).

All functions take ``dist_info`` dicts ``{"mean": (..., d), "log_std":
(..., d)}`` and broadcast over leading batch axes. Numerics follow the JAX
package op for op, including the ``1e-8`` in the KL denominator.
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def kl(old, new):
    """KL(old || new) for diagonal Gaussians, summed over the event axis."""
    old_means, old_log_stds = old["mean"], old["log_std"]
    new_means, new_log_stds = new["mean"], new["log_std"]
    old_std = torch.exp(old_log_stds)
    new_std = torch.exp(new_log_stds)
    numerator = (torch.square(old_means - new_means) + torch.square(old_std)
                 - torch.square(new_std))
    denominator = 2.0 * torch.square(new_std) + 1e-8
    return torch.sum(numerator / denominator + new_log_stds - old_log_stds,
                     dim=-1)


def log_likelihood(x, dist_info):
    """log p(x) under the diagonal Gaussian."""
    means, log_stds = dist_info["mean"], dist_info["log_std"]
    dim = x.shape[-1]
    zs = (x - means) / torch.exp(log_stds)
    return (-torch.sum(log_stds, dim=-1)
            - 0.5 * torch.sum(torch.square(zs), dim=-1)
            - 0.5 * dim * LOG_2PI)


def likelihood_ratio(x, old, new):
    """exp(log p_new(x) - log p_old(x))."""
    return torch.exp(log_likelihood(x, new) - log_likelihood(x, old))


def entropy(dist_info):
    """Differential entropy."""
    log_stds = dist_info["log_std"]
    return torch.sum(log_stds + 0.5 * math.log(2.0 * math.pi * math.e),
                     dim=-1)


def sample(generator, dist_info, noise=None):
    """mean + noise * exp(log_std); ``noise`` (same shape as the mean) may
    be given pre-drawn, else it is drawn from ``generator``."""
    means, log_stds = dist_info["mean"], dist_info["log_std"]
    if noise is None:
        noise = torch.randn(means.shape, generator=generator,
                            dtype=means.dtype, device=means.device)
    return means + noise * torch.exp(log_stds)
