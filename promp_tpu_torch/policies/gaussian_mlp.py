"""Functional diagonal-Gaussian MLP policy (port of
promp_tpu/policies/gaussian_mlp.py).

Parameters live in a plain ``dict[str, Tensor]`` under the JAX package's
names and shapes (``mean_network/hidden_%d/{kernel,bias}`` with kernels of
shape (in, out), ``mean_network/output/...``, ``log_std_network/log_std_var``
of shape (1, action_dim)), so a parameter dict crosses between the two
packages through numpy (``promp_tpu_torch.weights``). ``apply`` is a pure
function of (params, obs): ``torch.func.grad`` and ``torch.func.vmap`` run
through it for the per-task inner step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

NONLINEARITIES = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "elu": torch.nn.functional.elu,
    "identity": lambda x: x,
    None: lambda x: x,
}


@dataclass(frozen=True)
class GaussianMLPPolicy:
    """Static policy configuration; defaults mirror the JAX package."""

    obs_dim: int
    action_dim: int
    hidden_sizes: Tuple[int, ...] = (64, 64)
    learn_std: bool = True
    init_std: float = 1.0
    min_std: float = 1e-6
    hidden_nonlinearity: str = "tanh"
    output_nonlinearity: Optional[str] = None

    @property
    def min_log_std(self):
        return math.log(self.min_std)

    @property
    def init_log_std(self):
        return math.log(self.init_std)

    def init(self, generator, device, dtype=torch.float32):
        """Xavier (glorot-uniform) kernels, zero biases, constant log_std,
        in ``dtype``."""
        sizes = (self.obs_dim,) + tuple(self.hidden_sizes) + (self.action_dim,)
        n_layers = len(sizes) - 1
        params = {}
        for i in range(n_layers):
            name = "output" if i == n_layers - 1 else f"hidden_{i}"
            limit = math.sqrt(6.0 / (sizes[i] + sizes[i + 1]))
            kernel = torch.empty((sizes[i], sizes[i + 1]), dtype=dtype,
                                 device=device)
            kernel.uniform_(-limit, limit, generator=generator)
            params[f"mean_network/{name}/kernel"] = kernel
            params[f"mean_network/{name}/bias"] = torch.zeros(
                (sizes[i + 1],), dtype=dtype, device=device)
        params["log_std_network/log_std_var"] = torch.full(
            (1, self.action_dim), self.init_log_std, dtype=dtype,
            device=device)
        return params

    def apply(self, params, obs, floor_std=True):
        """Forward pass -> {"mean", "log_std"}.

        ``floor_std=True`` applies the min-log-std floor (the pre-update
        variable read path); adapted parameters use the raw value.
        """
        x = obs
        hidden_fn = NONLINEARITIES[self.hidden_nonlinearity]
        out_fn = NONLINEARITIES[self.output_nonlinearity]
        for i in range(len(self.hidden_sizes)):
            x = hidden_fn(x @ params[f"mean_network/hidden_{i}/kernel"]
                          + params[f"mean_network/hidden_{i}/bias"])
        mean = out_fn(x @ params["mean_network/output/kernel"]
                      + params["mean_network/output/bias"])
        log_std = params["log_std_network/log_std_var"][0]
        if floor_std:
            log_std = torch.clamp(log_std, min=self.min_log_std)
        return {"mean": mean, "log_std": log_std.expand(mean.shape)}

    def trainable_keys(self, params):
        """Keys updated by inner/outer optimization (log_std only when
        ``learn_std``)."""
        keys = list(params.keys())
        if not self.learn_std:
            keys = [k for k in keys if not k.startswith("log_std_network")]
        return keys

    def replicate(self, params, n_tasks):
        """Tile params with a leading task axis (a broadcast view)."""
        return {k: p.expand((n_tasks,) + p.shape) for k, p in params.items()}


def flatten_params(params):
    """Concatenate a params dict into one flat vector, with the spec that
    ``unflatten_params`` needs. Keys are taken in sorted order, as
    ``jax.tree.flatten`` orders a dict."""
    keys = sorted(params)
    flat = torch.cat([params[k].reshape(-1) for k in keys])
    return flat, (keys, [tuple(params[k].shape) for k in keys])


def unflatten_params(flat, spec):
    keys, shapes = spec
    out, idx = {}, 0
    for k, shape in zip(keys, shapes):
        size = math.prod(shape)
        out[k] = flat[idx:idx + size].reshape(shape)
        idx += size
    return out
