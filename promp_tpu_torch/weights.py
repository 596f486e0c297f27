"""Parameter dicts across the numpy boundary.

A policy's parameters are a ``dict[str, Tensor]`` under the JAX package's
names and shapes, so the JAX policy's parameters load into the port (and
back) through numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def from_numpy_params(params, device):
    """dict[str, np.ndarray] -> dict[str, Tensor] on ``device``: a float64
    array stays float64 (the float64 mode, as JAX params under
    ``jax.enable_x64``), anything else becomes float32; nested dicts are
    converted recursively."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = from_numpy_params(v, device)
        else:
            v = np.asarray(v)
            dtype = np.float64 if v.dtype == np.float64 else np.float32
            out[k] = torch.from_numpy(np.array(v, dtype)).to(device)
    return out


def to_numpy_params(params):
    """Inverse of ``from_numpy_params``."""
    return {k: to_numpy_params(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
