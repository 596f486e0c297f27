"""Parameter dicts across the numpy boundary.

A policy's parameters are a ``dict[str, Tensor]`` under the JAX package's
names and shapes, so the JAX policy's parameters load into the port (and
back) through numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def from_numpy_params(params, device):
    """dict[str, np.ndarray] -> dict[str, float32 Tensor] on ``device``;
    nested dicts are converted recursively."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = from_numpy_params(v, device)
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return out


def to_numpy_params(params):
    """Inverse of ``from_numpy_params``."""
    return {k: to_numpy_params(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
