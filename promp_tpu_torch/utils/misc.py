"""Small helpers (the port's copy of promp_tpu/utils/misc.py).

  - ``extract``                 values of keys from a dict or a list of dicts
  - ``explained_variance_1d``   1 - Var[y - ypred] / Var[y]
  - ``concat_tensor_dict_list`` concatenate nested dicts of arrays on axis 0
  - ``stack_tensor_dict_list``  stack nested dicts of arrays on a new axis 0
  - ``resolve_device``, ``set_seed``

The tensor-dict helpers take numpy arrays or torch tensors (all of one
kind) and return the same kind.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def extract(x, *keys):
    """dict -> tuple of its values at ``keys``; list of dicts -> tuple of
    lists, one per key."""
    if isinstance(x, dict):
        return tuple(x[k] for k in keys)
    if isinstance(x, (list, tuple)):
        return tuple([xi[k] for xi in x] for k in keys)
    raise NotImplementedError(f"extract: unsupported container {type(x)}")


def explained_variance_1d(ypred, y):
    """Fraction of y's variance that ypred explains, computed in float64:
    1 - Var[y - ypred] / (Var[y] + 1e-8). When Var[y] is 0 it is 1 for a
    constant prediction and 0 otherwise."""
    def flat(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64).ravel()

    ypred, y = flat(ypred), flat(y)
    assert y.shape == ypred.shape
    vary = np.var(y)
    if np.isclose(vary, 0):
        return 0.0 if np.var(ypred) > 0 else 1.0
    return float(1.0 - np.var(y - ypred) / (vary + 1e-8))


def _combine(tensor_dict_list, join):
    out = {}
    for k, example in tensor_dict_list[0].items():
        values = [d[k] for d in tensor_dict_list]
        out[k] = (_combine(values, join) if isinstance(example, dict)
                  else join(values))
    return out


def concat_tensor_dict_list(tensor_dict_list):
    """Concatenate a list of (possibly nested) dicts of arrays on axis 0."""
    return _combine(tensor_dict_list, lambda vs: torch.cat(vs, 0)
                    if isinstance(vs[0], torch.Tensor)
                    else np.concatenate(vs, axis=0))


def stack_tensor_dict_list(tensor_dict_list):
    """Stack a list of (possibly nested) dicts of arrays on a new axis 0."""
    return _combine(tensor_dict_list, lambda vs: torch.stack(vs, 0)
                    if isinstance(vs[0], torch.Tensor)
                    else np.stack(vs, axis=0))


def resolve_device(device):
    """``torch.device(device)``; raises if it names CUDA and there is no
    card. The port never falls back to the CPU on its own: a CPU run is
    asked for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "promp_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


def set_seed(seed, device="cuda"):
    """Seed python, numpy and torch, and return a ``torch.Generator`` on
    ``device`` (the card unless the caller asks for the CPU) seeded the
    same way for the caller to thread through."""
    device = resolve_device(device)
    seed = int(seed) % 4294967294
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator
