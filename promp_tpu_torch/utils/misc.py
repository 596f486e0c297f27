"""Small helpers (the framework-free part of promp_tpu/utils/misc.py)."""
from __future__ import annotations

import random

import numpy as np
import torch


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
