"""Small helpers (the framework-free part of promp_tpu/utils/misc.py)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed, device="cpu"):
    """Seed python, numpy and torch, and return a ``torch.Generator`` on
    ``device`` seeded the same way for the caller to thread through."""
    seed = int(seed) % 4294967294
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator
