"""Meta-environment protocol (port of promp_tpu/envs/base.py).

An environment is a frozen config dataclass with pure methods over
explicit, batched state. Every method works on any leading batch shape;
``task`` carries that batch shape in front of its own trailing axis:

    sample_tasks(generator, n, device)      -> (n, ...) task tensor
    reset(task, generator, draw=None)       -> (state, obs)
    step(state, action, task)               -> (state, obs, reward, done, info)

``draw`` is the reset's random draw given pre-drawn (the port's stand-in
for the JAX package's per-env PRNG keys), so that tests can feed the port
the draws that JAX made.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

ENV_REGISTRY: Dict[str, Any] = {}


def register_env(name):
    def deco(cls):
        ENV_REGISTRY[name] = cls
        return cls
    return deco


def make_env(name, **kwargs):
    if name not in ENV_REGISTRY:
        raise KeyError(f"Unknown env '{name}'. Known: {sorted(ENV_REGISTRY)}")
    return ENV_REGISTRY[name](**kwargs)


@dataclass(frozen=True)
class Box:
    """Minimal bounds descriptor."""
    low: float
    high: float
    shape: Tuple[int, ...]

    @property
    def dim(self):
        return math.prod(self.shape)

    def low_array(self, device=None):
        return torch.full(self.shape, self.low, dtype=torch.float32,
                          device=device)

    def high_array(self, device=None):
        return torch.full(self.shape, self.high, dtype=torch.float32,
                          device=device)


class TaskEnv:
    """Duck-typed protocol; concrete envs are frozen dataclasses.

    Optional attributes: ``diagnostics_keys`` (info keys averaged per
    round), ``never_done`` (episodes end only at the horizon, so the
    rollout skips its auto-reset branch), ``stochastic_step``.
    """

    diagnostics_keys: Tuple[str, ...] = ()
    never_done: bool = False
    stochastic_step: bool = False

    def reset_carry(self, prev_state, task, generator, draw=None):
        """Reset for in-loop auto-resets, given the terminated episode's
        final state; wrappers with running statistics carry them over."""
        return self.reset(task, generator, draw)

    def diagnostics(self, samples):
        """Mean of each ``diagnostics_keys`` env_info, as ``Env-<key>``."""
        infos = samples.get("env_infos", {})
        return {f"Env-{k}": torch.mean(infos[k])
                for k in self.diagnostics_keys if k in infos}

    @property
    def obs_dim(self):
        return self.observation_space.dim

    @property
    def action_dim(self):
        return self.action_space.dim
