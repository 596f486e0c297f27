"""Physics-randomizing meta-envs, the rand-params family (port of
promp_tpu/envs/mujoco/rand_params.py).

A task is a dict of per-parameter multipliers with the task axis in front:

  * body_mass     (n, nb)     x 1.5^U(-L, L)
  * body_inertia  (n, nb, 3)  x 1.5^U(-L, L)
  * dof_damping   (n, nv)     x 1.3^U(-L, L)
  * friction      (n,)        x 1.5^U(-L, L) (the ground friction)

with L = ``log_scale_limit`` (3.0). The multipliers reach the engine as
``mods``, so that every env of the (task, env) batch runs its own physics
in one launch of K3 (ops/substep_kernel.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from promp_tpu_torch.envs.base import register_env
from promp_tpu_torch.envs.mujoco.locomotion import (
    HopperEnv, LocomotionEnv, Walker2dBase, _ctrl_sq)
from promp_tpu_torch.envs.mujoco.spatial import MOD_BASE_NDIM

RAND_PARAMS = ("body_mass", "dof_damping", "body_inertia", "friction")


def sample_param_multipliers(generator, model, n_tasks, log_scale_limit,
                             rand_params=RAND_PARAMS, device=None):
    """The multiplier dict of ``n_tasks`` tasks, drawn from ``generator``
    in the JAX package's key order (mass, inertia, damping, friction)."""
    L = log_scale_limit

    def power(base, shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return base ** (u * (2 * L) - L)

    out = {}
    if "body_mass" in rand_params:
        out["body_mass"] = power(1.5, (n_tasks, model.nb))
    if "body_inertia" in rand_params:
        out["body_inertia"] = power(1.5, (n_tasks, model.nb, 3))
    if "dof_damping" in rand_params:
        out["dof_damping"] = power(1.3, (n_tasks, model.nv))
    if "friction" in rand_params:
        out["friction"] = power(1.5, (n_tasks,))
    return out


class RandParamsMixin:
    """Adds multiplier tasks and engine mods to a LocomotionEnv subclass."""

    @property
    def task_event_ndim(self):
        return {k: MOD_BASE_NDIM[k] for k in self.rand_params}

    def sample_tasks(self, generator, n_tasks, device):
        return sample_param_multipliers(generator, self.model, n_tasks,
                                        self.log_scale_limit,
                                        self.rand_params, device)

    def _mods(self, task):
        return task


@register_env("HopperRandParamsEnv")
@dataclass(frozen=True)
class HopperRandParamsEnv(RandParamsMixin, HopperEnv):
    """The hopper with random physics."""

    log_scale_limit: float = 3.0
    rand_params: Tuple[str, ...] = RAND_PARAMS


@register_env("WalkerRandParamsWrappedEnv")
@register_env("Walker2DRandParamsEnv")
@dataclass(frozen=True)
class Walker2DRandParamsEnv(RandParamsMixin, Walker2dBase):
    """The walker with random physics. Reward = v_x + 1 alive
    - 1e-3 ||a||^2 (gym walker semantics)."""

    log_scale_limit: float = 3.0
    rand_params: Tuple[str, ...] = RAND_PARAMS

    def step(self, state, action, task):
        state, forward_vel = self._forward(state, action, task)
        reward = forward_vel + 1.0 - 1e-3 * _ctrl_sq(action)
        return (state, self._obs(state, task), reward, self._done(state),
                dict(forward_vel=forward_vel))


@register_env("HalfCheetahRandParamsEnv")
@dataclass(frozen=True)
class HalfCheetahRandParamsEnv(RandParamsMixin, LocomotionEnv):
    """The cheetah with random physics; reward v_x - 0.05 ||a||^2; never
    done."""

    model_name: str = "half_cheetah"
    frame_skip: int = 5
    n_substeps: int = 1
    never_done: bool = True
    log_scale_limit: float = 3.0
    rand_params: Tuple[str, ...] = RAND_PARAMS

    def _obs_dim(self):
        return 2 * self.model.nv - 1

    def _obs(self, state, task=None):
        return torch.cat([state["q"][..., 1:], state["qd"]], dim=-1)

    def step(self, state, action, task):
        state, forward_vel = self._forward(state, action, task)
        reward = forward_vel - 0.5 * 0.1 * _ctrl_sq(action)
        return (state, self._obs(state, task), reward,
                torch.zeros(forward_vel.shape, dtype=torch.bool,
                            device=forward_vel.device),
                dict(forward_vel=forward_vel))
