"""Locomotion meta-envs on the port's rigid-body engine (port of
promp_tpu/envs/mujoco/locomotion.py: the shared machinery, the HalfCheetah
and Walker2d envs and the Hopper base).

Task distributions, rewards, observations, reset noise and termination
rules mirror the JAX package line for line; the physics runs through
``Engine.step`` (K2 on the card, K3 where the task gives physics mods).
Envs follow the port's batched protocol (envs/base.py): every method works
on any leading batch shape, and a task carries that batch shape in front.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from promp_tpu_torch.envs.base import (Box, TaskEnv, register_env,
                                       task_batch_shape, task_leaf)
from promp_tpu_torch.envs.mujoco.engine import Engine
from promp_tpu_torch.envs.mujoco.model import get_model


@dataclass(frozen=True)
class LocomotionEnv(TaskEnv):
    """Shared machinery: engine construction, reset noise, stepping."""

    model_name: str = ""
    frame_skip: int = 5
    n_substeps: int = 1
    # reset noise (reference reset_model per env)
    qpos_noise: float = 0.1
    qvel_noise: float = 0.1
    qvel_noise_kind: str = "normal"  # | "uniform"
    stochastic_step: bool = False

    @cached_property
    def engine(self):
        return Engine(get_model(self.model_name), n_substeps=self.n_substeps)

    @property
    def model(self):
        return self.engine.model

    @property
    def dt(self):
        return self.model.timestep * self.frame_skip

    @cached_property
    def action_space(self):
        rng = self.model.act_ctrlrange
        return Box(float(rng[:, 0].min()), float(rng[:, 1].max()),
                   (self.model.nu,))

    @cached_property
    def observation_space(self):
        return Box(-np.inf, np.inf, (self._obs_dim(),))

    def _obs_dim(self):
        raise NotImplementedError

    def _mods(self, task):
        """Physics overrides derived from the task (rand-params envs)."""
        return None

    def reset(self, task, generator, draw=None):
        """qpos = init_qpos + U(-qpos_noise, qpos_noise); qvel = N(0, 1) *
        qvel_noise for ``qvel_noise_kind`` "normal", U(-qvel_noise,
        qvel_noise) for "uniform". ``draw``, if given, is the pair of
        (..., nv) tensors (the qpos noise, the qvel draw): the qvel draw is
        the N(0, 1) draw before its scaling for "normal", the qvel noise
        itself for "uniform"."""
        m = self.model
        shape = task_batch_shape(task, self.task_event_ndim) + (m.nv,)
        kw = dict(dtype=torch.float32, device=task_leaf(task).device)
        if draw is None:
            u = torch.rand(shape, generator=generator, **kw)
            qpos_draw = u * (2 * self.qpos_noise) - self.qpos_noise
            if self.qvel_noise_kind == "normal":
                qvel_draw = torch.randn(shape, generator=generator, **kw)
            else:
                u = torch.rand(shape, generator=generator, **kw)
                qvel_draw = u * (2 * self.qvel_noise) - self.qvel_noise
            draw = (qpos_draw, qvel_draw)
        qpos = torch.as_tensor(m.init_qpos, **kw) + draw[0]
        qvel = (draw[1] * self.qvel_noise if self.qvel_noise_kind == "normal"
                else draw[1])
        state = {"q": qpos, "qd": qvel}
        return state, self._obs(state, task)

    def _advance(self, state, action, task):
        q, qd = self.engine.step(state["q"], state["qd"], action,
                                 self.frame_skip, self._mods(task))
        return {"q": q, "qd": qd}

    def _forward(self, state, action, task):
        """(new state, forward velocity of the root's x)."""
        x_before = state["q"][..., 0]
        state = self._advance(state, action, task)
        return state, (state["q"][..., 0] - x_before) / self.dt


# --------------------------------------------------------------- HalfCheetah
@dataclass(frozen=True)
class HalfCheetahBase(LocomotionEnv):
    """Obs = [qpos[1:], qvel]; reset noise qpos U(-.1,.1), qvel N(0,.1);
    frame_skip 5; never done."""

    model_name: str = "half_cheetah"
    frame_skip: int = 5
    n_substeps: int = 1
    never_done: bool = True
    diagnostics_keys = ("forward_vel", "reward_run", "reward_ctrl")

    def _obs_dim(self):
        return 2 * self.model.nv - 1

    def _obs(self, state, task=None):
        return torch.cat([state["q"][..., 1:], state["qd"]], dim=-1)

    def _step(self, state, action, task):
        """(new state, forward velocity, control reward)."""
        state, forward_vel = self._forward(state, action, task)
        reward_ctrl = -0.5 * 0.1 * torch.sum(torch.square(action), dim=-1)
        return state, forward_vel, reward_ctrl

    def _done(self, forward_vel):
        return torch.zeros(forward_vel.shape, dtype=torch.bool,
                           device=forward_vel.device)


@register_env("HalfCheetahRandVelEnv")
@dataclass(frozen=True)
class HalfCheetahRandVelEnv(HalfCheetahBase):
    """Task = goal velocity ~ U(0, 3); reward = -|v_x - v*| - 0.05 ||a||^2."""

    def sample_tasks(self, generator, n_tasks, device):
        return torch.rand((n_tasks,), generator=generator, device=device) * 3.0

    def step(self, state, action, task):
        state, forward_vel, reward_ctrl = self._step(state, action, task)
        reward_run = -torch.abs(forward_vel - task)
        reward = reward_ctrl + reward_run
        info = dict(forward_vel=forward_vel, reward_run=reward_run,
                    reward_ctrl=reward_ctrl)
        return (state, self._obs(state, task), reward,
                self._done(forward_vel), info)

    def diagnostics(self, samples):
        """The JAX env's diagnostics, including its reference's quirk of
        logging the STD of the control cost as 'AvgCtrlCost'."""
        out = super().diagnostics(samples)
        vel = samples["env_infos"]["forward_vel"]       # (tasks, envs, T)
        ctrl = -samples["env_infos"]["reward_ctrl"]
        out["AvgForwardVel"] = torch.mean(vel)
        out["AvgFinalForwardVel"] = torch.mean(vel[..., -1])
        out["AvgCtrlCost"] = torch.std(ctrl, correction=0)
        return out


@register_env("HalfCheetahRandDirecEnv")
@dataclass(frozen=True)
class HalfCheetahRandDirecEnv(HalfCheetahBase):
    """Task in {-1, +1}; reward = dir * v_x - ctrl cost."""

    def sample_tasks(self, generator, n_tasks, device):
        heads = torch.rand((n_tasks,), generator=generator, device=device)
        return torch.where(heads < 0.5, 1.0, -1.0)

    def step(self, state, action, task):
        state, forward_vel, reward_ctrl = self._step(state, action, task)
        reward_run = task * forward_vel
        reward = reward_ctrl + reward_run
        info = dict(reward_run=reward_run, reward_ctrl=reward_ctrl)
        return (state, self._obs(state, task), reward,
                self._done(forward_vel), info)


# ------------------------------------------------------------------ Walker2d
def _ctrl_sq(action):
    return torch.sum(torch.square(action), dim=-1)


@dataclass(frozen=True)
class Walker2dBase(LocomotionEnv):
    """Obs = [qpos[1:], clip(qvel, +-10)]; reset noise U(-.005, .005) on
    both; frame_skip 8; done when the height or the torso angle leave
    (0.8, 2.0) x (-1, 1)."""

    model_name: str = "walker2d"
    frame_skip: int = 8
    qpos_noise: float = 0.005
    qvel_noise: float = 0.005
    qvel_noise_kind: str = "uniform"

    def _obs_dim(self):
        return 2 * self.model.nv - 1

    def _obs(self, state, task=None):
        return torch.cat([state["q"][..., 1:],
                          torch.clamp(state["qd"], -10.0, 10.0)], dim=-1)

    def _done(self, state):
        height, ang = state["q"][..., 1], state["q"][..., 2]
        healthy = ((height > 0.8) & (height < 2.0)
                   & (ang > -1.0) & (ang < 1.0))
        return torch.logical_not(healthy)


@register_env("Walker2DRandVelEnv")
@dataclass(frozen=True)
class Walker2DRandVelEnv(Walker2dBase):
    """Task vel ~ U(0, 10); reward = -|v - v*| + 15 alive - 1e-3 ||a||^2."""

    def sample_tasks(self, generator, n_tasks, device):
        return torch.rand((n_tasks,), generator=generator,
                          device=device) * 10.0

    def step(self, state, action, task):
        state, forward_vel = self._forward(state, action, task)
        reward = (-torch.abs(forward_vel - task) + 15.0
                  - 1e-3 * _ctrl_sq(action))
        return (state, self._obs(state, task), reward, self._done(state),
                dict(forward_vel=forward_vel))


@register_env("Walker2DRandDirecEnv")
@dataclass(frozen=True)
class Walker2DRandDirecEnv(Walker2dBase):
    """Task in {-1, +1}; reward = dir * v + 1 alive - 1e-3 ||a||^2."""

    def sample_tasks(self, generator, n_tasks, device):
        heads = torch.rand((n_tasks,), generator=generator, device=device)
        return torch.where(heads < 0.5, 1.0, -1.0)

    def step(self, state, action, task):
        state, forward_vel = self._forward(state, action, task)
        reward = task * forward_vel + 1.0 - 1e-3 * _ctrl_sq(action)
        return (state, self._obs(state, task), reward, self._done(state),
                dict(forward_vel=forward_vel))


# -------------------------------------------------------------------- Hopper
@register_env("HopperEnv")
@dataclass(frozen=True)
class HopperEnv(LocomotionEnv):
    """Hopper base (gym semantics), the base of HopperRandParamsEnv. Tasks
    are empty, (n, 0); reward = v_x + 1 alive - 1e-3 ||a||^2; done outside
    height > 0.7, |angle| < 0.2 and |qpos[2:]| < 100."""

    model_name: str = "hopper"
    frame_skip: int = 4
    qpos_noise: float = 0.005
    qvel_noise: float = 0.005
    qvel_noise_kind: str = "uniform"
    task_event_ndim = 1

    def sample_tasks(self, generator, n_tasks, device):
        return torch.zeros((n_tasks, 0), device=device)

    def _obs_dim(self):
        return 2 * self.model.nv - 1

    def _obs(self, state, task=None):
        return torch.cat([state["q"][..., 1:],
                          torch.clamp(state["qd"], -10.0, 10.0)], dim=-1)

    def step(self, state, action, task):
        state, forward_vel = self._forward(state, action, task)
        reward = forward_vel + 1.0 - 1e-3 * _ctrl_sq(action)
        height, ang = state["q"][..., 1], state["q"][..., 2]
        s = state["q"][..., 2:]
        healthy = ((height > 0.7) & (torch.abs(ang) < 0.2)
                   & torch.all(torch.abs(s) < 100.0, dim=-1))
        return (state, self._obs(state, task), reward,
                torch.logical_not(healthy), dict(forward_vel=forward_vel))
