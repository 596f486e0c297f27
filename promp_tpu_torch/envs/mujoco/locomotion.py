"""Locomotion meta-envs on the port's rigid-body engine (port of
promp_tpu/envs/mujoco/locomotion.py: the shared machinery and the
HalfCheetah envs).

Task distributions, rewards, observations and reset noise mirror the JAX
package line for line; the physics runs through ``Engine.step`` (K2 on the
card). Envs follow the port's batched protocol (envs/base.py): every
method works on any leading batch shape, and a task is a tensor with that
batch shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from promp_tpu_torch.envs.base import Box, TaskEnv, register_env
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

    def reset(self, task, generator, draw=None):
        """qpos = init_qpos + U(-qpos_noise, qpos_noise), qvel = N(0, 1) *
        qvel_noise. ``draw``, if given, is the pair (U draw, N(0, 1) draw)
        of (..., nv) tensors."""
        m = self.model
        shape = tuple(task.shape) + (m.nv,)
        kw = dict(dtype=torch.float32, device=task.device)
        if draw is None:
            u = torch.rand(shape, generator=generator, **kw)
            draw = (u * (2 * self.qpos_noise) - self.qpos_noise,
                    torch.randn(shape, generator=generator, **kw))
        qpos = torch.as_tensor(m.init_qpos, **kw) + draw[0]
        qvel = draw[1] * self.qvel_noise
        state = {"q": qpos, "qd": qvel}
        return state, self._obs(state, task)

    def _advance(self, state, action):
        q, qd = self.engine.step(state["q"], state["qd"], action,
                                 self.frame_skip)
        return {"q": q, "qd": qd}


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

    def _step(self, state, action):
        """(new state, forward velocity, control reward)."""
        x_before = state["q"][..., 0]
        state = self._advance(state, action)
        forward_vel = (state["q"][..., 0] - x_before) / self.dt
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
        state, forward_vel, reward_ctrl = self._step(state, action)
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
        state, forward_vel, reward_ctrl = self._step(state, action)
        reward_run = task * forward_vel
        reward = reward_ctrl + reward_run
        info = dict(reward_run=reward_run, reward_ctrl=reward_ctrl)
        return (state, self._obs(state, task), reward,
                self._done(forward_vel), info)
