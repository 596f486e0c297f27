"""Ant meta-envs, a 3-D quadruped with its free root decomposed to 6 dofs
(port of promp_tpu/envs/mujoco/ant.py).

The engine holds the free root as 3 world slides and 3 intrinsic x-y-z
Euler hinges; observations re-assemble MuJoCo's qpos (position,
quaternion, hinges), and cfrc_ext is the engine's per-body contact wrench
clipped to +-1. The physics runs through ``Engine.step`` (K2 on the card).
Envs follow the port's batched protocol (envs/base.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from promp_tpu_torch.envs.base import register_env
from promp_tpu_torch.envs.mujoco.locomotion import (LocomotionEnv, _ctrl_sq,
                                                    _finite)
from promp_tpu_torch.envs.mujoco.rotations import quat_from_euler_xyz


def qpos_mj(q):
    """Engine coordinates (..., nv) -> MuJoCo's qpos (..., nv + 1):
    position, the root's quaternion from its Euler hinges, the hinges."""
    quat = quat_from_euler_xyz(q[..., 3], q[..., 4], q[..., 5])
    return torch.cat([q[..., :3], quat, q[..., 6:]], dim=-1)


def with_world_row(rows):
    """(..., nb, k) per-body rows -> (..., nb + 1, k) with a zero world row
    first, in the layout of MuJoCo's (nbody, k) arrays."""
    return torch.cat([rows.new_zeros(rows.shape[:-2] + (1, rows.shape[-1])),
                      rows], dim=-2)


@dataclass(frozen=True)
class AntBase(LocomotionEnv):
    """Reset noise qpos U(-.1, .1), qvel N(0, .1); frame_skip 5, 2
    substeps a frame."""

    model_name: str = "ant"
    frame_skip: int = 5
    n_substeps: int = 2
    qpos_noise: float = 0.1
    qvel_noise: float = 0.1
    stochastic_step: bool = False
    diagnostics_keys = ("reward_forward", "reward_ctrl")

    def _cfrc(self, state, task):
        """The contact wrench with the world row first, clipped to +-1."""
        wrench = self.engine.contact_wrench(state["q"], state["qd"],
                                            self._mods(task))
        return torch.clamp(with_world_row(wrench), -1.0, 1.0)

    def _torso_xy(self, state):
        return state["q"][..., :2]

    def _obs_dim(self):
        return (self.model.nv + 1) + self.model.nv + 6 * (self.model.nb + 1)

    def _qpos_obs(self, q):
        return qpos_mj(q)

    def _obs(self, state, task, cfrc=None):
        if cfrc is None:
            cfrc = self._cfrc(state, task)
        return torch.cat([self._qpos_obs(state["q"]), state["qd"],
                          cfrc.flatten(-2)], dim=-1)

    def _costs(self, state, action, task, ctrl_weight):
        """(cfrc, ctrl cost, contact cost) at the new state."""
        cfrc = self._cfrc(state, task)
        ctrl_cost = ctrl_weight * _ctrl_sq(action)
        contact_cost = 0.5 * 1e-3 * torch.sum(torch.square(cfrc),
                                              dim=(-2, -1))
        return cfrc, ctrl_cost, contact_cost


@register_env("AntRandGoalEnv")
@dataclass(frozen=True)
class AntRandGoalEnv(AntBase):
    """Goal in the disk r <= 3, drawn in polar coordinates; reward =
    -L1(torso_xy, goal) - 0.1 ||a||^2 - contact cost; obs = [qpos, qvel,
    clip(cfrc_ext)]; never done."""

    never_done: bool = True
    task_event_ndim = 1

    def sample_tasks(self, generator, n_tasks, device):
        a = torch.rand((n_tasks,), generator=generator,
                       device=device) * (2.0 * math.pi)
        r = 3.0 * torch.rand((n_tasks,), generator=generator,
                             device=device) ** 0.5
        return torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1)

    def step(self, state, action, task):
        state = self._advance(state, action, task)
        goal_reward = -torch.sum(torch.abs(self._torso_xy(state) - task),
                                 dim=-1)
        cfrc, ctrl_cost, contact_cost = self._costs(state, action, task, 0.1)
        reward = goal_reward - ctrl_cost - contact_cost
        info = dict(reward_forward=goal_reward, reward_ctrl=-ctrl_cost,
                    reward_contact=-contact_cost)
        done = torch.zeros(reward.shape, dtype=torch.bool,
                           device=reward.device)
        return state, self._obs(state, task, cfrc), reward, done, info

    def diagnostics(self, samples):
        """The mean over each path of reward_forward, with its Average /
        Max / Min / Std over paths, and the mean per-path ctrl cost."""
        out = super().diagnostics(samples)
        progs = torch.mean(samples["env_infos"]["reward_forward"], dim=-1)
        ctrl = torch.mean(-samples["env_infos"]["reward_ctrl"], dim=-1)
        out["AverageForwardReturn"] = torch.mean(progs)
        out["MaxForwardReturn"] = torch.max(progs)
        out["MinForwardReturn"] = torch.min(progs)
        out["StdForwardReturn"] = torch.std(progs, correction=0)
        out["AverageCtrlCost"] = torch.mean(ctrl)
        return out


@register_env("AntRandDirecEnv")
@dataclass(frozen=True)
class AntRandDirecEnv(AntBase):
    """Task in {-1, +1}; reward = dir * v_x - 0.5 ||a||^2 - contact cost +
    1 alive; obs = [qpos[2:], qvel, clip(cfrc_ext)]; done when the torso's
    z leaves [0, 1]."""

    z_range = (0.0, 1.0)

    def sample_tasks(self, generator, n_tasks, device):
        heads = torch.rand((n_tasks,), generator=generator, device=device)
        return torch.where(heads < 0.5, 1.0, -1.0)

    def _obs_dim(self):
        return (self.model.nv - 1) + self.model.nv + 6 * (self.model.nb + 1)

    def _qpos_obs(self, q):
        return qpos_mj(q)[..., 2:]

    def _position(self, state):
        return state["q"][..., 0]

    def _direction_reward(self, task, state, x_before):
        return task * (self._position(state) - x_before) / self.dt

    def step(self, state, action, task):
        x_before = self._position(state)
        state = self._advance(state, action, task)
        forward_reward = self._direction_reward(task, state, x_before)
        cfrc, ctrl_cost, contact_cost = self._costs(state, action, task, 0.5)
        survive_reward = torch.ones_like(forward_reward)
        reward = forward_reward - ctrl_cost - contact_cost + survive_reward
        z = state["q"][..., 2]
        lo, hi = self.z_range
        done = torch.logical_not(_finite(state) & (z >= lo) & (z <= hi))
        info = dict(reward_forward=forward_reward, reward_ctrl=-ctrl_cost,
                    reward_contact=-contact_cost,
                    reward_survive=survive_reward)
        return state, self._obs(state, task, cfrc), reward, done, info


@register_env("AntRandDirec2DEnv")
@dataclass(frozen=True)
class AntRandDirec2DEnv(AntRandDirecEnv):
    """Unit-vector direction tasks; the reward projects the torso's xy
    displacement onto the direction; done when z leaves [0.2, 1]."""

    z_range = (0.2, 1.0)
    task_event_ndim = 1

    def sample_tasks(self, generator, n_tasks, device):
        d = torch.randn((n_tasks, 2), generator=generator, device=device)
        return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    def _position(self, state):
        return self._torso_xy(state)

    def _direction_reward(self, task, state, xy_before):
        return torch.sum(task * (self._torso_xy(state) - xy_before),
                         dim=-1) / self.dt
