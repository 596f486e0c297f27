"""Basic 2D point meta-envs (port of promp_tpu/envs/point/basic.py).

  * ``MetaPointEnv``: reward -||s||, done when |s_i| < 0.01, action +-0.1,
    reset ~ U(-2, 2)^2, tasks that carry nothing
  * ``MetaPointEnvV2``: goal tasks ~ U(-2, 2)^2, reward -||goal - s||,
    reset at the origin
  * ``MetaPointEnvCornerGoals``: MetaPointEnv's dynamics under its own name
  * ``MetaPointEnvMomentum``: a velocity-integrating point mass with corner
    goals, obs (pos, vel)

Every random call takes the env's ``torch.Generator`` and an optional
pre-drawn ``draw``, so that tests can hand the port the numbers the JAX
package drew: a reset's draw is the state it returns (Momentum's a dict
of pos and vel); ``sample_tasks``' draw is the tasks (V2) or the corners'
indices (Momentum). No step is stochastic.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from promp_tpu_torch.envs.base import Box, TaskEnv, register_env
from promp_tpu_torch.envs.point.corner import CORNERS, _norm


def _uniform(shape, low, high, generator, device):
    draw = torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return draw * (high - low) + low


def _never(new):
    return torch.zeros(new.shape[:-1], dtype=torch.bool, device=new.device)


def _at_origin(new):
    return (torch.abs(new[..., 0]) < 0.01) & (torch.abs(new[..., 1]) < 0.01)


@register_env("MetaPointEnv")
@dataclass(frozen=True)
class MetaPointEnv(TaskEnv):
    """Single-task point env: reward -||s||, done when |s_i| < 0.01."""

    stochastic_step: bool = False
    observation_space: Box = Box(-float("inf"), float("inf"), (2,))
    action_space: Box = Box(-0.1, 0.1, (2,))

    def sample_tasks(self, generator, n_tasks, device, draw=None):
        return torch.zeros((n_tasks, 0), device=device)

    def reset(self, task, generator, draw=None):
        if draw is None:
            draw = _uniform(task.shape[:-1] + (2,), -2.0, 2.0, generator,
                            task.device)
        return draw, draw

    def step(self, state, action, task):
        new = state + torch.clamp(action, -0.1, 0.1)
        reward = -torch.sqrt(new[..., 0] * new[..., 0]
                             + new[..., 1] * new[..., 1])
        return new, new, reward, _at_origin(new), {}


@register_env("MetaPointEnvV2")
@dataclass(frozen=True)
class MetaPointEnvV2(TaskEnv):
    """Goal tasks ~ U(-2, 2)^2; reward -||goal - s||; reset at origin."""

    stochastic_step: bool = False
    observation_space: Box = Box(-float("inf"), float("inf"), (2,))
    action_space: Box = Box(-0.1, 0.1, (2,))

    def sample_tasks(self, generator, n_tasks, device, draw=None):
        if draw is None:
            draw = _uniform((n_tasks, 2), -2.0, 2.0, generator, device)
        return draw

    def reset(self, task, generator, draw=None):
        state = torch.zeros(task.shape, dtype=torch.float32,
                            device=task.device)
        return state, state

    def step(self, state, action, task):
        new = state + torch.clamp(action, -0.1, 0.1)
        reward = -_norm(task - new)
        return new, new, reward, _at_origin(new), {}


@register_env("MetaPointEnvCornerGoals")
@dataclass(frozen=True)
class MetaPointEnvCornerGoals(MetaPointEnv):
    """MetaPointEnv's dynamics, registered under its own name."""


@register_env("MetaPointEnvMomentum")
@dataclass(frozen=True)
class MetaPointEnvMomentum(TaskEnv):
    """Velocity-integrating point mass with corner-goal tasks: obs (pos,
    vel) in R^4, the action (+-0.1) added to the velocity, sparse reward
    max(radius - ||goal - pos||, 0); reset pos ~ U(-0.2, 0.2)^2, vel ~
    U(-0.1, 0.1)^2."""

    reward_type: str = "sparse"
    sparse_reward_radius: float = 2.0
    never_done: bool = True
    stochastic_step: bool = False

    observation_space: Box = Box(-float("inf"), float("inf"), (4,))
    action_space: Box = Box(-0.1, 0.1, (2,))

    def sample_tasks(self, generator, n_tasks, device, draw=None):
        if draw is None:
            draw = torch.randint(0, 4, (n_tasks,), generator=generator,
                                 device=device)
        return torch.as_tensor(CORNERS, device=device)[draw]

    def reset(self, task, generator, draw=None):
        if draw is None:
            batch, device = task.shape[:-1] + (2,), task.device
            draw = {"pos": _uniform(batch, -0.2, 0.2, generator, device),
                    "vel": _uniform(batch, -0.1, 0.1, generator, device)}
        return draw, torch.cat([draw["pos"], draw["vel"]], -1)

    def step(self, state, action, task):
        vel = state["vel"] + torch.clamp(action, -0.1, 0.1)
        pos = state["pos"] + vel
        goal_distance = _norm(pos - task)
        if self.reward_type == "dense":
            reward = -goal_distance
        elif self.reward_type == "dense_squared":
            reward = -goal_distance * goal_distance
        else:
            reward = torch.clamp(self.sparse_reward_radius - goal_distance,
                                 min=0.0)
        obs = torch.cat([pos, vel], -1)
        return {"pos": pos, "vel": vel}, obs, reward, _never(pos), {}
