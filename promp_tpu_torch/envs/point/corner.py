"""2D point mass with corner-goal tasks (port of
promp_tpu/envs/point/corner.py).

  * 4 corner goals (+-2, +-2) sampled uniformly
  * sparse reward = progress toward the goal, only outside an L1 radius of
    0.5 from the origin and only when the nearest corner is the goal;
    dense and dense_squared variants
  * actions clipped to +-0.2, episodes never terminate
  * reset state ~ U(-0.2, 0.2)^2
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from promp_tpu_torch.envs.base import Box, TaskEnv, register_env

CORNERS = np.array([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0], [2.0, 2.0]],
                   np.float32)


def _norm(x):
    """Euclidean norm over the last axis, as ``jnp.linalg.norm(.., axis=-1)``
    forms it: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


@register_env("MetaPointEnvCorner")
@dataclass(frozen=True)
class MetaPointEnvCorner(TaskEnv):
    reward_type: str = "sparse"
    sparse_reward_radius: float = 0.5
    never_done: bool = True
    stochastic_step: bool = False

    observation_space: Box = Box(-float("inf"), float("inf"), (2,))
    action_space: Box = Box(-0.2, 0.2, (2,))

    def sample_tasks(self, generator, n_tasks, device):
        idx = torch.randint(0, 4, (n_tasks,), generator=generator,
                            device=device)
        return torch.as_tensor(CORNERS, device=device)[idx]

    def reset(self, task, generator, draw=None):
        if draw is None:
            draw = torch.rand(task.shape, generator=generator,
                              dtype=task.dtype, device=task.device)
            draw = draw * 0.4 - 0.2
        return draw, draw

    def step(self, state, action, task):
        prev = state
        new = prev + torch.clamp(action, -0.2, 0.2)
        goal_distance = _norm(new - task)
        if self.reward_type == "dense":
            reward = -goal_distance
        elif self.reward_type == "dense_squared":
            reward = -goal_distance ** 2
        else:
            dist_from_start = torch.sum(torch.abs(new), dim=-1)
            corners = torch.as_tensor(CORNERS, dtype=new.dtype,
                                      device=new.device)
            corner_dists = _norm(new[..., None, :] - corners)
            # the goal distance takes the same norm form as corner_dists, so
            # the nearest-corner tie test at the goal corner is exact
            progress = _norm(prev - task) - goal_distance
            goal_is_nearest = goal_distance <= torch.amin(corner_dists, dim=-1)
            reward = torch.where(
                dist_from_start < self.sparse_reward_radius,
                torch.zeros_like(progress),
                torch.where(goal_is_nearest, progress,
                            torch.zeros_like(progress)))
        done = torch.zeros(new.shape[:-1], dtype=torch.bool, device=new.device)
        return new, new, reward, done, {}
