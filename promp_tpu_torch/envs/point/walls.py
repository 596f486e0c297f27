"""2D point env with circular walls and random gaps (port of
promp_tpu/envs/point/walls.py).

Corner goals and two circular walls, at radius 1 and 2, each with a random
gap; a step that crosses a wall away from its gap is pushed back onto the
wall. A task is {goal, gap_1, gap_2}. The sparse reward is the progress
toward the goal inside the radius, and 0 outside it.

``sample_tasks`` takes an optional pre-drawn ``draw``: (the corners'
indices, gap_1's and gap_2's standard-normal draws), as the JAX package
draws them; a reset's draw is the state it returns.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from promp_tpu_torch.envs.base import Box, TaskEnv, register_env
from promp_tpu_torch.envs.point.basic import _never, _uniform
from promp_tpu_torch.envs.point.corner import CORNERS, _norm


@register_env("MetaPointEnvWalls")
@dataclass(frozen=True)
class MetaPointEnvWalls(TaskEnv):
    reward_type: str = "dense"
    sparse_reward_radius: float = 2.0
    never_done: bool = True
    stochastic_step: bool = False

    observation_space: Box = Box(-float("inf"), float("inf"), (2,))
    action_space: Box = Box(-0.2, 0.2, (2,))

    def sample_tasks(self, generator, n_tasks, device, draw=None):
        if draw is None:
            draw = (torch.randint(0, 4, (n_tasks,), generator=generator,
                                  device=device),
                    torch.randn((n_tasks, 2), generator=generator,
                                device=device),
                    torch.randn((n_tasks, 2), generator=generator,
                                device=device))
        idx, gaps_1, gaps_2 = draw
        return {"goal": torch.as_tensor(CORNERS, device=device)[idx],
                "gap_1": gaps_1 / _norm(gaps_1)[:, None],
                "gap_2": gaps_2 / (_norm(gaps_2)[:, None] / 2.0)}

    def reset(self, task, generator, draw=None):
        if draw is None:
            goal = task["goal"]
            draw = _uniform(goal.shape, -0.2, 0.2, generator, goal.device)
        return draw, draw

    def step(self, state, action, task):
        prev = state
        new = prev + torch.clamp(action, -0.2, 0.2)
        reward = self._reward(prev, new, task)

        norm_prev = _norm(prev)
        norm_new = _norm(new)
        # wall 1 at radius 1: blocked unless within distance 1 of gap_1
        cross_1 = (norm_prev < 1.0) & (norm_new > 1.0)
        blocked_1 = _norm(new - task["gap_1"]) > 1.0
        pushed_1 = new / (norm_new + 1e-6)[..., None]
        new = torch.where((cross_1 & blocked_1)[..., None], pushed_1, new)
        # wall 2 at radius 2: blocked unless within distance 1 of gap_2
        norm_new = _norm(new)
        cross_2 = (norm_prev < 2.0) & (norm_new > 2.0) & ~cross_1
        blocked_2 = _norm(new - task["gap_2"]) > 1.0
        pushed_2 = new / (norm_new * 0.5 + 1e-6)[..., None]
        new = torch.where((cross_2 & blocked_2)[..., None], pushed_2, new)
        return new, new, reward, _never(new), {}

    def _reward(self, prev, new, task):
        goal = task["goal"]
        goal_distance = _norm(new - goal)
        if self.reward_type == "dense":
            return -goal_distance
        if self.reward_type == "dense_squared":
            return -goal_distance * goal_distance
        progress = _norm(prev - goal) - goal_distance
        return torch.where(goal_distance < self.sparse_reward_radius,
                           progress, torch.zeros_like(progress))
