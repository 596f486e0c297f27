"""Normalizing env wrapper (port of promp_tpu/envs/normalized.py).

  * the policy acts in +-normalization_scale (=10); actions are affinely
    rescaled to the wrapped env's bounds and clipped
  * optional EMA (alpha=0.001) normalization of observations and rewards,
    with the statistics kept in the env state per env instance
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from promp_tpu_torch.envs.base import Box, TaskEnv


@dataclass(frozen=True)
class NormalizedEnv(TaskEnv):
    env: Any = None
    scale_reward: float = 1.0
    normalize_obs: bool = False
    normalize_reward: bool = False
    obs_alpha: float = 0.001
    reward_alpha: float = 0.001
    normalization_scale: float = 10.0

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return Box(-self.normalization_scale, self.normalization_scale,
                   self.env.action_space.shape)

    @property
    def diagnostics_keys(self):
        return self.env.diagnostics_keys

    def diagnostics(self, samples):
        return self.env.diagnostics(samples)

    @property
    def task_event_ndim(self):
        return self.env.task_event_ndim

    @property
    def never_done(self):
        return getattr(self.env, "never_done", False)

    @property
    def stochastic_step(self):
        return getattr(self.env, "stochastic_step", True)

    @property
    def _stats(self):
        return self.normalize_obs or self.normalize_reward

    def sample_tasks(self, generator, n_tasks, device):
        return self.env.sample_tasks(generator, n_tasks, device)

    def _wrap_state(self, inner_state, batch_shape, device):
        if not self._stats:
            return inner_state
        obs_shape = tuple(batch_shape) + tuple(
            self.env.observation_space.shape)
        return {
            "inner": inner_state,
            "obs_mean": torch.zeros(obs_shape, device=device),
            "obs_var": torch.ones(obs_shape, device=device),
            "rew_mean": torch.zeros(batch_shape, device=device),
            "rew_var": torch.ones(batch_shape, device=device),
        }

    def reset(self, task, generator, draw=None):
        inner_state, obs = self.env.reset(task, generator, draw)
        state = self._wrap_state(inner_state, obs.shape[:-1], obs.device)
        if self.normalize_obs:
            state, obs = self._norm_obs(state, obs)
        return state, obs

    def reset_carry(self, prev_state, task, generator, draw=None):
        """Auto-reset that keeps the running statistics across episodes."""
        if not self._stats:
            return self.reset(task, generator, draw)
        inner_state, obs = self.env.reset_carry(prev_state["inner"], task,
                                                generator, draw)
        state = dict(prev_state, inner=inner_state)
        if self.normalize_obs:
            state, obs = self._norm_obs(state, obs)
        return state, obs

    def scale_action(self, action):
        """The policy's action in +-normalization_scale mapped affinely to
        the wrapped env's bounds, and clipped to them."""
        lb = self.env.action_space.low_array(action.device)
        ub = self.env.action_space.high_array(action.device)
        scale = self.normalization_scale
        scaled = lb + (action + scale) * (ub - lb) / (2.0 * scale)
        return torch.minimum(torch.maximum(scaled, lb), ub)

    def step(self, state, action, task):
        scaled = self.scale_action(action)
        inner_state = state["inner"] if self._stats else state
        inner_state, obs, reward, done, info = self.env.step(
            inner_state, scaled, task)
        state = dict(state, inner=inner_state) if self._stats else inner_state
        if self.normalize_obs:
            state, obs = self._norm_obs(state, obs)
        if self.normalize_reward:
            state, reward = self._norm_reward(state, reward)
        return state, obs, reward * self.scale_reward, done, info

    def _norm_obs(self, state, obs):
        a = self.obs_alpha
        mean = (1 - a) * state["obs_mean"] + a * obs
        var = (1 - a) * state["obs_var"] + a * torch.square(obs - mean)
        state = dict(state, obs_mean=mean, obs_var=var)
        return state, (obs - mean) / (torch.sqrt(var) + 1e-8)

    def _norm_reward(self, state, reward):
        a = self.reward_alpha
        mean = (1 - a) * state["rew_mean"] + a * reward
        var = (1 - a) * state["rew_var"] + a * torch.square(reward - mean)
        state = dict(state, rew_mean=mean, rew_var=var)
        return state, reward / (torch.sqrt(var) + 1e-8)


def normalize(env, **kwargs):
    """Reference-style alias."""
    return NormalizedEnv(env=env, **kwargs)
