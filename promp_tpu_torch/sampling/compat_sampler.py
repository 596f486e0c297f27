"""Reference-RNG-compatible host sampler, the seed-exact mode (port of
promp_tpu/sampling/compat_sampler.py).

The reference consumes one global numpy MT19937 stream in a fixed order:

  np.random.seed(seed)                       (the sampler's constructor)
  sample_tasks -> np.random.choice(range(4), meta_batch_size)
  per round, per env, task-major: np.random.uniform(-0.2, 0.2, size=(2,))
  per step: np.random.normal(size=(n_tasks * n_envs, 2)), the policy's
            action noise drawn in numpy on the concatenated batch

This module replays that order with numpy's own generator around the
port's policy, evaluated per task with ``torch.func.vmap`` on the device
and in the dtype it is given. The env transitions and rewards are float64
numpy, one env at a time, exactly as the JAX sampler writes them: the
reward's norms keep their forms (an axis-free ``np.linalg.norm`` of a
vector, which rounds differently from a row-wise norm), so the
nearest-corner tie test falls as it does there. Given identical
parameters, a float64 run matches the JAX package's float64 run.
For parity tests and cross-checks, not for the training hot path.
"""
from __future__ import annotations

import numpy as np
import torch

from promp_tpu_torch.utils.misc import resolve_device


class CompatPointMassSampler:
    """Replays the reference's numpy RNG stream for MetaPointEnvCorner.

    Args:
        policy: the port's GaussianMLPPolicy, with params supplied per call.
        meta_batch_size, envs_per_task, max_path_length: reference config.
        normalization_scale: the NormalizedEnv action scale (10.0).
        dtype: the dtype the policy is evaluated in (float64 for the
            float64 mode).
        device: where the policy is evaluated; the card unless the caller
            asks for the CPU.
    """

    CORNERS = [np.array([-2.0, -2.0]), np.array([2.0, -2.0]),
               np.array([-2.0, 2.0]), np.array([2.0, 2.0])]

    def __init__(self, policy, meta_batch_size, envs_per_task,
                 max_path_length, seed=1, reward_type="sparse",
                 sparse_reward_radius=0.5, normalization_scale=10.0,
                 dtype=torch.float32, device="cuda"):
        self.policy = policy
        self.meta_batch_size = meta_batch_size
        self.envs_per_task = envs_per_task
        self.max_path_length = max_path_length
        self.reward_type = reward_type
        self.sparse_reward_radius = sparse_reward_radius
        self.normalization_scale = normalization_scale
        self.dtype = dtype
        self.device = resolve_device(device)
        np.random.seed(seed)

    # ----------------------------------------------------- RNG-faithful env
    def sample_tasks(self):
        """np.random.choice on the 4 corners."""
        idx = np.random.choice(range(4), size=self.meta_batch_size)
        return [self.CORNERS[i] for i in idx]

    def _reset(self):
        return np.random.uniform(-0.2, 0.2, size=(2,))

    def _reward(self, prev_state, state, goal):
        goal_distance = np.linalg.norm(state - goal)
        if self.reward_type == "dense":
            return -goal_distance
        if self.reward_type == "dense_squared":
            return -goal_distance**2
        if np.linalg.norm(state, ord=1) < self.sparse_reward_radius:
            return 0.0
        dists = [np.linalg.norm(state - c) for c in self.CORNERS]
        if goal_distance == min(dists):
            return np.linalg.norm(prev_state - goal) - goal_distance
        return 0.0

    # -------------------------------------------------------------- sampling
    def obtain_samples(self, task_params, tasks, floor_std=True):
        """One sampling round, the reference's lockstep loop.

        Args:
            task_params: policy params dict with a leading task axis.
            tasks: list of goal arrays (len meta_batch_size).

        Returns:
            list (per task) of dicts of float64 numpy (envs, T, .) arrays.
        """
        n_t, n_e, T = self.meta_batch_size, self.envs_per_task, \
            self.max_path_length
        # env resets happen env by env, task-major
        states = np.stack([[self._reset() for _ in range(n_e)]
                           for _ in range(n_t)])  # (n_t, n_e, 2)
        apply_fn = torch.func.vmap(
            lambda p, o: self.policy.apply(p, o, floor_std=floor_std))

        obs_buf = np.zeros((n_t, n_e, T, 2))
        act_buf = np.zeros((n_t, n_e, T, 2))
        rew_buf = np.zeros((n_t, n_e, T))
        mean_buf = np.zeros((n_t, n_e, T, 2))
        logstd_buf = np.zeros((n_t, n_e, T, 2))

        lb, ub = -0.2, 0.2
        s = self.normalization_scale
        for t in range(T):
            with torch.no_grad():
                dist = apply_fn(task_params, torch.as_tensor(
                    states, dtype=self.dtype, device=self.device))
            means = dist["mean"].cpu().numpy().astype(np.float64)
            log_stds = dist["log_std"].cpu().numpy().astype(np.float64)
            # the policy re-samples its action in numpy on the concatenated
            # (n_t * n_e, act) batch
            rnd = np.random.normal(size=(n_t * n_e, 2))
            actions = (means.reshape(-1, 2)
                       + rnd * np.exp(log_stds.reshape(-1, 2))
                       ).reshape(n_t, n_e, 2)
            obs_buf[:, :, t] = states
            act_buf[:, :, t] = actions
            mean_buf[:, :, t] = means
            logstd_buf[:, :, t] = log_stds
            # the normalized env's action rescale
            scaled = lb + (actions + s) * (ub - lb) / (2 * s)
            scaled = np.clip(scaled, lb, ub)
            for i in range(n_t):
                for e in range(n_e):
                    prev = states[i, e]
                    new = prev + np.clip(scaled[i, e], -0.2, 0.2)
                    rew_buf[i, e, t] = self._reward(prev, new, tasks[i])
                    states[i, e] = new

        return [dict(observations=obs_buf[i], actions=act_buf[i],
                     rewards=rew_buf[i],
                     agent_infos=dict(mean=mean_buf[i],
                                      log_std=logstd_buf[i]))
                for i in range(self.meta_batch_size)]


def batch_paths(paths, device):
    """The sampler's per-task paths -> the batched samples dict that the
    sample processors take, on ``device``, in the paths' float64: (tasks,
    envs, T, ...) leaves, no dones, timesteps 0..T-1."""
    def stack(get):
        return torch.as_tensor(np.stack([get(p) for p in paths]),
                               device=device)

    rewards = stack(lambda p: p["rewards"])
    n_t, n_e, horizon = rewards.shape
    return dict(
        observations=stack(lambda p: p["observations"]),
        actions=stack(lambda p: p["actions"]),
        rewards=rewards,
        dones=torch.zeros((n_t, n_e, horizon), dtype=torch.bool,
                          device=device),
        timesteps=torch.arange(horizon, dtype=torch.int32, device=device)
        .expand(n_t, n_e, horizon),
        agent_infos=dict(mean=stack(lambda p: p["agent_infos"]["mean"]),
                         log_std=stack(lambda p: p["agent_infos"]["log_std"])),
        env_infos={})
