"""Batched rollout engine (port of promp_tpu/sampling/rollout.py).

Steps a (tasks, envs) batch of environments for ``horizon`` steps with the
policy, auto-resetting terminated envs inside the loop. Output buffers are
fixed-shape (tasks, envs, T, ...) with ``dones`` (episode-final steps) and
``timesteps`` (segment-relative step index, 0 after a done).
"""
from __future__ import annotations

import torch

from promp_tpu_torch.envs.base import task_expand, task_leaf


def _where_state(done, on_true, on_false):
    """Select env-state leaves (tensors or dicts of tensors) per env."""
    if isinstance(on_true, dict):
        return {k: _where_state(done, on_true[k], on_false[k])
                for k in on_true}
    d = done.reshape(done.shape + (1,) * (on_true.dim() - done.dim()))
    return torch.where(d, on_true, on_false)


def _at(draws, t):
    """Step ``t`` of a (T, ...) draw: a tensor or a tuple of tensors."""
    if isinstance(draws, (tuple, list)):
        return tuple(d[t] for d in draws)
    return draws[t]


def rollout(env, policy, params, tasks, generator, n_envs, horizon,
            floor_std=True, reset_draw=None, noise=None, reset_draws=None):
    """Collect ``n_envs`` rollouts of length ``horizon`` for every task.

    Args:
        env: TaskEnv.
        policy: GaussianMLPPolicy.
        params: params dict with a leading task axis (``policy.replicate``
            for the pre-update round).
        tasks: (tasks, ...) task tensor, or a dict of them.
        generator: torch.Generator on the tasks' device for resets and
            action noise.
        floor_std: apply the min-log-std floor (pre-update round).
        reset_draw: optional pre-drawn random draw of the initial resets,
            in the form the env's ``reset`` takes, with a (tasks, envs)
            batch shape.
        noise: optional pre-drawn action noise (T, tasks, envs, act_dim),
            one standard-normal slab per step as the JAX engine draws it.
        reset_draws: optional pre-drawn draws of the in-loop auto-resets,
            (T, tasks, envs, ...) in the form the env's ``reset`` takes
            (a tensor or a tuple of them); step t's resets take
            ``reset_draws[t]``, as the JAX engine draws them for every env
            at every step.

    Returns:
        dict with leaves shaped (tasks, envs, horizon, ...): observations,
        actions, rewards, dones, timesteps, agent_infos{mean, log_std},
        env_infos{...}.
    """
    leaf = task_leaf(tasks)
    n_tasks, device = leaf.shape[0], leaf.device
    task_b = task_expand(tasks, n_envs)
    state, obs = env.reset(task_b, generator, reset_draw)
    t_seg = torch.zeros((n_tasks, n_envs), dtype=torch.int32, device=device)
    apply_tasks = torch.func.vmap(
        lambda p, o: policy.apply(p, o, floor_std=floor_std))

    steps = []
    for t in range(horizon):
        dist = apply_tasks(params, obs)
        if noise is None:
            eps = torch.randn(dist["mean"].shape, generator=generator,
                              dtype=dist["mean"].dtype, device=device)
        else:
            eps = noise[t]
        actions = dist["mean"] + eps * torch.exp(dist["log_std"])
        new_state, new_obs, rewards, dones, env_infos = env.step(
            state, actions, task_b)
        steps.append(dict(observations=obs, actions=actions, rewards=rewards,
                          dones=dones, timesteps=t_seg, agent_infos=dist,
                          env_infos=env_infos))
        if env.never_done:
            state, obs, t_seg = new_state, new_obs, t_seg + 1
        else:
            re_state, re_obs = env.reset_carry(
                new_state, task_b, generator,
                None if reset_draws is None else _at(reset_draws, t))
            state = _where_state(dones, re_state, new_state)
            obs = torch.where(dones[..., None], re_obs, new_obs)
            t_seg = torch.where(dones, torch.zeros_like(t_seg), t_seg + 1)
    return _stack_time(steps)


def _stack_time(steps):
    """List over T of nested dicts of (tasks, envs, ...) -> (tasks, envs,
    T, ...)."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack_time([s[k] for s in steps]) for k in first}
    return torch.stack(steps, dim=2)


def segment_starts(timesteps, dtype=torch.float32):
    """0/1 mask in ``dtype`` of positions that begin an episode segment."""
    return (timesteps == 0).to(dtype)


def segment_returns(rewards, timesteps, dones):
    """Per-segment undiscounted returns on auto-reset streams.

    Returns (seg_sums, seg_mask), both (..., T): ``seg_sums`` holds each
    segment's total reward at its final position (a done or the stream's
    end), and ``seg_mask`` marks those positions.
    """
    ends = torch.cat([dones[..., :-1].to(rewards.dtype),
                      torch.ones_like(rewards[..., :1])], dim=-1)
    csum = torch.cumsum(rewards, dim=-1)
    start_mask = timesteps == 0
    prev_csum = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                          dim=-1)
    # cumulative sum before each segment's start, carried forward over the
    # segment: the start positions' values, indexed by a running max of
    # start indices
    pos = torch.arange(rewards.shape[-1], device=rewards.device)
    last_start = torch.cummax(
        torch.where(start_mask, pos, torch.zeros_like(pos)), dim=-1).values
    # before the first start the index is 0, where prev_csum is 0
    base = torch.gather(prev_csum, -1, last_start)
    return (csum - base) * ends, ends
