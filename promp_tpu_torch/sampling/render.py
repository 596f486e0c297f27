"""Single-rollout collection with optional rendering (port of
promp_tpu/sampling/render.py).

``rollout`` collects one episode of one env, states included, for
inspection and plots; it is not on the training path. The plots are
matplotlib, imported inside each function:

  * point envs: a 2D trajectory plot with the goal marked
  * locomotion envs: stick-figure frames from the engine's forward
    kinematics (body positions), saved as a GIF with pillow
"""
from __future__ import annotations

import numpy as np
import torch

from promp_tpu_torch.envs.base import task_leaf
from promp_tpu_torch.utils.misc import stack_tensor_dict_list


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def rollout(env, policy, params, task, generator=0, max_path_length=100,
            floor_std=True, reset_draw=None, noise=None):
    """Collect one episode; returns a dict of (T, ...) CPU tensors:
    observations, actions, rewards, dones, agent_infos, env_infos and
    states (the state after each step).

    ``task`` is one instance's task on the device to run on (a tensor, or
    a dict of them). ``generator`` is a ``torch.Generator`` on that device
    or an int seed for one. ``reset_draw`` (the draw ``env.reset`` takes)
    and ``noise`` ((T, act_dim) standard-normal action noise) may be given
    pre-drawn; then the generator draws nothing for them. The episode runs
    all ``max_path_length`` steps, as the JAX rollout's scan does.
    """
    device = task_leaf(task).device
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    state, obs = env.reset(task, generator, reset_draw)
    steps = []
    with torch.no_grad():
        for t in range(max_path_length):
            dist = policy.apply(params, obs, floor_std=floor_std)
            if noise is None:
                eps = torch.randn(dist["mean"].shape, generator=generator,
                                  dtype=dist["mean"].dtype, device=device)
            else:
                eps = noise[t]
            action = dist["mean"] + eps * torch.exp(dist["log_std"])
            state, obs2, reward, done, info = env.step(state, action, task)
            steps.append(dict(observations=obs, actions=action,
                              rewards=reward, dones=done, agent_infos=dist,
                              env_infos=info, states=state))
            obs = obs2
    return _to_host(stack_tensor_dict_list(steps))


def render_point_trajectory(traj, task=None, save_path=None):
    """2D path plot for the point envs; returns the matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    obs = np.asarray(traj["observations"])[:, :2]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(obs[:, 0], obs[:, 1], "-o", markersize=2, linewidth=1)
    ax.plot(obs[0, 0], obs[0, 1], "gs", label="start")
    if task is not None:
        goal = np.asarray(torch.as_tensor(task).cpu()).reshape(-1)[:2]
        ax.plot(goal[0], goal[1], "r*", markersize=14, label="goal")
    ax.set_xlim(-3, 3)
    ax.set_ylim(-3, 3)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=80)
    return fig


def render_locomotion_video(env, traj, save_path, fps=20, max_frames=200):
    """Stick-figure animation from the engine's forward kinematics; saves a
    GIF (pillow writer) and returns its path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    eng = env.engine
    q = torch.as_tensor(traj["states"]["q"])[:max_frames]
    frames = eng.fk(q)["body_pos"].cpu().numpy()
    parents = eng.model.body_parent

    fig, ax = plt.subplots(figsize=(6, 4))
    lines = [ax.plot([], [], "o-", linewidth=2)[0]
             for _ in range(len(parents))]
    ax.plot([-100, 100], [0, 0], "k-", linewidth=1)
    ax.set_ylim(-0.5, 2.5)

    def update(i):
        pos = frames[i]
        x0 = pos[0, 0]
        if not np.isfinite(x0):
            return lines
        ax.set_xlim(x0 - 2, x0 + 2)
        for b, line in enumerate(lines):
            p = parents[b]
            if p < 0:
                line.set_data([pos[b, 0]], [pos[b, 2]])
            else:
                line.set_data([pos[p, 0], pos[b, 0]],
                              [pos[p, 2], pos[b, 2]])
        return lines

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   blit=False)
    anim.save(save_path, writer="pillow", fps=fps)
    plt.close(fig)
    return save_path
