"""K1: the fused point-mass rollout (port of promp_tpu/ops/pallas_rollout.py).

``pointmass_rollout`` runs the whole rollout of MetaPointEnvCorner (sparse
reward) under ``normalize`` (scale 10) with a 2-hidden-layer tanh MLP
policy, one CUDA block per meta-task (``csrc/rollout_kernel.cu``). The
action noise comes in pre-drawn, so the kernel is a deterministic function
of (params, goals, obs0, noise).

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs ``pointmass_rollout_plain``, the same arithmetic in PyTorch tensor
code. The CUDA source is compiled with ``nvcc`` into a shared library with
a plain C entry point at the first CUDA call (never at import) and loaded
with ``ctypes`` (ops/nvcc_build.py).
"""
from __future__ import annotations

import ctypes

import torch

from promp_tpu_torch.ops import nvcc_build

SOURCE = "rollout_kernel.cu"
NVCC_FLAGS = nvcc_build.BASE_FLAGS

SCALE = 10.0       # NormalizedEnv normalization_scale
ACT_BOUND = 0.2    # MetaPointEnvCorner action bound
SPARSE_RADIUS = 0.5
MAX_ENVS = 1024    # one thread per env, one block per task

PARAM_KEYS = ("mean_network/hidden_0/kernel", "mean_network/hidden_0/bias",
              "mean_network/hidden_1/kernel", "mean_network/hidden_1/bias",
              "mean_network/output/kernel", "mean_network/output/bias",
              "log_std_network/log_std_var")

_lib = None


def build_job():
    """(name, source, flags) of K1's library, for ``nvcc_build.build_all``."""
    return ("rollout_kernel", nvcc_build.read_source(SOURCE), NVCC_FLAGS)


def build():
    """Compile K1's library unless it exists; returns its path."""
    return nvcc_build.build(*build_job())


def _load():
    global _lib
    if _lib is None:
        lib = nvcc_build.load(build())
        fn = lib.pointmass_rollout_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _unpack(task_params):
    w1, b1, w2, b2, w3, b3, log_std = (task_params[k] for k in PARAM_KEYS)
    return w1, b1, w2, b2, w3, b3, log_std[:, 0, :]


def _check_inputs(task_params, goals, obs0, noise):
    if obs0.dim() != 3 or noise.dim() != 4:
        raise ValueError(f"pointmass_rollout: obs0 {tuple(obs0.shape)} and "
                         f"noise {tuple(noise.shape)} must be 3-D and 4-D")
    n_tasks, n_envs = obs0.shape[:2]
    if n_envs > MAX_ENVS:
        raise ValueError(f"pointmass_rollout: {n_envs} envs a task, more "
                         f"than the {MAX_ENVS} threads of one block")
    horizon = noise.shape[1]
    w1 = task_params[PARAM_KEYS[0]]
    h0, h1 = w1.shape[-1], task_params[PARAM_KEYS[2]].shape[-1]
    shapes = {
        PARAM_KEYS[0]: (n_tasks, 2, h0), PARAM_KEYS[1]: (n_tasks, h0),
        PARAM_KEYS[2]: (n_tasks, h0, h1), PARAM_KEYS[3]: (n_tasks, h1),
        PARAM_KEYS[4]: (n_tasks, h1, 2), PARAM_KEYS[5]: (n_tasks, 2),
        PARAM_KEYS[6]: (n_tasks, 1, 2),
        "goals": (n_tasks, 2), "obs0": (n_tasks, n_envs, 2),
        "noise": (n_tasks, horizon, n_envs, 2),
    }
    tensors = dict(task_params, goals=goals, obs0=obs0, noise=noise)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"pointmass_rollout: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    for name, shape in shapes.items():
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"pointmass_rollout: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"pointmass_rollout: {name} is {t.dtype}, "
                             "expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"pointmass_rollout: {name} is not contiguous")
    return n_tasks, n_envs, horizon, h0, h1


def pointmass_rollout(task_params, goals, obs0, noise):
    """Fused rollout for sparse MetaPointEnvCorner under normalize(10).

    Args:
        task_params: policy params with a leading task axis (names and
            shapes of GaussianMLPPolicy with two hidden layers, tanh); the
            caller applies any log-std floor beforehand.
        goals: (n_tasks, 2) corner goals.
        obs0: (n_tasks, n_envs, 2) initial states.
        noise: (n_tasks, T, n_envs, 2) standard-normal action noise.

    Returns:
        dict of (n_tasks, n_envs, T, ...) tensors: observations, actions,
        rewards, agent_infos{mean, log_std}.
    """
    n_tasks, n_envs, horizon, h0, h1 = _check_inputs(task_params, goals,
                                                     obs0, noise)
    if obs0.device.type == "cpu":
        return pointmass_rollout_plain(task_params, goals, obs0, noise)
    if obs0.device.type != "cuda":
        raise ValueError(f"pointmass_rollout: unsupported device {obs0.device}")

    lib = _load()
    w1, b1, w2, b2, w3, b3, log_std = _unpack(task_params)
    log_std = log_std.contiguous()
    kw = dict(dtype=torch.float32, device=obs0.device)
    obs = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    act = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    rew = torch.empty((n_tasks, n_envs, horizon), **kw)
    mean = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    with torch.cuda.device(obs0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pointmass_rollout_launch(
            *(t.data_ptr() for t in (goals, w1, b1, w2, b2, w3, b3, log_std,
                                     obs0, noise, obs, act, rew, mean)),
            n_tasks, n_envs, horizon, h0, h1, stream)
    if err != 0:
        raise RuntimeError(f"pointmass_rollout: kernel launch failed with "
                           f"cudaError {err}")
    pointmass_rollout.launches += 1
    return _result(obs, act, rew, mean, log_std)


pointmass_rollout.launches = 0


def _result(obs, act, rew, mean, log_std):
    return dict(observations=obs, actions=act, rewards=rew,
                agent_infos=dict(mean=mean,
                                 log_std=log_std[:, None, None, :].expand(
                                     mean.shape)))


def _corner_reward(obs, new, goals):
    """K1's sparse corner reward for ``obs`` -> ``new`` (..., 2), with
    ``goals`` broadcast to them."""
    goal_d = torch.sqrt(torch.sum((new - goals) ** 2, dim=-1))
    dist_l1 = torch.sum(torch.abs(new), dim=-1)
    x, y = new[..., 0], new[..., 1]
    d2 = torch.minimum(
        torch.minimum((x + 2.0) ** 2 + (y + 2.0) ** 2,
                      (x - 2.0) ** 2 + (y + 2.0) ** 2),
        torch.minimum((x + 2.0) ** 2 + (y - 2.0) ** 2,
                      (x - 2.0) ** 2 + (y - 2.0) ** 2))
    prev_d = torch.sqrt(torch.sum((obs - goals) ** 2, dim=-1))
    zero = torch.zeros_like(goal_d)
    return torch.where(dist_l1 < SPARSE_RADIUS, zero,
                       torch.where(goal_d <= torch.sqrt(d2) + 1e-7,
                                   prev_d - goal_d, zero))


def _env_step(obs, action):
    scaled = -ACT_BOUND + (action + SCALE) * (2 * ACT_BOUND) / (2 * SCALE)
    return obs + torch.clamp(scaled, -ACT_BOUND, ACT_BOUND)


def pointmass_rollout_plain(task_params, goals, obs0, noise):
    """The kernel's arithmetic in PyTorch tensor code, step by step over T;
    same arguments and result as ``pointmass_rollout``."""
    w1, b1, w2, b2, w3, b3, log_std = _unpack(task_params)
    std = torch.exp(log_std)[:, None, :]
    goal = goals[:, None, :]
    obs = obs0
    rows = []
    for t in range(noise.shape[1]):
        h = torch.tanh(torch.bmm(obs, w1) + b1[:, None])
        h = torch.tanh(torch.bmm(h, w2) + b2[:, None])
        mean = torch.bmm(h, w3) + b3[:, None]
        action = mean + noise[:, t] * std
        new = _env_step(obs, action)
        reward = _corner_reward(obs, new, goal)
        rows.append((obs, action, reward, mean))
        obs = new
    obs, act, rew, mean = (torch.stack(x, dim=2) for x in zip(*rows))
    return _result(obs, act, rew, mean, log_std)


def reward_tie_margin(observations, actions, goals):
    """(n_tasks, n_envs, T) distance of each step's reward tests from a
    true tie, recomputed from a rollout's observations and actions: the
    smaller of |L1 norm - radius| and |goal distance - distance of the
    nearest corner other than the goal|. A reward branch that two
    implementations disagree on is a float tie only where this margin is
    small. The margin does not count K1's own comparison of the goal's
    distance with the goal corner's (the same number by two expressions,
    1e-7 apart): two implementations that round those alike never flip
    there."""
    new = _env_step(observations, actions)
    goals = goals[:, None, None, None, :]
    corners = torch.tensor([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0],
                            [2.0, 2.0]], device=new.device)
    dist = torch.sqrt(torch.sum((new[..., None, :] - corners) ** 2, dim=-1))
    is_goal = (corners == goals).all(dim=-1)
    other = torch.where(is_goal, torch.inf, dist).amin(dim=-1)
    goal_d = torch.sqrt(torch.sum((new - goals[..., 0, :]) ** 2, dim=-1))
    radius = torch.abs(torch.sum(torch.abs(new), dim=-1) - SPARSE_RADIUS)
    return torch.minimum(radius, torch.abs(goal_d - other))
