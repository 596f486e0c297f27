"""K1: the fused point-mass rollout (port of promp_tpu/ops/pallas_rollout.py).

``pointmass_rollout`` runs the whole rollout of MetaPointEnvCorner (sparse
reward) under ``normalize`` (scale 10) with a 2-hidden-layer tanh MLP
policy (``csrc/rollout_kernel.cu``): one CUDA warp per env, its lanes
over the hidden units with their weights in registers, ``ENVS_PER_BLOCK``
envs of one task a block. The action noise comes in pre-drawn, so the
kernel is a deterministic function of (params, goals, obs0, noise).

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs ``pointmass_rollout_plain``, the same arithmetic in PyTorch tensor
code. The CUDA source is compiled with ``nvcc``, once per width pair, into
a shared library with a plain C entry point at the first CUDA call (never
at import) and loaded with ``ctypes`` (ops/nvcc_build.py).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from promp_tpu_torch.ops import nvcc_build

SOURCE = "rollout_kernel.cu"
# no fast math, nvcc's default contraction as in the first design; -v prints
# ptxas's registers and spills
NVCC_FLAGS = nvcc_build.BASE_FLAGS + ("-Xptxas=-v",)

SCALE = 10.0       # NormalizedEnv normalization_scale
ACT_BOUND = 0.2    # MetaPointEnvCorner action bound
SPARSE_RADIUS = 0.5

ENVS_PER_BLOCK = 2           # envs a block, one warp each (the .cu's kE)
REGISTER_WEIGHTS_MAX = 128   # a lane's W2 columns this long stay in registers
MAX_SHARED_BYTES = 232448    # dynamic shared memory of a block on sm_90
MAX_GROUPS = 65535           # the grid's second dimension

PARAM_KEYS = ("mean_network/hidden_0/kernel", "mean_network/hidden_0/bias",
              "mean_network/hidden_1/kernel", "mean_network/hidden_1/bias",
              "mean_network/output/kernel", "mean_network/output/bias",
              "log_std_network/log_std_var")


class Geometry(NamedTuple):
    """K1's launch: ``grid`` (tasks, env groups) of ``threads`` a block,
    ``envs_per_block`` (one warp an env), ``units_per_lane`` (of the
    second hidden layer: lane l owns units l, l + 32, ...), the block's
    ``shared_bytes`` and whether a lane's W2 columns sit in registers
    (``w2_in_registers``) or in shared memory."""
    grid: tuple
    threads: int
    envs_per_block: int
    units_per_lane: int
    shared_bytes: int
    w2_in_registers: bool


def _round4(n):
    return -(-n // 4) * 4


def launch_geometry(n_tasks, n_envs, h0, h1):
    """The geometry of K1's launch for ``n_tasks`` x ``n_envs`` envs and
    hidden widths (h0, h1). The W2 placement is chosen here, by width, and
    passed to the build; the rest is csrc/rollout_kernel.cu's (its shared
    layout: W3, a row of each hidden layer a warp and, for long columns,
    W2), which ``load_launch`` holds against the library's. Raises where
    the card cannot take it."""
    groups = -(-n_envs // ENVS_PER_BLOCK)
    if groups > MAX_GROUPS:
        raise ValueError(f"pointmass_rollout: {n_envs} envs a task make "
                         f"{groups} groups of {ENVS_PER_BLOCK}, more than "
                         f"the grid's {MAX_GROUPS}")
    units = -(-h1 // 32)
    w2_in_registers = units * h0 <= REGISTER_WEIGHTS_MAX
    floats = (2 * _round4(h1) + ENVS_PER_BLOCK * (_round4(h0) + _round4(h1))
              + (0 if w2_in_registers else h0 * h1))
    if 4 * floats > MAX_SHARED_BYTES:
        raise ValueError(f"pointmass_rollout: widths ({h0}, {h1}) need "
                         f"{4 * floats} B of shared memory a block, more "
                         f"than {MAX_SHARED_BYTES}")
    return Geometry((n_tasks, groups), 32 * ENVS_PER_BLOCK, ENVS_PER_BLOCK,
                    units, 4 * floats, w2_in_registers)


def build_job(h0=64, h1=64):
    """(name, source, flags) of K1's library for hidden widths (h0, h1),
    for ``nvcc_build.build_all``."""
    geo = launch_geometry(1, 1, h0, h1)
    defines = (f"-DK1_H0={h0}", f"-DK1_H1={h1}",
               f"-DK1_W2_REG={int(geo.w2_in_registers)}")
    return (f"rollout_kernel_{h0}x{h1}", nvcc_build.read_source(SOURCE),
            NVCC_FLAGS + defines)


_launchers = {}


def load_launch(h0, h1):
    """The library's C entry point ``pointmass_rollout_launch`` for (h0, h1)
    through ctypes, built first if needed; raises if the library lays out
    another block than ``launch_geometry``."""
    if (h0, h1) not in _launchers:
        lib = nvcc_build.load(nvcc_build.build(*build_job(h0, h1)))
        want = launch_geometry(1, 1, h0, h1).shared_bytes
        got = lib.pointmass_rollout_shared_bytes()
        if got != want:
            raise RuntimeError(f"pointmass_rollout: the library lays out "
                               f"{got} B a block, launch_geometry {want}")
        fn = lib.pointmass_rollout_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[(h0, h1)] = fn
    return _launchers[(h0, h1)]


def _unpack(task_params):
    w1, b1, w2, b2, w3, b3, log_std = (task_params[k] for k in PARAM_KEYS)
    return w1, b1, w2, b2, w3, b3, log_std[:, 0, :]


def _check_inputs(task_params, goals, obs0, noise):
    if obs0.dim() != 3 or noise.dim() != 4:
        raise ValueError(f"pointmass_rollout: obs0 {tuple(obs0.shape)} and "
                         f"noise {tuple(noise.shape)} must be 3-D and 4-D")
    n_tasks, n_envs = obs0.shape[:2]
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

    kw = dict(dtype=torch.float32, device=obs0.device)
    obs = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    act = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    rew = torch.empty((n_tasks, n_envs, horizon), **kw)
    mean = torch.empty((n_tasks, n_envs, horizon, 2), **kw)
    call, log_std = _bind((n_tasks, n_envs, horizon, h0, h1), task_params,
                          goals, obs0, noise, (obs, act, rew, mean))
    call()
    pointmass_rollout.launches += 1
    return _result(obs, act, rew, mean, log_std)


pointmass_rollout.launches = 0


def _check_outputs(obs0, dims, outs):
    n_tasks, n_envs, horizon = dims[:3]
    n = n_tasks * n_envs * horizon
    for name, t, size in zip(("obs", "act", "rew", "mean"), outs,
                             (2 * n, 2 * n, n, 2 * n)):
        if (t.device != obs0.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.numel() < size):
            raise ValueError(f"pointmass_rollout: output {name} must be a "
                             f"contiguous float32 tensor of at least {size} "
                             f"elements on {obs0.device}")


def bind_launch(task_params, goals, obs0, noise, outs):
    """Checks K1's CUDA inputs and ``outs``, the contiguous float32 obs,
    actions, rewards and means it writes the first (n_tasks, n_envs, T, 2)
    elements of ((n_tasks, n_envs, T) for rewards), and returns (``call``,
    the (n_tasks, 2) log-std the kernel reads): ``call()`` launches K1 on
    them through the C entry alone on the stream current now, raising if
    the launch is refused, so that repeated calls time the kernel without
    the wrapper's host work. Counts no launch: ``pointmass_rollout``
    does."""
    dims = _check_inputs(task_params, goals, obs0, noise)
    if obs0.device.type != "cuda":
        raise ValueError(f"pointmass_rollout: launch on {obs0.device}")
    _check_outputs(obs0, dims, outs)
    return _bind(dims, task_params, goals, obs0, noise, outs)


def _bind(dims, task_params, goals, obs0, noise, outs):
    """``bind_launch`` on inputs and outputs already checked; ``dims`` are
    ``_check_inputs``'s."""
    n_tasks, n_envs, horizon, h0, h1 = dims
    launch_geometry(n_tasks, n_envs, h0, h1)   # raises past the card's limits
    fn = load_launch(h0, h1)
    w1, b1, w2, b2, w3, b3, log_std = _unpack(task_params)
    log_std = log_std.contiguous()
    stream = torch.cuda.current_stream(obs0.device).cuda_stream
    tensors = (goals, w1, b1, w2, b2, w3, b3, log_std, obs0, noise, *outs)
    args = (*(t.data_ptr() for t in tensors), n_tasks, n_envs, horizon,
            stream)

    def call():
        # ``tensors`` stays referenced, so every pointer in ``args`` lives
        # as long as ``call``
        with torch.cuda.device(tensors[0].device):
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"pointmass_rollout: kernel launch failed "
                               f"with cudaError {err}")

    return call, log_std


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

