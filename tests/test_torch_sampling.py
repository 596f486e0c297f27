"""Rollout engine and SampleProcessor of the port against promp_tpu's, fed
the same initial states and action noise (drawn with jax.random under the
key splits of promp_tpu/sampling/rollout.py:64-83).

Tolerances (float32): trajectories, returns and statistics take atol/rtol
1e-4 (per-step rounding of the MLP compounds over the T steps); integer
buffers, dones and the reward branch agree exactly. Advantages take atol
2e-3: they pass through a ridge fit whose 8x8 normal equations are badly
conditioned (features up to (t/100)^3 and obs^2), so float32 rounding of
the Gram matrix in another summation order moves the fit by ~1e-3. The same
processing run in float64 on identical inputs agrees to 1e-9, which pins
the algorithm itself.
"""
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.envs.base import Box as JBox, TaskEnv as JTaskEnv  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu.sampling.rollout import rollout as jrollout  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.envs.base import Box as TBox, TaskEnv as TTaskEnv  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.sampling.rollout import rollout as trollout  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T = 3, 4, 20
HIDDEN = (16, 16)
TRAJ = dict(atol=1e-4, rtol=1e-4)
ADV = dict(atol=2e-3, rtol=1e-4)
F64 = dict(atol=1e-9, rtol=1e-9)


@dataclass(frozen=True)
class JBounce(JTaskEnv):
    """Deterministic env whose episodes end when |x|_1 > 0.6 (resets to 0),
    so a 20-step stream holds several segments."""
    never_done: bool = False
    observation_space: JBox = JBox(-jnp.inf, jnp.inf, (2,))
    action_space: JBox = JBox(-1.0, 1.0, (2,))

    def reset(self, key, task):
        return jnp.zeros(2), jnp.zeros(2)

    def step(self, state, action, task, key):
        new = state + 0.1 * jnp.clip(action, -1.0, 1.0) + task
        l1 = jnp.sum(jnp.abs(new))
        return new, new, -jnp.sum(new ** 2), l1 > 0.6, {"l1": l1}


@dataclass(frozen=True)
class TBounce(TTaskEnv):
    never_done: bool = False
    observation_space: TBox = TBox(-float("inf"), float("inf"), (2,))
    action_space: TBox = TBox(-1.0, 1.0, (2,))

    def reset(self, task, generator, draw=None):
        zero = torch.zeros(task.shape)
        return zero, zero

    def step(self, state, action, task):
        new = state + 0.1 * torch.clamp(action, -1.0, 1.0) + task
        l1 = torch.sum(torch.abs(new), dim=-1)
        return new, new, -torch.sum(new ** 2, dim=-1), l1 > 0.6, {"l1": l1}


def _draws(env, tasks, key):
    """obs0 and noise as the JAX engine draws them (rollout.py:64-83)."""
    key_reset, key_scan = jax.random.split(key)
    reset_keys = jax.random.split(key_reset, N_T * N_E).reshape(N_T, N_E, -1)
    state0, _ = jax.vmap(lambda ks, t: jax.vmap(
        env.reset, in_axes=(0, None))(ks, t))(reset_keys, tasks)
    noise = [jax.random.normal(jax.random.split(k, 3)[0], (N_T, N_E, 2))
             for k in jax.random.split(key_scan, T)]
    return np.array(state0), np.stack([np.asarray(n) for n in noise])


def _params():
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    params = dict(jpol.init(jax.random.PRNGKey(0)))
    # push the means out of the sparse reward's dead zone, with a log_std
    # below the floor so that floor_std matters
    params["mean_network/output/bias"] = jnp.array([6.0, -4.0])
    params["log_std_network/log_std_var"] = jnp.array([[-20.0, -0.5]])
    return jpol, jpol.replicate(params, N_T), {
        k: np.asarray(v) for k, v in jpol.replicate(params, N_T).items()}


def _compare(got, want, tol=TRAJ, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _compare(got[k], want[k], ADV if k == "advantages" and tol is TRAJ
                     else tol, f"{path}/{k}")
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, path
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)


def _map(fn, tree):
    return ({k: _map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(np.asarray(tree)))


def _process_both(config, got, want, float64=True):
    """Process in float32 (each package its own trajectory) and, with
    ``float64``, in float64 (both the JAX trajectory, cast); compare each."""
    _compare(TProc(**config).process(got),
             jax.jit(JProc(**config).process)(want))
    if not float64:
        return
    wide = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a
    with jax.enable_x64():
        j64 = jax.jit(JProc(**config).process)(_map(
            lambda a: jnp.asarray(wide(a)), want))
        t64 = TProc(**config).process(_map(
            lambda a: torch.tensor(wide(a)), want))
        _compare(t64, j64, F64)


@pytest.fixture(scope="module")
def corner_runs():
    """Rollouts of sparse normalize(MetaPointEnvCorner) in both packages,
    pre-update (floor) and post-update (raw log_std)."""
    jpol, jparams, np_params = _params()
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    jenv = jenvs.normalize(jenvs.MetaPointEnvCorner())
    tenv = tenvs.normalize(tenvs.MetaPointEnvCorner())
    tasks = jnp.asarray(np.array([[2, 2], [2, -2], [-2, 2]], np.float32))
    runs = {}
    for floor in (True, False):
        key = jax.random.PRNGKey(7)
        want = jax.jit(jrollout, static_argnums=(0, 1, 5, 6, 7))(
            jenv, jpol, jparams, tasks, key, N_E, T, floor)
        obs0, noise = _draws(jenv, tasks, key)
        got = trollout(tenv, tpol, from_numpy_params(np_params, "cpu"),
                       torch.tensor(np.asarray(tasks)), None, N_E, T,
                       floor_std=floor, reset_draw=torch.as_tensor(obs0),
                       noise=torch.as_tensor(noise))
        runs[floor] = (got, want)
    return runs


@pytest.mark.parametrize("floor", [True, False])
def test_corner_rollout(corner_runs, floor):
    got, want = corner_runs[floor]
    _compare(got, want)
    np.testing.assert_array_equal(got["rewards"].numpy() == 0,
                                  np.asarray(want["rewards"]) == 0)
    assert float((got["rewards"] != 0).float().mean()) > 0.2


@pytest.mark.parametrize("config", [
    dict(normalize_adv=True),
    dict(baseline="LinearTimeBaseline", positive_adv=True, gae_lambda=0.95),
    dict(baseline="ZeroBaseline", discount=0.9),
])
def test_process_corner(corner_runs, config):
    got, want = corner_runs[True]
    # the float64 check runs on the main path's config (the ridge fit is
    # what needs it); the other two are held in float32
    _process_both(config, got, want, float64="baseline" not in config)


def test_generator_draws():
    """Without pre-drawn inputs the engine draws from the generator: same
    seed, same rollout; statistics of the action noise."""
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    env = tenvs.normalize(tenvs.MetaPointEnvCorner())
    params = tpol.replicate(tpol.init(torch.Generator().manual_seed(0), "cpu"),
                            N_T)
    tasks = env.sample_tasks(torch.Generator().manual_seed(1), N_T, "cpu")
    a, b = (trollout(env, tpol, params, tasks,
                     torch.Generator().manual_seed(2), 50, T)
            for _ in range(2))
    assert torch.equal(a["actions"], b["actions"])
    z = (a["actions"] - a["agent_infos"]["mean"]) / torch.exp(
        a["agent_infos"]["log_std"])
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    assert float(a["observations"][:, :, 0].abs().max()) <= 0.2


def test_auto_reset_rollout_and_processing():
    """Episodes that end inside the stream: auto-reset, dones, segment
    timesteps, env_infos, and the processor's segment statistics."""
    jpol, jparams, np_params = _params()
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    tasks = np.array([[0.05, 0.0], [0.0, -0.08], [0.03, 0.03]], np.float32)
    key = jax.random.PRNGKey(11)
    want = jrollout(JBounce(), jpol, jparams, jnp.asarray(tasks), key, N_E, T)
    _, noise = _draws(JBounce(), jnp.asarray(tasks), key)
    got = trollout(TBounce(), tpol, from_numpy_params(np_params, "cpu"),
                   torch.as_tensor(tasks), None, N_E, T,
                   noise=torch.as_tensor(noise))
    _compare(got, want)
    assert int(got["dones"].sum()) >= N_T * N_E
    _process_both(dict(normalize_adv=True), got, want)
