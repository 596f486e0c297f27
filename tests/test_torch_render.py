"""The port's single-episode rollout and plots (sampling/render.py) against
the JAX package's.

``rollout`` on the dense point mass with a (16, 16) policy is held
against the JAX ``rollout`` on the same reset and action noise (the
port takes them pre-drawn, as the JAX keys draw them): float32 over 30
steps, atol 1e-5 (the gaps seen are below 1e-6). The plot functions
import matplotlib inside themselves, as the JAX package's do; their test
skips where it is missing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling import render as jrender  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling import render as trender  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

T = 30


def _jax_draws(jenv, key, act_dim):
    """The reset state and the per-step action noise that the JAX
    ``rollout`` draws from ``key`` (render.py's key splits)."""
    k_reset, k_run = jax.random.split(key)
    state0, _ = jenv.reset(k_reset, None)
    noise = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[0], (act_dim,)))(jax.random.split(k_run, T))
    return np.asarray(state0), np.asarray(noise)


@pytest.fixture(scope="module")
def point_rollouts():
    jenv = jenvs.make_env("MetaPointEnvCorner", reward_type="dense")
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=(16, 16))
    params = dict(jpol.init(jax.random.PRNGKey(2)))
    params["mean_network/output/bias"] = jnp.array([0.05, 0.1])
    task = jnp.array([2.0, 2.0])
    key = jax.random.PRNGKey(9)
    want = jrender.rollout(jenv, jpol, params, task, key, max_path_length=T)
    state0, noise = _jax_draws(jenv, key, 2)
    tenv = tenvs.make_env("MetaPointEnvCorner", reward_type="dense")
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=(16, 16))
    got = trender.rollout(tenv, tpol, from_numpy_params(
        {k: np.asarray(v) for k, v in params.items()}, "cpu"),
        torch.tensor(np.asarray(task)), reset_draw=torch.tensor(state0),
        noise=torch.tensor(noise), max_path_length=T)
    return got, want, task


def test_point_rollout_matches_jax(point_rollouts):
    got, want, _ = point_rollouts
    assert set(got) == set(want) == {"observations", "actions", "rewards",
                                     "dones", "agent_infos", "env_infos",
                                     "states"}
    for k in ("observations", "actions", "rewards", "states"):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k in ("mean", "log_std"):
        np.testing.assert_allclose(got["agent_infos"][k].numpy(),
                                   np.asarray(want["agent_infos"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert not got["dones"].any() and not np.asarray(want["dones"]).any()
    assert got["observations"].device.type == "cpu"


def test_rollout_draws_from_a_seed_or_a_generator():
    env = tenvs.make_env("SwimmerRandVelEnv")
    pol = TPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                  hidden_sizes=(8,))
    params = pol.init(torch.Generator().manual_seed(0), "cpu")
    task = torch.tensor(0.15)
    a = trender.rollout(env, pol, params, task, 4, max_path_length=6)
    b = trender.rollout(env, pol, params, task,
                        torch.Generator().manual_seed(4), max_path_length=6)
    assert torch.equal(a["observations"], b["observations"])
    assert a["observations"].shape == (6, env.obs_dim)
    assert a["states"]["q"].shape == (6, env.model.nv)
    assert set(a["env_infos"]) == {"reward_fwd", "reward_ctrl"}
    assert torch.isfinite(a["states"]["qd"]).all()
    c = trender.rollout(env, pol, params, task, 5, max_path_length=6)
    assert not torch.equal(a["observations"], c["observations"])


def test_plots_write_their_files(point_rollouts, tmp_path):
    pytest.importorskip("matplotlib")
    got, _, task = point_rollouts
    png = tmp_path / "point.png"
    fig = trender.render_point_trajectory(got, torch.tensor(
        np.asarray(task)), save_path=str(png))
    assert fig is not None and png.stat().st_size > 0
    env = tenvs.make_env("SwimmerRandVelEnv")
    pol = TPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                  hidden_sizes=(8,))
    traj = trender.rollout(env, pol, pol.init(
        torch.Generator().manual_seed(1), "cpu"), torch.tensor(0.12), 1,
        max_path_length=4)
    gif = tmp_path / "swimmer.gif"
    assert trender.render_locomotion_video(env, traj, str(gif)) == str(gif)
    assert gif.stat().st_size > 0
