"""Envs of the port against the JAX envs on the same states and actions.

MetaPointEnvCorner.step in all three reward types, with inputs placed on
the sparse reward's float ties (two corners equidistant from the new
position; the L1 radius hit exactly), and NormalizedEnv's action affine and
EMA statistics over several steps. Tolerance: the same float32 ops in the
same order, so rewards and states agree to 1e-6 and every reward branch
(zero or not) agrees exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)
CORNERS = np.array([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0], [2.0, 2.0]],
                   np.float32)


def _jstep(env, state, action, task):
    key = jax.random.PRNGKey(0)
    return jax.vmap(env.step, in_axes=(0, 0, 0, None))(
        state, action, task, key)


def _corner_inputs():
    rng = np.random.default_rng(0)
    n = 64
    state = rng.uniform(-2.5, 2.5, (n, 2)).astype(np.float32)
    action = rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32)
    task = CORNERS[rng.integers(0, 4, n)]
    # float ties: new x == 0 exactly (corners (-2, y) and (2, y) equidistant)
    # for each goal, and new on the L1 radius exactly
    tie_state = np.array([[-0.1, 1.5], [-0.1, -1.5], [-0.1, 1.5],
                          [-0.1, -1.5], [0.125, 0.25], [0.375, 0.0]],
                         np.float32)
    tie_action = np.array([[0.1, 0.1], [0.1, -0.1], [0.1, 0.1],
                           [0.1, -0.1], [0.125, 0.0], [0.125, 0.0]],
                          np.float32)
    tie_task = np.array([[2, 2], [2, -2], [-2, 2], [-2, -2], [2, 2], [2, -2]],
                        np.float32)
    return (np.concatenate([state, tie_state]),
            np.concatenate([action, tie_action]),
            np.concatenate([task, tie_task]))


@pytest.mark.parametrize("reward_type", ["sparse", "dense", "dense_squared"])
def test_corner_step(reward_type):
    state, action, task = _corner_inputs()
    jenv = jenvs.MetaPointEnvCorner(reward_type=reward_type)
    tenv = tenvs.MetaPointEnvCorner(reward_type=reward_type)
    js, jo, jr, jd, _ = _jstep(jenv, jnp.asarray(state), jnp.asarray(action),
                               jnp.asarray(task))
    ts, to, tr, td, info = tenv.step(torch.as_tensor(state),
                                     torch.as_tensor(action),
                                     torch.as_tensor(task))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_array_equal(tr.numpy() == 0, np.asarray(jr) == 0)
    assert not td.any() and info == {}
    if reward_type == "sparse":
        # the x == 0 ties are rewarded (the goal counts as nearest), the
        # radius tie too (the test is strict: < 0.5)
        assert (tr[-6:] != 0).all()


def test_corner_tasks_and_reset():
    env = tenvs.make_env("MetaPointEnvCorner")
    gen = torch.Generator().manual_seed(0)
    tasks = env.sample_tasks(gen, 200, "cpu")
    assert tasks.shape == (200, 2)
    assert {tuple(t) for t in tasks.tolist()} == {tuple(c) for c in
                                                  CORNERS.tolist()}
    state, obs = env.reset(tasks[:, None].expand(200, 3, 2), gen)
    assert state.shape == (200, 3, 2) and torch.equal(state, obs)
    assert float(state.abs().max()) <= 0.2
    draw = torch.full((2, 2), 0.1)
    assert torch.equal(env.reset(tasks[:2], gen, draw)[1], draw)


@pytest.mark.parametrize("stats", [False, True])
def test_normalized_env(stats):
    kw = dict(normalize_obs=stats, normalize_reward=stats)
    jenv = jenvs.normalize(jenvs.MetaPointEnvCorner(reward_type="dense"), **kw)
    tenv = tenvs.normalize(tenvs.MetaPointEnvCorner(reward_type="dense"), **kw)
    assert tenv.action_space.low == -10.0 and tenv.obs_dim == 2
    n = 16
    rng = np.random.default_rng(1)
    task = CORNERS[rng.integers(0, 4, n)]
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    jstate, jobs = jax.vmap(jenv.reset)(keys, jnp.asarray(task))
    draw = np.asarray(jstate["inner"] if stats else jstate)
    tstate, tobs = tenv.reset(torch.as_tensor(task), None,
                              torch.tensor(draw))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    for _ in range(5):
        # actions past +-10 exercise the clip after the affine
        action = rng.uniform(-14, 14, (n, 2)).astype(np.float32)
        jstate, jobs, jrew, _, _ = _jstep(jenv, jstate, jnp.asarray(action),
                                          jnp.asarray(task))
        tstate, tobs, trew, _, _ = tenv.step(tstate, torch.as_tensor(action),
                                             torch.as_tensor(task))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
    if stats:
        for k in ("obs_mean", "obs_var", "rew_mean", "rew_var"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate[k]), **TOL)
        # an auto-reset carries the running statistics into the new episode
        keys = jax.random.split(jax.random.PRNGKey(4), n)
        jcar, jcobs = jax.vmap(jenv.reset_carry)(jstate, keys,
                                                 jnp.asarray(task))
        tcar, tcobs = tenv.reset_carry(tstate, torch.as_tensor(task), None,
                                       torch.tensor(np.asarray(jcar["inner"])))
        np.testing.assert_allclose(tcobs.numpy(), np.asarray(jcobs), **TOL)
        for k in ("obs_mean", "obs_var", "rew_mean", "rew_var"):
            np.testing.assert_allclose(tcar[k].numpy(), np.asarray(jcar[k]),
                                       **TOL)
