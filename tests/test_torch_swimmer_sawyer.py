"""The swimmer and the four Sawyer envs of the port against the JAX
package (envs/mujoco/locomotion.py's SwimmerRandVelEnv, envs/sawyer.py and
envs/mujoco/scenes.py), all on the engine's generic route.

Each env is reset from JAX-drawn tasks and reset keys (the port takes the
JAX reset's own uniform draws) and stepped 20 times with the same
actions, 3 envs at once, in float32 and in float64; the JAX side is one
jitted scan per env and dtype. In float32 the two packages compute the
same formulas in other summation orders: observations atol 1e-4,
rewards and infos atol 1e-5 of their scale (at least 1; the Sawyer bonus
reaches 1e3). The gaps seen are 7.2e-6 on the swimmer's observations
(its velocities), 6e-8 on the Sawyer ones, and 2e-7 of the scale on the
rewards (pick-and-place's place bonus, 3.8e-5 of 201). In float64 (a
float64 JAX Engine under ``jax.enable_x64``) they agree within 1e-8. The
JAX resets build their states in float32 whatever the mode, so the
float64 run starts both packages from the JAX reset's state.

The swimmer's Trainer iteration is in tests/test_torch_trainer_swimmer.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.envs.mujoco.engine import Engine as JEngine  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402

ENVS = ("SwimmerRandVelEnv", "SawyerPushEnv", "SawyerPushSimpleEnv",
        "SawyerDoorEnv", "SawyerPickAndPlaceEnv")
N, T = 3, 20


def _reset_draw(jenv, key):
    """The JAX reset's own uniform draws, in the port's ``draw`` form."""
    if isinstance(jenv, jenvs.SwimmerRandVelEnv):
        nv = jenv.model.nv
        kq, kv = jax.random.split(key)
        return (jax.random.uniform(kq, (nv,), jnp.float32, -0.1, 0.1),
                jax.random.uniform(kv, (nv,), jnp.float32, -0.1, 0.1))
    if isinstance(jenv, jenvs.SawyerDoorEnv):
        return jax.random.uniform(key, (3,), jnp.float32, -0.02, 0.02)
    ke, ko = jax.random.split(key)
    return (jax.random.uniform(ke, (3,), jnp.float32, -0.02, 0.02),
            jax.random.uniform(ko, (2,), jnp.float32, -0.08, 0.08))


def _jax_episode(jenv):
    """jit(vmap) of reset + T steps: (reset state, obs0, per-step obs,
    rewards, infos, final state)."""
    def one(task, key, actions):
        state0, obs0 = jenv.reset(key, task)

        def body(state, a):
            state, obs, r, _, info = jenv.step(state, a, task, key)
            return state, (obs, r, info)

        final, (obs, rew, info) = jax.lax.scan(body, state0, actions)
        return state0, obs0, obs, rew, info, final
    return jax.jit(jax.vmap(one))


def _jax_steps(jenv):
    """jit(vmap) of T steps from a given state."""
    def one(state, task, key, actions):
        def body(state, a):
            state, obs, r, _, info = jenv.step(state, a, task, key)
            return state, (obs, r, info)
        return jax.lax.scan(body, state, actions)[1]
    return jax.jit(jax.vmap(one))


def _inputs(name):
    jenv = jenvs.make_env(name)
    key = jax.random.PRNGKey(ENVS.index(name))
    kt, kr, ka = jax.random.split(key, 3)
    tasks = jenv.sample_tasks(kt, N)
    keys = jax.random.split(kr, N)
    # wide actions: the control clip acts, and the Sawyer EE reaches
    actions = 1.5 * jax.random.normal(ka, (N, T, jenv.action_dim))
    return jenv, tasks, keys, actions


def _np(x):
    return jax.tree.map(np.asarray, x)


def _port_run(tenv, state, task, actions):
    """T steps of the port's env: (obs, rewards, infos) stacked (N, T)."""
    obs, rew, infos = [], [], []
    for t in range(T):
        state, o, r, d, info = tenv.step(state, actions[:, t], task)
        assert not d.any()
        obs.append(o)
        rew.append(r)
        infos.append(info)
    return (torch.stack(obs, 1), torch.stack(rew, 1),
            {k: torch.stack([i[k] for i in infos], 1) for k in infos[0]})


def _check(got, want, scale_tol, obs_tol):
    obs, rew, info = got
    wobs, wrew, winfo = want
    np.testing.assert_allclose(obs.numpy(), wobs, atol=obs_tol, rtol=0)
    scale = max(1.0, float(np.abs(wrew).max()))
    np.testing.assert_allclose(rew.numpy(), wrew, atol=scale_tol * scale,
                               rtol=0)
    assert set(info) == set(winfo)
    for k, v in winfo.items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(info[k].numpy(), v, rtol=0,
                                   atol=scale_tol * scale, err_msg=k)


@pytest.mark.parametrize("name", ENVS)
def test_reset_and_steps_match_jax_float32(name):
    jenv, tasks, keys, actions = _inputs(name)
    state0, obs0, obs, rew, info, _ = _np(_jax_episode(jenv)(tasks, keys,
                                                             actions))
    draw = jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                        jax.vmap(lambda k: _reset_draw(jenv, k))(keys))
    tenv = tenvs.make_env(name)
    task = torch.tensor(np.asarray(tasks))
    tstate, tobs0 = tenv.reset(task, None, draw)
    # the reset runs no physics
    np.testing.assert_allclose(tobs0.numpy(), obs0, atol=1e-7, rtol=0)
    for k, v in state0.items():
        np.testing.assert_allclose(tstate[k].numpy(), v, atol=1e-7, rtol=0,
                                   err_msg=k)
    assert tstate["q"].dtype == torch.float32
    before = Engine.generic_substeps
    got = _port_run(tenv, tstate, task, torch.tensor(np.asarray(actions)))
    assert Engine.generic_substeps - before == T * tenv.frame_skip
    _check(got, (obs, rew, info), scale_tol=1e-5, obs_tol=1e-4)


@pytest.mark.parametrize("name", ENVS)
def test_steps_match_jax_float64(name):
    jenv, tasks, keys, actions = _inputs(name)
    tenv = tenvs.make_env(name)
    with jax.enable_x64():
        # the JAX env's engine in float64 (its default dtype is float32)
        jenv.__dict__["engine"] = JEngine(
            jenv.model, n_substeps=jenv.engine.n_substeps,
            dtype=jnp.float64)
        tasks, actions = (jnp.asarray(x, jnp.float64) for x in (tasks,
                                                                 actions))
        state0, _ = jax.vmap(jenv.reset)(keys, tasks)
        # pick-and-place's grasp flag in float32, as its step sets it (its
        # reset makes it in the default dtype, float64 here)
        state0 = {k: jnp.asarray(v, jnp.float32 if k == "grasp"
                                 else jnp.float64)
                  for k, v in state0.items()}
        want = _np(_jax_steps(jenv)(state0, tasks, keys, actions))
    tstate = {k: torch.tensor(np.asarray(v)) for k, v in state0.items()}
    assert tstate["q"].dtype == torch.float64
    got = _port_run(tenv, tstate, torch.tensor(np.asarray(tasks)),
                    torch.tensor(np.asarray(actions)))
    assert got[0].dtype == got[1].dtype == torch.float64
    obs, rew, info = got
    np.testing.assert_allclose(obs.numpy(), want[0], atol=1e-8, rtol=0)
    np.testing.assert_allclose(rew.numpy(), want[1], atol=1e-8, rtol=0)
    for k, v in want[2].items():
        np.testing.assert_allclose(info[k].numpy(), v, atol=1e-8, rtol=0,
                                   err_msg=k)


def test_float64_reset_gives_a_float64_state():
    for name in ENVS:
        tenv = tenvs.make_env(name)
        gen = torch.Generator().manual_seed(0)
        task = tenv.sample_tasks(gen, 2, "cpu").double()
        state, obs = tenv.reset(task, gen)
        assert state["q"].dtype == obs.dtype == torch.float64, name


def test_pick_and_place_grasp_attaches_the_object():
    """A state built to grasp: the EE 0.05 above the object (within
    REACH_RADIUS) and the gripper channel closed. The object is held at
    the EE tip plus hold_offset and moves with the EE; with the gripper
    open it is not."""
    jenv = jenvs.make_env("SawyerPickAndPlaceEnv")
    tenv = tenvs.make_env("SawyerPickAndPlaceEnv")
    q = np.array([[0.0, 0.6, 0.12, 0.0, 0.6, 0.07]] * 2, np.float32)
    qd = np.zeros_like(q)
    qd[:, :3] = [0.2, -0.1, 0.3]
    task = np.array([[0.1, 0.6, 0.2]] * 2, np.float32)
    action = np.array([[0.5, 0.0, 0.8, 1.0], [0.5, 0.0, 0.8, -1.0]],
                      np.float32)
    base = dict(q=q, qd=qd, max_push_dist=np.full(2, 0.1, np.float32),
                grasp=np.zeros(2, np.float32),
                max_place_dist=np.full(2, 0.3, np.float32))
    jstate, jobs, jrew, _, jinfo = _np(jax.jit(jax.vmap(
        lambda s, a, t: jenv.step(s, a, t, jax.random.PRNGKey(0))))(
        jax.tree.map(jnp.asarray, base), jnp.asarray(action),
        jnp.asarray(task)))
    tstate, tobs, trew, _, tinfo = tenv.step(
        {k: torch.tensor(v) for k, v in base.items()}, torch.tensor(action),
        torch.tensor(task))
    assert tstate["grasp"].tolist() == [1.0, 0.0]
    assert np.asarray(jstate["grasp"]).tolist() == [1.0, 0.0]
    tq, tqd = tstate["q"].numpy(), tstate["qd"].numpy()
    np.testing.assert_array_equal(tq[0, 3:6], tq[0, :3] + np.float32(
        [0.0, 0.0, -0.07]))
    np.testing.assert_array_equal(tqd[0, 3:6], tqd[0, :3])
    assert np.abs(tq[1, 3:6] - tq[1, :3] - [0.0, 0.0, -0.07]).max() > 1e-3
    np.testing.assert_allclose(tq, jstate["q"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tobs.numpy(), jobs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(trew.numpy(), jrew, rtol=1e-4, atol=1e-4)
    assert tinfo["pickRew"][0] > 0 and tinfo["pickRew"][1] == 0
    for k, v in jinfo.items():
        np.testing.assert_allclose(tinfo[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_swimmer_diagnostics_match_jax():
    """Average/Max/Min/Std of the last-minus-first observation column -3,
    on tests/test_trainer.py's fake samples."""
    rng = np.random.RandomState(0)
    obs = rng.randn(3, 4, 6, 8).astype(np.float32)
    fwd = rng.rand(3, 4, 6).astype(np.float32)
    ctrl = -rng.rand(3, 4, 6).astype(np.float32)
    samples = lambda f: {"observations": f(obs),  # noqa: E731
                         "env_infos": {"reward_fwd": f(fwd),
                                       "reward_ctrl": f(ctrl)}}
    want = jenvs.make_env("SwimmerRandVelEnv").diagnostics(
        samples(jnp.asarray))
    got = tenvs.make_env("SwimmerRandVelEnv").diagnostics(
        samples(torch.tensor))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    progs = obs[..., -1, -3] - obs[..., 0, -3]
    np.testing.assert_allclose(float(got["AverageForwardProgress"]),
                               progs.mean(), rtol=1e-6)
    np.testing.assert_allclose(float(got["MaxForwardProgress"]),
                               progs.max(), rtol=1e-6)
    np.testing.assert_allclose(float(got["StdForwardProgress"]),
                               progs.std(), rtol=1e-5)


def test_sawyer_diagnostics_names():
    infos = {k: torch.ones((2, 3, 4)) for k in
             ("reachDist", "placingDist", "reachRew", "pickRew", "placeRew")}
    out = tenvs.make_env("SawyerPickAndPlaceEnv").diagnostics(
        {"env_infos": infos})
    assert set(out) == {"AverageReachDist", "AveragePlacingDist",
                        "AverageReachRew", "AveragePickRew",
                        "AveragePlaceRew"}


def test_registry_and_spaces():
    for name in ENVS:
        env, jenv = tenvs.make_env(name), jenvs.make_env(name)
        assert (env.obs_dim, env.action_dim) == (jenv.obs_dim,
                                                 jenv.action_dim), name
        assert env.never_done and not env.stochastic_step
        assert env.action_space == tenvs.Box(
            float(jenv.action_space.low), float(jenv.action_space.high),
            tuple(jenv.action_space.shape)), name
