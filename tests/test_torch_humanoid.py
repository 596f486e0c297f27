"""The port's Humanoid envs (promp_tpu_torch.envs.mujoco.humanoid) and the
engine's kinematics and contact forces on the humanoid against the JAX
package, by tests/test_torch_ant.py's helpers and at its bars: the plain
K2 chain against the JAX spatial substep (one substep, eagerly), and the
envs on the port's own physics through a rollout that auto-resets.

The rollout runs HumanoidRandDirecEnv at 2 tasks x 2 envs x 3 steps. The
first env of each task starts at the top of the healthy band (z 1.99)
rising at 2 m/s, so it leaves [1, 2] at the first step and auto-resets;
the others start from JAX's reset draws. Every step and every reset state
goes through the JAX step of both humanoid envs with the port's next
state (``_GivenPhysics``), which also checks ``last_tau`` (the
observation's qfrc_actuator) in the state after each step and after each
auto-reset.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ant import (  # noqa: E402
    OBS_TOL, _jax_tasks, check_chain, check_diagnostics, check_pieces,
    check_registry, check_step_outputs, entries, extra_states,
    jax_reference, record_rollout, reset_draws_from_keys, step_infos)
from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402

NAMES = ("HumanoidRandDirecEnv", "HumanoidRandDirec2DEnv")
N_T, N_E, HORIZON = 2, 2, 3
INFOS = {"reward_linvel", "reward_quadctrl", "reward_alive",
         "reward_impact"}


def test_registry_spaces_and_tasks():
    check_registry(NAMES)
    env = tenvs.make_env("HumanoidRandDirecEnv")
    assert (env.obs_dim, env.action_dim) == (376, 17)


def test_plain_chain_matches_jax_spatial_substep():
    check_chain("HumanoidRandDirecEnv", 1)


@pytest.fixture(scope="module")
def run():
    jenv = jenvs.make_env("HumanoidRandDirecEnv")
    draw, reset_states = reset_draws_from_keys(jenv, jax.random.PRNGKey(3),
                                               (N_T, N_E))
    # the first env of each task rises out of the healthy band
    start = (draw[0].clone(), draw[1].clone())
    start[0][:, 0, 2] = 0.59
    start[1][:, 0, 2] = 2.0
    step_draws = reset_draws_from_keys(jenv, jax.random.PRNGKey(4),
                                       (HORIZON, N_T, N_E), states=False)
    rolled, recorder, _ = record_rollout(
        "HumanoidRandDirecEnv", N_T, N_E, HORIZON, start, step_draws, seed=4)
    # the reset states: the initial ones and those after each auto-reset
    calls = recorder.calls
    done = [c[2][3] for c in calls]
    resets = [{k: calls[0][0][k].reshape(-1, calls[0][0][k].shape[-1])
               for k in ("q", "qd")}]
    for t in range(1, HORIZON):
        resets.append({k: calls[t][0][k][done[t - 1]] for k in ("q", "qd")})
    resets = {k: torch.cat([r[k] for r in resets]) for k in ("q", "qd")}
    engine = tenvs.make_env("HumanoidRandDirecEnv").engine
    states, actions, nexts, n, n_reset = entries(
        recorder, resets, extra_states(engine, resets, 6))
    tasks = [_jax_tasks(jenvs.make_env(name), jax.random.PRNGKey(7 + i),
                        len(actions)) for i, name in enumerate(NAMES)]
    want = jax_reference(NAMES, states, actions, nexts, tasks, jit=False)
    step_in = {k: v[:n] for k, v in states.items()}
    got = {name: tenvs.make_env(name).step(step_in, actions[:n],
                                           torch.tensor(task[:n]))
           for name, task in zip(NAMES, tasks)}
    return dict(draw=draw, reset_states=reset_states, rolled=rolled,
                calls=calls, done=done, states=states, nexts=nexts, n=n,
                n_reset=n_reset, tasks=tasks, want=want, got=got)


def test_reset_matches_jax(run):
    env = tenvs.make_env("HumanoidRandDirecEnv")
    state, obs = env.reset(torch.ones((N_T, N_E)), None, run["draw"])
    for k in ("q", "qd", "last_tau"):
        np.testing.assert_allclose(state[k].numpy(),
                                   run["reset_states"][k].numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)
    assert not state["last_tau"].any()
    assert obs.shape == (N_T, N_E, 376)


def test_steps_match_jax(run):
    n = run["n"]
    for name in NAMES:
        check_step_outputs(name, run["got"][name], run["want"][name], n,
                           INFOS)
    # the observation of every reset and extra state (last_tau 0)
    for name, tasks in zip(NAMES, run["tasks"]):
        state = {k: v[n:] for k, v in run["states"].items()}
        obs = tenvs.make_env(name)._obs(state, torch.tensor(tasks[n:]))
        np.testing.assert_allclose(obs.numpy(), run["want"][name][1][n:],
                                   **OBS_TOL)


def test_auto_reset_carries_last_tau(run):
    """Through the rollout's auto-reset: the done envs restart from their
    reset draw with last_tau 0 and the JAX reset observation; the others
    carry the step's last_tau."""
    rolled, calls, done = run["rolled"], run["calls"], run["done"]
    assert done[0][:, 0].all() and not done[0][:, 1].any()
    want_obs = run["want"]["HumanoidRandDirecEnv"][1]
    at, n = run["n"] + N_T * N_E, 0
    np.testing.assert_allclose(
        rolled["observations"][:, :, 0].reshape(N_T * N_E, -1).numpy(),
        want_obs[run["n"]:at], **OBS_TOL)
    for t in range(1, HORIZON):
        state_t = calls[t][0]
        prev = calls[t - 1][2][0]
        d = done[t - 1]
        assert not state_t["last_tau"][d].any()
        assert torch.equal(state_t["last_tau"][~d], prev["last_tau"][~d])
        k = int(d.sum())
        np.testing.assert_allclose(rolled["observations"][:, :, t][d].numpy(),
                                   want_obs[at + n:at + n + k], **OBS_TOL)
        assert (rolled["timesteps"][:, :, t][d] == 0).all()
        n += k
    assert n >= N_T


def test_engine_matches_jax(run):
    check_pieces(tenvs.make_env("HumanoidRandDirecEnv"), run["nexts"],
                 run["want"]["engine"])


def test_diagnostics_match_jax(run):
    for name in NAMES:
        check_diagnostics(name, step_infos(run["got"][name][4], HORIZON,
                                           N_T, N_E))
