"""K1's plain version (promp_tpu_torch.ops.rollout_kernel) against the
Pallas kernel promp_tpu.ops.pallas_rollout in interpret mode, as
tests/test_pallas.py runs it, at 3 tasks x 8 envs x 25 steps with the same
noise (drawn as pallas_rollout.py:112 draws it).

Tolerances (float32): obs, actions and means atol 1e-4 over the 25-step
trajectory (matmul summation order differs; the error compounds through
the state), per-step quantities 1e-5; rewards 1e-5 where both take the
same branch. A branch flip is allowed only at a float tie (tie margin
under 1e-5) or where the reference zeroes a reward the port pays at its
goal corner (see test_torch_support.py), and flips are counted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    check_reward_flips, torch_single_thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.ops.pallas_rollout import pallas_pointmass_rollout  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy  # noqa: E402
from promp_tpu_torch.ops import nvcc_build  # noqa: E402
from promp_tpu_torch.ops import rollout_kernel as rk  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T = 3, 8, 25
TRAJ, STEP = 1e-4, 1e-5


@pytest.fixture(scope="module")
def runs():
    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=(64, 64))
    tp = dict(policy.replicate(policy.init(jax.random.PRNGKey(0)), N_T))
    # per-task output biases drive the point out of the L1 dead zone, so
    # both reward branches are taken
    tp["mean_network/output/bias"] = jnp.array(
        [[6.0, 5.0], [-7.0, 4.0], [3.0, -6.0]], jnp.float32)
    tp["log_std_network/log_std_var"] = jnp.array(
        [[[0.0, -0.5]], [[0.3, 0.1]], [[-1.0, 0.0]]], jnp.float32)
    goals = jnp.array([[2.0, 2.0], [-2.0, 2.0], [-2.0, -2.0]], jnp.float32)
    obs0 = jax.random.uniform(jax.random.PRNGKey(2), (N_T, N_E, 2),
                              jnp.float32, -0.2, 0.2)
    key = jax.random.PRNGKey(9)
    want = pallas_pointmass_rollout(tp, goals, obs0, key, horizon=T,
                                    interpret=True)
    noise = jax.random.normal(key, (N_T, T, N_E, 2), jnp.float32)
    args = (from_numpy_params({k: np.asarray(v) for k, v in tp.items()},
                              "cpu"),
            torch.tensor(np.asarray(goals)), torch.tensor(np.asarray(obs0)),
            torch.tensor(np.asarray(noise)))
    return args, rk.pointmass_rollout(*args), want


def test_trajectory_matches_pallas(runs):
    _, got, want = runs
    for k, tol in (("observations", TRAJ), ("actions", TRAJ)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, rtol=0, err_msg=k)
    for k in ("mean", "log_std"):
        np.testing.assert_allclose(got["agent_infos"][k].numpy(),
                                   np.asarray(want["agent_infos"][k]),
                                   atol=TRAJ, rtol=0, err_msg=k)
    # step by step: each step's mean from that step's obs agrees per op
    err = (got["actions"] - got["agent_infos"]["mean"]).numpy() - (
        np.asarray(want["actions"]) - np.asarray(want["agent_infos"]["mean"]))
    assert np.abs(err).max() < STEP


def test_rewards_match_where_the_branch_agrees(runs):
    args, got, want = runs
    g, w = got["rewards"].numpy(), np.asarray(want["rewards"])
    flips = check_reward_flips(got, w, args[1])
    np.testing.assert_allclose(g[~flips], w[~flips], atol=STEP, rtol=0)
    # a handful of goal-corner flips in 600 steps are expected (1 at this
    # seed)
    assert flips.sum() <= 3, f"{flips.sum()} reward-branch flips"
    assert 0.2 < (w != 0).mean() < 0.9  # both branches exercised


def test_cpu_runs_the_plain_version_and_counts_no_launch(runs):
    args, got, _ = runs
    before = rk.pointmass_rollout.launches
    plain = rk.pointmass_rollout_plain(*args)
    again = rk.pointmass_rollout(*args)
    assert rk.pointmass_rollout.launches == before
    for k in ("observations", "actions", "rewards"):
        assert torch.equal(plain[k], got[k]) and torch.equal(again[k], got[k])
    assert got["observations"].shape == (N_T, N_E, T, 2)
    assert got["rewards"].shape == (N_T, N_E, T)


def test_wrapper_rejects_bad_inputs(runs):
    (params, goals, obs0, noise), _, _ = runs
    with pytest.raises(ValueError, match="shape"):
        rk.pointmass_rollout(params, goals, obs0, noise[:, :, :4])
    with pytest.raises(ValueError, match="float32"):
        rk.pointmass_rollout(params, goals.double(), obs0, noise)
    with pytest.raises(ValueError, match="contiguous"):
        rk.pointmass_rollout(params, goals, obs0,
                             noise.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        rk.pointmass_rollout(params, goals.to("meta"), obs0, noise)
    with pytest.raises(ValueError, match="1025 envs"):
        rk.pointmass_rollout(params, goals, torch.zeros((N_T, 1025, 2)),
                             noise)


def test_missing_nvcc_names_the_search(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda")
    monkeypatch.setattr(nvcc_build.os, "access", lambda *a: False)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda *a: None)
    with pytest.raises(RuntimeError, match="/nonexistent/cuda/bin/nvcc.*"
                       "/usr/local/cuda/bin/nvcc.*PATH"):
        nvcc_build.find_nvcc()


def test_tie_margin():
    goals = torch.tensor([[2.0, 2.0]])
    # the new position x = 0 is equidistant from the goal (2, 2) and the
    # corner (-2, 2); an action of 5 moves by +0.1 after the affine
    tie = rk.reward_tie_margin(torch.tensor([[[[-0.1, 1.5]]]]),
                               torch.tensor([[[[5.0, 0.0]]]]), goals)
    # far from the radius; the nearest corner (-2, 2) is not the goal
    clear = rk.reward_tie_margin(torch.tensor([[[[-1.0, 1.0]]]]),
                                 torch.tensor([[[[0.0, 0.0]]]]), goals)
    # the goal is the nearest corner by far: K1's comparison of the goal's
    # distance with the goal corner's is no tie
    at_goal = rk.reward_tie_margin(torch.tensor([[[[1.5, 1.5]]]]),
                                   torch.tensor([[[[0.0, 0.0]]]]), goals)
    assert float(tie) < 1e-6 and float(clear) > 0.1
    assert float(at_goal) > 2.0
