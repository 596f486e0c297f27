"""The port's model specs, Engine and HalfCheetah envs against the JAX
package.

The cheetah's sampling is held against the JAX scan rollout at 2 tasks x
2 envs x 5 steps on the same reset draws and action noise (drawn as the JAX
engine draws them, test_torch_support.py). The two step the same physics
in different float32 forms: the JAX env on the CPU takes the planar
substep (promp_tpu/envs/mujoco/engine.py:742-743), the port the emitted
spatial substep (K2's plain version), and the gap compounds through the
contacts. Tolerances: observations and actions atol 1e-4, rewards, infos
and diagnostics atol 2e-5 (the gaps seen are at most 1.2e-5 and 2.1e-6
over 5 steps); the reset, which runs no physics, agrees to 1e-7.
"""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import _round_draws, torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.envs.mujoco import model as jmodel  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.rollout import rollout as jrollout  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.envs.mujoco import model as tmodel  # noqa: E402
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.sampling.rollout import rollout as trollout  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402

MODELS = ("ant", "half_cheetah", "hopper", "humanoid", "swimmer", "walker2d")
N_T, N_E, T = 2, 2, 5
TRAJ_TOL, INFO_TOL = 1e-4, 2e-5


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax_field_by_field(name):
    want, got = jmodel.get_model(name), tmodel.get_model(name)
    assert filecmp.cmp(os.path.join(jmodel._SPEC_DIR, f"{name}.npz"),
                       os.path.join(tmodel._SPEC_DIR, f"{name}.npz"),
                       shallow=False)
    for field in jmodel.ChainModel.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        else:
            assert type(a) is type(b) and a == b, field
    assert got.name == name and (got.nv, got.nb, got.nu) == (want.nv, want.nb,
                                                             want.nu)


def test_missing_spec_raises():
    with pytest.raises(FileNotFoundError, match="no model spec 'ant_v9'"):
        tmodel.get_model("ant_v9")


def test_actuation_clips_and_applies_gear_at_act_dof():
    eng = Engine(tmodel.get_model("half_cheetah"))
    m = eng.model
    ctrl = torch.tensor(np.random.default_rng(0).uniform(
        -3, 3, (2, 3, m.nu)).astype(np.float32))
    tau = eng.actuation(ctrl).numpy()
    want = np.zeros((2, 3, m.nv), np.float32)
    want[..., list(m.act_dof)] = m.act_gear.astype(np.float32) * np.clip(
        ctrl.numpy(), m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
    np.testing.assert_array_equal(tau, want)
    assert (tau[..., :3] == 0).all() and (np.abs(tau) > 0).any()


def test_step_clips_ctrl_and_keeps_the_batch_shape():
    eng = Engine(tmodel.get_model("half_cheetah"))
    rng = np.random.default_rng(1)
    q = torch.tensor(0.1 * rng.standard_normal((2, 3, 9)).astype(np.float32))
    qd = torch.tensor(rng.standard_normal((2, 3, 9)).astype(np.float32))
    ctrl = torch.tensor(rng.uniform(-3, 3, (2, 3, 6)).astype(np.float32))
    q2, qd2 = eng.step(q, qd, ctrl, 5)
    assert q2.shape == q.shape and qd2.shape == qd.shape
    q3, qd3 = eng.step(q, qd, torch.clamp(ctrl, -1.0, 1.0), 5)
    assert torch.equal(q2, q3) and torch.equal(qd2, qd3)
    # the flattened batch steps row by row
    q4, _ = eng.step(q[1, 2], qd[1, 2], ctrl[1, 2], 5)
    assert torch.equal(q4, q2[1, 2])


def test_step_refuses_mods_and_bodies_it_does_not_cover():
    # K3 takes the four rand-params keys; any other mod key raises
    eng = Engine(tmodel.get_model("half_cheetah"))
    q = torch.zeros((1, 9))
    with pytest.raises(NotImplementedError,
                       match="'half_cheetah'.*mod key 'geom_friction'"):
        eng.step(q, q, torch.zeros((1, 6)), 5,
                 mods={"body_mass": torch.ones((1, 7)),
                       "geom_friction": torch.ones((1, 9, 3))})
    swim = Engine(tmodel.get_model("swimmer"))
    nv, nu = swim.model.nv, swim.model.nu
    with pytest.raises(NotImplementedError, match="'swimmer'.*spatial_ok"):
        swim.step(torch.zeros((1, nv)), torch.zeros((1, nv)),
                  torch.zeros((1, nu)), 4)


def test_registry_and_spaces():
    for name in ("HalfCheetahRandVelEnv", "HalfCheetahRandDirecEnv"):
        env, jenv = tenvs.make_env(name), jenvs.make_env(name)
        assert (env.obs_dim, env.action_dim) == (jenv.obs_dim,
                                                 jenv.action_dim) == (17, 6)
        assert env.action_space == tenvs.Box(-1.0, 1.0, (6,))
        assert env.never_done and not env.stochastic_step


def test_tasks_and_reset_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    vel = tenvs.make_env("HalfCheetahRandVelEnv").sample_tasks(gen, 500,
                                                               "cpu")
    assert vel.shape == (500,) and 0 <= vel.min() and vel.max() < 3
    assert vel.min() < 0.1 and vel.max() > 2.9
    direc = tenvs.make_env("HalfCheetahRandDirecEnv").sample_tasks(
        gen, 500, "cpu")
    assert set(direc.tolist()) == {-1.0, 1.0}
    env = tenvs.make_env("HalfCheetahRandVelEnv")
    state, obs = env.reset(vel[:6].reshape(2, 3), gen)
    init = torch.as_tensor(env.model.init_qpos, dtype=torch.float32)
    assert obs.shape == (2, 3, 17) and state["q"].shape == (2, 3, 9)
    assert (state["q"] - init).abs().max() <= 0.1
    assert torch.equal(obs, torch.cat([state["q"][..., 1:], state["qd"]],
                                      -1))


def test_direc_reward_is_direction_times_velocity():
    env = tenvs.make_env("HalfCheetahRandDirecEnv")
    gen = torch.Generator().manual_seed(1)
    task = torch.tensor([1.0, -1.0])
    state, _ = env.reset(task, gen)
    action = torch.rand((2, 6), generator=gen) * 2 - 1
    _, _, reward, done, info = env.step(state, action, task)
    assert not done.any() and set(info) == {"reward_run", "reward_ctrl"}
    ctrl = -0.05 * torch.sum(action ** 2, -1)
    np.testing.assert_allclose(info["reward_ctrl"], ctrl, rtol=1e-6)
    np.testing.assert_allclose(reward, info["reward_ctrl"] + info[
        "reward_run"], rtol=1e-6)
    # the same state, either direction: the run rewards are opposite
    _, _, _, _, flipped = env.step(state, action, -task)
    assert torch.equal(flipped["reward_run"], -info["reward_run"])


@pytest.fixture(scope="module")
def rollouts():
    jenv = jenvs.make_env("HalfCheetahRandVelEnv")
    tenv = tenvs.make_env("HalfCheetahRandVelEnv")
    jpol = JPolicy(obs_dim=17, action_dim=6, hidden_sizes=(8, 8))
    params = dict(jpol.init(jax.random.PRNGKey(4)))
    # a wide action noise so that the ctrl clip and the contacts both act
    params["log_std_network/log_std_var"] = jnp.full((1, 6), 0.5)
    tparams = jpol.replicate(params, N_T)
    tasks = jnp.array([0.7, 2.4], jnp.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(jrollout, static_argnums=(0, 1, 5, 6, 7))(
        jenv, jpol, tparams, tasks, key, N_E, T, True)
    reset_draw, noise = _round_draws(jenv, tasks, key, "scan",
                                     (N_T, N_E, T, 6))
    tpol = TPolicy(obs_dim=17, action_dim=6, hidden_sizes=(8, 8))
    got = trollout(tenv, tpol, from_numpy_params(
        {k: np.asarray(v) for k, v in tparams.items()}, "cpu"),
        torch.tensor(np.asarray(tasks)), None, N_E, T, reset_draw=reset_draw,
        noise=noise)
    return jenv, tenv, got, want


def test_rollout_matches_jax(rollouts):
    _, _, got, want = rollouts
    # the reset runs no physics: the first observations agree to the ulp
    # (XLA may fuse the uniform draw's affine map into its own rounding)
    np.testing.assert_allclose(got["observations"][:, :, 0].numpy(),
                               np.asarray(want["observations"])[:, :, 0],
                               atol=1e-7, rtol=0)
    for k in ("observations", "actions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TRAJ_TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["rewards"].numpy(),
                               np.asarray(want["rewards"]), atol=INFO_TOL,
                               rtol=0)
    assert set(got["env_infos"]) == set(want["env_infos"]) == {
        "forward_vel", "reward_run", "reward_ctrl"}
    for k, v in want["env_infos"].items():
        np.testing.assert_allclose(got["env_infos"][k].numpy(),
                                   np.asarray(v), atol=INFO_TOL, rtol=0,
                                   err_msg=k)
    assert not got["dones"].any()
    # the actions leave the control range, so the Engine's clip acts
    assert got["actions"].abs().max() > 1.5


def test_diagnostics_match_jax(rollouts):
    jenv, tenv, got, want = rollouts
    jd = jenv.diagnostics({"env_infos": want["env_infos"]})
    td = tenv.diagnostics({"env_infos": got["env_infos"]})
    assert set(td) == set(jd) == {
        "AvgForwardVel", "AvgFinalForwardVel", "AvgCtrlCost",
        "Env-forward_vel", "Env-reward_run", "Env-reward_ctrl"}
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), atol=INFO_TOL,
                                   rtol=0, err_msg=k)
    # the reference's quirk: AvgCtrlCost is the std of the control cost
    ctrl = -got["env_infos"]["reward_ctrl"].numpy()
    np.testing.assert_allclose(float(td["AvgCtrlCost"]), ctrl.std(),
                               rtol=1e-5)
