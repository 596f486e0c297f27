"""The port's rand-params envs (promp_tpu_torch.envs.mujoco.rand_params)
and the Walker2d and Hopper envs against the JAX package: the multipliers'
draw, the registry, and the walker's rollout here; the hopper's rollout
and one step of the other envs, through this module's helpers, in
tests/test_torch_rand_params_hopper.py and tests/test_torch_walker_envs.py
(each file's JAX compiles stay near 30 s).

The sampling of ``normalize(Walker2DRandParamsEnv())`` and
``normalize(HopperRandParamsEnv())`` is held against the JAX scan rollout
at 2 tasks x 2 envs x T steps on the same dict tasks, initial reset draws,
every step's auto-reset draws and action noise (drawn as the JAX engine
draws them, test_torch_support.py), with an action noise wide enough that
envs fall and auto-reset inside the window. The two step the same physics
in different float32 forms: the JAX env on the CPU takes the planar
substep (promp_tpu/envs/mujoco/engine.py:742-743), the port K3's plain
version. Tolerances are test_torch_locomotion.py's: observations and
actions atol 1e-4, rewards and infos atol 2e-5; ``dones`` and
``timesteps`` equal. The walker's observations are held at atol 1e-4 plus
rtol 1e-3: as its legs hit the ground at random torques, its joint
velocities (up to the observation's clip at 10) part from JAX's by up to
1.1e-3 absolute, which needs rtol 4.2e-4 (7.5e-5 after one step; the
hopper's stay within 1.4e-5). They part from the JAX package's own
spatial substep on the CPU, the same algebra as the port's, by the same
amounts, so these are float32 ulps amplified by the falls and not the
planar form; the walker's actions (6.3e-5), rewards (8.8e-6) and infos
keep the common bars. The walker ends 6 episodes in the window, the
hopper 2. A done may differ only where the port's state after
the step lies within 1e-4 of a termination threshold (a float tie, as
K1's reward ties): such steps are counted, and that env is compared up to
them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import _jax_draws, torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.envs.mujoco import rand_params as jrp  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.rollout import rollout as jrollout  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.envs.mujoco import rand_params as trp  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import get_model  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.rollout import rollout as trollout  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T = 2, 2, 16
TRAJ_TOL, INFO_TOL = 1e-4, 2e-5
MAX_TIES = 1
OBS_TOL = {"Walker2DRandParamsEnv": dict(atol=TRAJ_TOL, rtol=1e-3),
           "HopperRandParamsEnv": dict(atol=TRAJ_TOL, rtol=0)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_sample_param_multipliers():
    model = get_model("walker2d")
    gen = torch.Generator().manual_seed(0)
    mods = trp.sample_param_multipliers(gen, model, 4000, 3.0)
    want = jax.eval_shape(lambda k: jrp.sample_param_multipliers(
        k, model, 4000, 3.0), jax.random.PRNGKey(0))
    assert set(mods) == set(want) == set(trp.RAND_PARAMS)
    for k, v in mods.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.float32
        base = 1.3 if k == "dof_damping" else 1.5
        lo, hi = float(v.min()), float(v.max())
        assert base ** -3 * (1 - 1e-6) <= lo < base ** -2.9, k
        assert base ** 2.9 < hi <= base ** 3 * (1 + 1e-6), k
        # log-uniform: the median multiplier is near 1
        assert abs(float(torch.log(v).median())) < 0.1, k
    assert tuple(mods["body_inertia"].shape) == (4000, model.nb, 3)
    part = trp.sample_param_multipliers(gen, model, 3, 3.0,
                                        ("friction", "body_mass"))
    assert set(part) == {"friction", "body_mass"}
    again = trp.sample_param_multipliers(torch.Generator().manual_seed(0),
                                         model, 4000, 3.0)
    assert all(torch.equal(mods[k], again[k]) for k in mods)


NAMES = ("HopperRandParamsEnv", "Walker2DRandParamsEnv",
         "WalkerRandParamsWrappedEnv", "HalfCheetahRandParamsEnv",
         "Walker2DRandVelEnv", "Walker2DRandDirecEnv", "HopperEnv")


def test_registry_and_spaces():
    for name in NAMES:
        env, jenv = tenvs.make_env(name), jenvs.make_env(name)
        assert type(env).__name__ == type(jenv).__name__, name
        assert (env.obs_dim, env.action_dim) == (jenv.obs_dim,
                                                 jenv.action_dim), name
        assert env.never_done == getattr(jenv, "never_done", False), name
        assert env.frame_skip == jenv.frame_skip, name
        assert (env.qpos_noise, env.qvel_noise, env.qvel_noise_kind) == (
            jenv.qpos_noise, jenv.qvel_noise, jenv.qvel_noise_kind), name
    gen = torch.Generator().manual_seed(1)
    env = tenvs.normalize(tenvs.make_env("HopperRandParamsEnv"))
    tasks = env.sample_tasks(gen, 3, "cpu")
    assert env.task_event_ndim == {"body_mass": 1, "body_inertia": 2,
                                   "dof_damping": 1, "friction": 0}
    state, obs = env.reset({k: v[:, None].expand((3, 5) + v.shape[1:])
                            for k, v in tasks.items()}, gen)
    assert obs.shape == (3, 5, 11) and state["q"].shape == (3, 5, 6)
    # uniform reset noise on both qpos and qvel
    assert float(state["qd"].abs().max()) <= 0.005
    hop = tenvs.make_env("HopperEnv").sample_tasks(gen, 4, "cpu")
    assert hop.shape == (4, 0)
    assert tenvs.make_env("HopperEnv").reset(hop, gen)[1].shape == (4, 11)


class _Recorder:
    """Wraps an env for ``rollout`` and keeps the q of each step's new
    state."""

    def __init__(self, env):
        self.env, self.q = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action, task):
        out = self.env.step(state, action, task)
        self.q.append(out[0]["q"])
        return out


def _done_margin(name, q):
    """Distance of the post-step qpos from the env's termination
    thresholds, (tasks, envs)."""
    h, a = q[..., 1], q[..., 2]
    if name.startswith("Walker"):
        return torch.stack([(h - 0.8).abs(), (h - 2.0).abs(),
                            (a + 1.0).abs(), (a - 1.0).abs()]).amin(0)
    s = q[..., 2:].abs().amax(-1)
    return torch.stack([(h - 0.7).abs(), (a.abs() - 0.2).abs(),
                        (s - 100.0).abs()]).amin(0)


def rollout_pair(name):
    """(name, the port's rollout, the JAX rollout as numpy, the port's q
    after each step (tasks, envs, T, nv)) of ``normalize(make_env(name))``
    on the same tasks and draws."""
    jenv = jenvs.normalize(jenvs.make_env(name))
    tenv = tenvs.normalize(tenvs.make_env(name))
    obs_dim, act = jenv.obs_dim, jenv.action_dim
    jpol = JPolicy(obs_dim=obs_dim, action_dim=act, hidden_sizes=(8, 8))

    def jax_side(k_params, k_tasks, key):
        params = dict(jpol.init(k_params))
        # a wide action noise (std 12 against the normalized bound 10):
        # the envs fall within T steps
        params["log_std_network/log_std_var"] = jnp.full((1, act), 2.5)
        tparams = jpol.replicate(params, N_T)
        tasks = jenv.sample_tasks(k_tasks, N_T)
        return (tparams, tasks,
                jrollout(jenv, jpol, tparams, tasks, key, N_E, T, True),
                _jax_draws(jenv, tasks, key, "scan", (N_T, N_E, T, act),
                           True))

    # one program for the parameters, tasks, rollout and draws (one
    # compile; eagerly each parameter and task draw compiles its own)
    tparams, tasks, want, draws = jax.jit(jax_side)(
        jax.random.PRNGKey(5), jax.random.PRNGKey(6), jax.random.PRNGKey(13))
    reset_draw, noise, reset_draws = _to_torch(draws)
    tpol = TPolicy(obs_dim=obs_dim, action_dim=act, hidden_sizes=(8, 8))
    recorder = _Recorder(tenv)
    got = trollout(recorder, tpol, from_numpy_params(
        {k: np.asarray(v) for k, v in tparams.items()}, "cpu"),
        _to_torch(tasks), None, N_E, T, reset_draw=reset_draw, noise=noise,
        reset_draws=reset_draws)
    return name, got, jax.tree.map(np.asarray, want), torch.stack(
        recorder.q, 2)


def check_rollout(name, got, want, q_after):
    """Holds a ``rollout_pair`` to the bars of the module docstring."""
    dones = got["dones"].numpy()
    # envs terminate inside the window, so the auto-reset branch runs
    assert dones[..., :-1].any()
    ties = dones != want["dones"]
    margin = _done_margin(name, q_after).numpy()
    assert (margin[ties] < TRAJ_TOL).all(), "a done differs off a tie"
    assert ties.sum() <= MAX_TIES
    # compare each env up to its first tie
    first = np.where(ties.any(-1), ties.argmax(-1), T)
    keep = np.arange(T) <= first[..., None]              # (tasks, envs, T)
    np.testing.assert_array_equal(dones[keep], want["dones"][keep])
    np.testing.assert_array_equal(got["timesteps"].numpy()[keep],
                                  want["timesteps"][keep])
    # the reset runs no physics: the first observations agree to the ulp
    np.testing.assert_allclose(got["observations"][:, :, 0].numpy(),
                               want["observations"][:, :, 0], atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(got["observations"].numpy()[keep],
                               want["observations"][keep], **OBS_TOL[name])
    np.testing.assert_allclose(got["actions"].numpy()[keep],
                               want["actions"][keep], atol=TRAJ_TOL, rtol=0)
    np.testing.assert_allclose(got["rewards"].numpy()[keep],
                               want["rewards"][keep], atol=INFO_TOL, rtol=0)
    assert set(got["env_infos"]) == set(want["env_infos"]) == {
        "forward_vel"}
    np.testing.assert_allclose(got["env_infos"]["forward_vel"].numpy()[keep],
                               want["env_infos"]["forward_vel"][keep],
                               atol=INFO_TOL, rtol=0)
    # an auto-reset starts a new episode at the next step from a fresh state
    t_idx = np.argwhere(dones[..., :-1] & keep[..., 1:])
    assert len(t_idx)
    for i, j, t in t_idx:
        assert got["timesteps"][i, j, t + 1] == 0


class _GivenPhysics:
    """A JAX env whose ``_advance`` returns a given next state: its step
    then runs only the env's own task, reward, observation and termination
    code, with nothing of the physics to compile."""

    def __init__(self, env, next_state):
        self._env, self._next = env, next_state

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _advance(self, state, action, task):
        return self._next


def check_one_step(name, physics=True):
    """One step of ``make_env(name)`` from seeded states against the JAX
    env's step: states and observations atol 1e-4 plus rtol 5e-5 (the
    velocities reach 12.5 after a step, where float32's ulp is 1e-6 and
    the contacts amplify it to 1.6e-4), rewards and infos atol 2e-5, dones
    equal. With ``physics=False`` the JAX step takes the port's next state
    (``_GivenPhysics``), for an env whose physics another check already
    holds against JAX's: the rest of its step is then compared to the
    ulp."""
    jenv, tenv = jenvs.make_env(name), tenvs.make_env(name)
    m = tenv.model
    n = 3
    tasks = jenv.sample_tasks(jax.random.PRNGKey(2), n)
    rng = np.random.default_rng(2)
    q = (m.init_qpos + 0.05 * rng.standard_normal((n, m.nv))).astype(
        np.float32)
    qd = (0.5 * rng.standard_normal((n, m.nv))).astype(np.float32)
    action = rng.uniform(-1.2, 1.2, (n, m.nu)).astype(np.float32)
    got = tenv.step({"q": torch.tensor(q), "qd": torch.tensor(qd)},
                    torch.tensor(action), _to_torch(tasks))
    key = jax.random.PRNGKey(0)
    if physics:
        want = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)))(
            {"q": q, "qd": qd}, action, tasks, key)
    else:
        given = {k: np.asarray(v) for k, v in got[0].items()}
        want = jax.jit(jax.vmap(lambda s, a, t, nxt: type(jenv).step(
            _GivenPhysics(jenv, nxt), s, a, t, key)))(
                {"q": q, "qd": qd}, action, tasks, given)
    want = jax.tree.map(np.asarray, want)
    for g, w in ((got[0]["q"], want[0]["q"]), (got[0]["qd"], want[0]["qd"]),
                 (got[1], want[1])):
        np.testing.assert_allclose(g.numpy(), w, atol=TRAJ_TOL, rtol=5e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=INFO_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert set(got[4]) == set(want[4]) == {"forward_vel"}
    np.testing.assert_allclose(got[4]["forward_vel"].numpy(),
                               want[4]["forward_vel"], atol=INFO_TOL, rtol=0)


@pytest.fixture(scope="module")
def walker_rollouts():
    return rollout_pair("Walker2DRandParamsEnv")


def test_walker_rollout_matches_jax_through_auto_resets(walker_rollouts):
    check_rollout(*walker_rollouts)
