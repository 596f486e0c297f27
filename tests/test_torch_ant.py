"""The port's Ant envs (promp_tpu_torch.envs.mujoco.ant), rotations and
the engine's kinematics and contact forces against the JAX package, on the
ant; the humanoid's in tests/test_torch_humanoid.py, through this module's
helpers.

* Rotations: every function of rotations.py on seeded inputs, atol 1e-6.
* ``ancestor_mask`` of every model: equal.
* The plain K2 chain (ops/substep_kernel.py) against the JAX package's
  spatial substep (promp_tpu/envs/mujoco/spatial.py, run eagerly: the
  same emitted algebra; its jitted program takes minutes to compile on
  the CPU and Pallas interpret mode longer still) for ``N_SUB`` substeps
  at B = 8 seeded states, with contacts active: q atol 1e-6 / rtol 1e-5,
  qd atol 1e-4 / rtol 1e-4 (the bars of tests/test_torch_spatial.py,
  against the same algebra).
* The envs: a port rollout (``rollout`` with a small policy and pre-drawn
  action noise and reset draws) records every step's input state, action
  and output. The JAX env's ``step`` then runs on each recorded input
  with ``_advance`` returning the port's next state (``_GivenPhysics``, a
  test-local wrapper: nothing of the JAX package changes and no JAX
  physics runs over the rollout), for every env class of the body on the
  same states and its own tasks; the reset states go through it too, as
  entries whose next state is the reset state and whose action is zero,
  which gives the JAX package's observation of that state. The same
  program returns the JAX engine's ``fk``, body Jacobians,
  ``body_velocities``, ``_contact_terms`` (also with per-entry ground
  friction multipliers through ``_phys``), ``contact_torque`` and
  ``contact_wrench`` at every next state, among them states lifted clear
  of the ground: one JAX compile a module. Bars: observations and the
  engine's outputs atol 1e-5 plus rtol 1e-5 (positions of order 1 and
  contact forces of order 1e4 computed in other float32 orders; gaps seen
  are below 1.5e-7 on positions and 1e-7 relative on forces), rewards and
  infos atol 2e-5 plus rtol 1e-5, dones equal, the reset states to the
  ulp (the same draws, no physics; the JAX package's come from its own
  ``reset`` with the observation left out by a test-local subclass).
  The JAX side is jitted on the ant and runs eagerly on the humanoid,
  whose compiled ``fk`` XLA:CPU runs slower than op-by-op dispatch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_rand_params import _GivenPhysics  # noqa: E402
from test_torch_support import locomotion_reset_draw, torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.envs.mujoco import rotations as jrot  # noqa: E402
from promp_tpu.envs.mujoco import spatial as jspatial  # noqa: E402
from promp_tpu.envs.mujoco.engine import Engine as JEngine  # noqa: E402
from promp_tpu.envs.mujoco.model import get_model as jget_model  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.envs.mujoco import rotations as trot  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import available_models, get_model  # noqa: E402
from promp_tpu_torch.ops import substep_kernel as sk  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.rollout import rollout as trollout  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_SUB, B = 1, 8
Q_TOL, QD_TOL = dict(atol=1e-6, rtol=1e-5), dict(atol=1e-4, rtol=1e-4)
OBS_TOL = dict(atol=1e-5, rtol=1e-5)
REWARD_TOL = dict(atol=2e-5, rtol=1e-5)
ANT_ENVS = ("AntRandGoalEnv", "AntRandDirecEnv", "AntRandDirec2DEnv")


# ------------------------------------------------------------- rotations
def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.standard_normal((5, 4)).astype(np.float32)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, (3, 5)).astype(np.float32)
    t = torch.tensor
    pairs = [
        (trot.quat_mul(t(q), t(q2)), jrot.quat_mul(q, q2)),
        (trot.quat_rotate(t(q), t(v)), jrot.quat_rotate(q, v)),
        (trot.quat_inv(t(q)), jrot.quat_inv(q)),
        (trot.quat_from_axis_angle(t(axis), t(ang[0])),
         jrot.quat_from_axis_angle(axis, ang[0])),
        (trot.quat_to_mat(t(q)), jrot.quat_to_mat(q)),
        (trot.quat_from_euler_xyz(*map(t, ang)),
         jrot.quat_from_euler_xyz(*ang)),
        (torch.stack(trot.euler_xyz_from_quat(t(q))),
         jnp.stack(jrot.euler_xyz_from_quat(q))),
        # a shared axis against a batch of angles, as the kinematics use it
        (trot.quat_from_axis_angle(t(axis[0]), t(ang[1])),
         jrot.quat_from_axis_angle(axis[0], ang[1])),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_ancestor_mask_matches_jax():
    for name in available_models():
        model = get_model(name)
        got = model.ancestor_mask()
        np.testing.assert_array_equal(got, jget_model(name).ancestor_mask())
        # computed once a model, and read-only
        assert model.ancestor_mask() is got and not got.flags.writeable


# ------------------------------------------------------------- the chain
def contact_height(engine):
    """The root height at which the initial pose's lowest contact sphere
    touches the ground (the port's kinematics, held against JAX's
    below)."""
    m = engine.model
    q = torch.tensor(m.init_qpos, dtype=torch.float32)
    points = engine._contact_points(engine.fk(q))
    gap = points[:, 2] - torch.tensor(m.con_radius)
    return float(m.init_qpos[2] - gap.min())


def chain_states(engine, seed, n=B):
    """Seeded states about the initial pose, the root's height within
    [-0.05, 0.1] of ``contact_height``: some spheres in contact, some
    clear."""
    m = engine.model
    rng = np.random.default_rng(seed)
    q = (m.init_qpos + 0.1 * rng.standard_normal((n, m.nv))).astype(
        np.float32)
    q[:, 2] = contact_height(engine) + rng.uniform(-0.05, 0.1, n)
    qd = rng.standard_normal((n, m.nv)).astype(np.float32)
    tau = (20.0 * rng.standard_normal((n, m.nv))).astype(np.float32)
    return q, qd, tau


def check_chain(env_name, n_sub, seed=0):
    """The plain K2 chain of ``make_env(env_name)``'s engine for ``n_sub``
    substeps against the JAX spatial substep, eagerly, under the module's
    bars; contacts act."""
    tenv, jenv = tenvs.make_env(env_name), jenvs.make_env(env_name)
    q, qd, tau = chain_states(tenv.engine, seed)
    h = np.float32(tenv.model.timestep / tenv.n_substeps)
    substep = jspatial.make_spatial_substep(jenv.engine)
    step = jax.vmap(lambda a, b, c: substep(a, b, c, h, None))
    qj, qdj = q, qd
    for _ in range(n_sub):
        qj, qdj = step(qj, qdj, tau)
    probe = []
    qp, qdp = sk.substep_chain_plain(tenv.engine, n_sub)(
        torch.tensor(q), torch.tensor(qd), torch.tensor(tau), probe)
    assert np.isfinite(np.asarray(qdj)).all()
    np.testing.assert_allclose(qp.numpy(), np.asarray(qj), **Q_TOL)
    np.testing.assert_allclose(qdp.numpy(), np.asarray(qdj), **QD_TOL)
    n_con = len(tenv.model.con_body)
    active = torch.stack(probe[:n_con])           # (nc, B), first substep
    assert active.any() and not active.all()


def test_plain_chain_matches_jax_spatial_substep():
    check_chain("AntRandGoalEnv", N_SUB)


# -------------------------------------------------------------- the envs
class StepRecorder:
    """Wraps an env for ``rollout`` and keeps each step's (input state,
    action, output)."""

    def __init__(self, env):
        self.env, self.calls = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action, task):
        out = self.env.step(state, action, task)
        self.calls.append((state, action, out))
        return out


def _cat(trees):
    """A list of equally-keyed dicts of (..., k) tensors -> one dict of
    (N, k) tensors, flattening the leading axes."""
    return {k: torch.cat([t[k].reshape((-1,) + t[k].shape[-1:])
                          for t in trees]) for k in trees[0]}


def _jax_tasks(jenv, key, n):
    return np.asarray(jenv.sample_tasks(key, n))


def record_rollout(name, n_t, n_e, horizon, reset_draw, reset_draws, seed):
    """A port rollout of ``make_env(name)`` at n_t x n_e x horizon with a
    (8, 8) policy (wide action noise), the given reset draws and seeded
    action noise. Returns (rollout, recorder, tasks (JAX's, numpy))."""
    tenv, jenv = tenvs.make_env(name), jenvs.make_env(name)
    tasks = _jax_tasks(jenv, jax.random.PRNGKey(seed), n_t)
    pol = TPolicy(obs_dim=tenv.obs_dim, action_dim=tenv.action_dim,
                  hidden_sizes=(8, 8))
    rng = np.random.default_rng(seed)
    params = pol.init(torch.Generator().manual_seed(seed), "cpu")
    params = {k: np.repeat(v.numpy()[None], n_t, 0)
              for k, v in params.items()}
    params["log_std_network/log_std_var"][:] = np.log(0.5)
    noise = torch.tensor(rng.standard_normal(
        (horizon, n_t, n_e, tenv.action_dim)).astype(np.float32))
    recorder = StepRecorder(tenv)
    got = trollout(recorder, pol, from_numpy_params(params, "cpu"),
                   torch.tensor(tasks), None, n_e, horizon,
                   reset_draw=reset_draw, noise=noise,
                   reset_draws=reset_draws)
    return got, recorder, tasks


def reset_draws_from_keys(jenv, key, shape, states=True):
    """The port's reset draws for a ``shape`` batch of reset keys split
    from ``key``, as the JAX reset draws them, and (``states``) JAX's
    reset states."""
    n = int(np.prod(shape))
    keys = jax.random.split(key, n)
    draw = jax.vmap(lambda k: locomotion_reset_draw(jenv, k))(keys)
    shaped = lambda a: torch.tensor(np.asarray(a)).reshape(
        shape + a.shape[1:])
    draw = tuple(shaped(d) for d in draw)
    if not states:
        return draw
    # the JAX reset's own states, its observation left out (a test-local
    # subclass); the observations of the reset states are held through
    # ``jax_reference``
    no_obs = type("NoObs", (type(jenv),),
                  {"_obs": lambda self, state, task=None: jnp.zeros(())})()
    states = jax.jit(jax.vmap(lambda k: no_obs.reset(k, None)[0]))(keys)
    return draw, {k: shaped(v) for k, v in states.items()}


def extra_states(engine, reset_states, seed):
    """States for the engine's check: the reset states lifted 1 m clear of
    the ground, and seeded states about the contact height
    (``chain_states``)."""
    lifted = dict(reset_states, q=reset_states["q"].clone())
    lifted["q"][..., 2] += 1.0
    q, qd, _ = chain_states(engine, seed)
    return [lifted, {"q": torch.tensor(q), "qd": torch.tensor(qd)}]


def entries(recorder, reset_states, extras):
    """The batch that the JAX step takes: every recorded step (input
    state, action, the port's next state), then each reset state and each
    state of ``extras`` as an entry whose next state is itself and whose
    action is zero. Returns (states, actions, nexts, n_steps, n_resets)."""
    nu = recorder.calls[0][1].shape[-1]
    keep = ("q", "qd")
    states = [{k: s[k] for k in keep} for s, _, _ in recorder.calls]
    nexts = [{k: o[0][k] for k in keep} for _, _, o in recorder.calls]
    actions = [a.reshape(-1, nu) for _, a, _ in recorder.calls]
    n_steps = sum(len(a) for a in actions)
    resets = {k: reset_states[k] for k in keep}
    for extra in (resets, *extras):
        extra = {k: extra[k].reshape(-1, extra[k].shape[-1]) for k in keep}
        states.append(extra)
        nexts.append(extra)
        actions.append(torch.zeros((len(extra["q"]), nu)))
    n_resets = resets["q"].shape[:-1].numel()
    return (_cat(states), torch.cat(actions), _cat(nexts), n_steps,
            n_resets)


def friction_mults(n):
    """Per-entry multipliers of the ground friction, for the contact terms
    through ``_phys``."""
    return np.linspace(0.5, 2.0, n).astype(np.float32)


def engine_pieces(engine, q, qd, friction):
    """What the port's or the JAX engine returns at (q, qd): fk, the body
    Jacobians, body_velocities, _contact_terms (also with the ground
    friction scaled by ``friction``, a rand-params mod), contact_torque
    and contact_wrench, a flat dict."""
    kin = engine.fk(q)
    out = {f"fk_{k}": v for k, v in kin.items()}
    if isinstance(q, torch.Tensor):
        Jp, Jr = engine._body_jacobians(kin)
    else:
        Jp, Jr = engine._body_jacobians(
            kin, jnp.asarray(engine.model.ancestor_mask()))
    out.update(Jp=Jp, Jr=Jr)
    out["v"], out["w"] = engine.body_velocities(q, qd)
    names = ("tau", "force", "J", "cn_eff", "ct_eff", "kn_eff")
    for k, v in zip(names, engine._contact_terms(q, qd)):
        out[f"contact_{k}"] = v
    for k, v in zip(names, engine._contact_terms(
            q, qd, {"friction": friction})):
        out[f"contact_friction_mod_{k}"] = v
    out["torque_tau"], out["torque_force"] = engine.contact_torque(q, qd)
    out["wrench"] = engine.contact_wrench(q, qd)
    return out


class TracedOnce(JEngine):
    """The JAX engine with ``fk`` and ``_contact_terms`` computed once for
    the same arrays within one program (a test-local subclass; the JAX env
    calls them several times a step on the same state, and each call costs
    as much again when run eagerly). Results are the engine's own."""

    def _once(self, key, args, build):
        memo = self.__dict__.setdefault("_memo", {})
        key = (key,) + tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = (args, build())   # the args stay alive with the ids
        return memo[key][1]

    def fk(self, q):
        return self._once("fk", (q,), lambda: JEngine.fk(self, q))

    def _contact_terms(self, q, qd, mods=None, kin=None):
        if mods:
            return JEngine._contact_terms(self, q, qd, mods, kin)
        return self._once("contact", (q, qd), lambda: JEngine._contact_terms(
            self, q, qd, mods, kin))


def traced_once_env(jenv, engine=None):
    """A copy of the JAX env ``jenv`` whose engine is ``engine`` or a
    ``TracedOnce`` copy of its own."""
    if engine is None:
        engine = TracedOnce(**{f.name: getattr(jenv.engine, f.name)
                               for f in dataclasses.fields(jenv.engine)})
    jenv = dataclasses.replace(jenv)
    jenv.__dict__["engine"] = engine      # the cached_property's slot
    return jenv


def jax_reference(names, states, actions, nexts, tasks, jit):
    """For each env class in ``names``, the JAX step of every entry with
    the given next state (``_GivenPhysics``), and the JAX engine's pieces
    at every next state, under one ``vmap`` with the engine's kinematics
    and contact terms shared (``TracedOnce``); jitted with ``jit``, else
    eagerly. (At the humanoid's size the compiled program runs slower
    than op-by-op dispatch on the CPU; at the ant's it is the faster.)"""
    jax_envs = [traced_once_env(jenvs.make_env(names[0]))]
    engine = jax_envs[0].engine
    jax_envs += [traced_once_env(jenvs.make_env(name), engine)
                 for name in names[1:]]
    key = jax.random.PRNGKey(0)

    def one(state, action, task, nxt, friction):
        out = {name: type(jenv).step(_GivenPhysics(jenv, nxt), state,
                                     action, t, key)
               for name, jenv, t in zip(names, jax_envs, task)}
        out["engine"] = engine_pieces(engine, nxt["q"], nxt["qd"], friction)
        return out

    np_tree = lambda t: jax.tree.map(lambda a: np.asarray(a), t)
    run = jax.vmap(one)
    return jax.tree.map(np.asarray, (jax.jit(run) if jit else run)(
        np_tree(states), np_tree(actions), tasks, np_tree(nexts),
        friction_mults(len(actions))))


def check_pieces(tenv, nexts, want):
    """The port engine's pieces at ``nexts`` against the JAX engine's;
    spheres in and out of contact among them."""
    got = engine_pieces(tenv.engine, nexts["q"], nexts["qd"],
                        torch.tensor(friction_mults(len(nexts["q"]))))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], **OBS_TOL,
                                   err_msg=k)
    active = want["contact_kn_eff"] > 0
    assert active.any(), "no sphere in contact"
    assert (~active).all(-1).any(), "no state clear of the ground"
    # the friction multipliers change the tangential coefficients
    assert (want["contact_friction_mod_ct_eff"]
            != want["contact_ct_eff"]).any()


def check_step_outputs(name, got, want, n, infos):
    """The port's step outputs ``got`` (state, obs, reward, done, info) on
    the first ``n`` entries against the JAX step's."""
    state, obs, reward, done, info = got
    np.testing.assert_allclose(obs.numpy()[:n], want[1][:n], **OBS_TOL,
                               err_msg=name)
    np.testing.assert_allclose(reward.numpy()[:n], want[2][:n],
                               **REWARD_TOL, err_msg=name)
    np.testing.assert_array_equal(done.numpy()[:n], want[3][:n])
    assert set(info) == set(want[4]) == set(infos), name
    for k in info:
        np.testing.assert_allclose(info[k].numpy()[:n], want[4][k][:n],
                                   **REWARD_TOL, err_msg=f"{name} {k}")
    for k in state:
        np.testing.assert_allclose(state[k].numpy()[:n], want[0][k][:n],
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def check_diagnostics(name, infos):
    """The env's diagnostics on (tasks, envs, T) infos against JAX's on
    the same values."""
    tenv, jenv = tenvs.make_env(name), jenvs.make_env(name)
    got = tenv.diagnostics({"env_infos": infos})
    want = jenv.diagnostics({"env_infos": {
        k: jnp.asarray(v.numpy()) for k, v in infos.items()}})
    assert set(got) == set(want) and got, name
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=f"{name} {k}")


def check_registry(names):
    for name in names:
        env, jenv = tenvs.make_env(name), jenvs.make_env(name)
        assert type(env).__name__ == type(jenv).__name__
        assert (env.obs_dim, env.action_dim) == (jenv.obs_dim,
                                                 jenv.action_dim), name
        assert (env.frame_skip, env.n_substeps) == (jenv.frame_skip,
                                                    jenv.n_substeps)
        assert (env.qpos_noise, env.qvel_noise, env.qvel_noise_kind) == (
            jenv.qpos_noise, jenv.qvel_noise, jenv.qvel_noise_kind), name
        assert env.diagnostics_keys == jenv.diagnostics_keys
        tasks = env.sample_tasks(torch.Generator().manual_seed(0), 4000,
                                 "cpu")
        want = jenv.sample_tasks(jax.random.PRNGKey(0), 4000)
        assert tuple(tasks.shape) == want.shape, name
        if tasks.dim() == 1:          # directions +-1, both drawn
            assert set(tasks.tolist()) == {-1.0, 1.0}
        elif name == "AntRandGoalEnv":  # the disk r <= 3, uniform in area
            r = torch.linalg.vector_norm(tasks, dim=-1)
            assert float(r.max()) <= 3.0 and abs(
                float((r < 1.5).float().mean()) - 0.25) < 0.03
        else:                         # unit directions
            np.testing.assert_allclose(
                torch.linalg.vector_norm(tasks, dim=-1).numpy(), 1.0,
                atol=1e-6)


def test_registry_spaces_and_tasks():
    check_registry(ANT_ENVS)
    assert tenvs.make_env("AntRandGoalEnv").obs_dim == 113
    assert tenvs.make_env("AntRandDirecEnv").obs_dim == 111
    assert tenvs.make_env("AntRandGoalEnv").action_dim == 8


@pytest.fixture(scope="module")
def ant_run():
    """A 3-step port rollout of AntRandDirecEnv at 2 x 2, every ant env's
    port step and the JAX reference on its entries."""
    n_t, n_e, horizon = 2, 2, 3
    jenv = jenvs.make_env("AntRandDirecEnv")
    reset_draw, reset_states = reset_draws_from_keys(
        jenv, jax.random.PRNGKey(3), (n_t, n_e))
    rolled, recorder, _ = record_rollout("AntRandDirecEnv", n_t, n_e,
                                         horizon, reset_draw, None, seed=4)
    engine = tenvs.make_env("AntRandDirecEnv").engine
    states, actions, nexts, n, n_reset = entries(
        recorder, reset_states, extra_states(engine, reset_states, 5))
    tasks = [_jax_tasks(jenvs.make_env(name), jax.random.PRNGKey(7 + i),
                        len(actions)) for i, name in enumerate(ANT_ENVS)]
    want = jax_reference(ANT_ENVS, states, actions, nexts, tasks, jit=True)
    got = {name: tenvs.make_env(name).step(states, actions,
                                           torch.tensor(task))
           for name, task in zip(ANT_ENVS, tasks)}
    return dict(rolled=rolled, reset_draw=reset_draw,
                reset_states=reset_states, states=states, nexts=nexts,
                n=n, n_reset=n_reset, tasks=tasks, want=want, got=got)


def test_reset_matches_jax(ant_run):
    r = ant_run
    n, m = r["n"], r["n_reset"]
    for name, tasks in zip(ANT_ENVS, r["tasks"]):
        env = tenvs.make_env(name)
        task = torch.tensor(tasks[n:n + m]).reshape((2, 2) + tasks.shape[1:])
        state, obs = env.reset(task, None, r["reset_draw"])
        for k in ("q", "qd"):
            np.testing.assert_allclose(state[k].numpy(),
                                       r["reset_states"][k].numpy(),
                                       atol=1e-7, rtol=0)
        # the reset entries' JAX observation is the JAX reset's
        np.testing.assert_allclose(obs.reshape(m, -1).numpy(),
                                   r["want"][name][1][n:n + m], **OBS_TOL)


def test_steps_match_jax(ant_run):
    r = ant_run
    infos = {"AntRandGoalEnv": {"reward_forward", "reward_ctrl",
                                "reward_contact"}}
    for name in ANT_ENVS:
        check_step_outputs(name, r["got"][name], r["want"][name], r["n"],
                           infos.get(name, {"reward_forward", "reward_ctrl",
                                            "reward_contact",
                                            "reward_survive"}))
    # the observation of every reset and extra state
    n = r["n"]
    for name, tasks in zip(ANT_ENVS, r["tasks"]):
        state = {k: v[n:] for k, v in r["states"].items()}
        obs = tenvs.make_env(name)._obs(state, torch.tensor(tasks[n:]))
        np.testing.assert_allclose(obs.numpy(), r["want"][name][1][n:],
                                   **OBS_TOL)
    # the rollout's own outputs are the recorded steps'
    rolled = r["rolled"]
    assert rolled["observations"].shape == (2, 2, 3, 111)
    assert not rolled["dones"].any()


def test_engine_matches_jax(ant_run):
    check_pieces(tenvs.make_env("AntRandGoalEnv"), ant_run["nexts"],
                 ant_run["want"]["engine"])


def step_infos(info, horizon, n_t, n_e):
    """The recorded steps' infos, entries t-major, as (tasks, envs, T)."""
    n = horizon * n_t * n_e
    return {k: v[:n].reshape(horizon, n_t, n_e).permute(1, 2, 0)
            for k, v in info.items()}


def test_diagnostics_match_jax(ant_run):
    for name in ("AntRandGoalEnv", "AntRandDirecEnv"):
        check_diagnostics(name, step_infos(ant_run["got"][name][4], 3, 2, 2))
