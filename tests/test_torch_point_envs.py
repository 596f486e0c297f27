"""The port's point variants (promp_tpu_torch/envs/point/{basic,walls}.py)
against the JAX package's (promp_tpu/envs/point/{basic,walls}.py) on the
same draws: sample_tasks, reset and step, and a rollout of each variant
under normalize() through both scan engines.

The JAX side draws with its keys (basic.py, walls.py; the rollout's splits
through test_torch_support.py) and the draws are handed to the port.
Tolerances: tasks, observations and rewards of one step within float32
rounding (atol 1e-6); a 12-step rollout of a random policy within 1e-5;
dones equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import _round_draws, torch_single_thread  # noqa: E402,F401

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.rollout import rollout as jrollout  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.run import build  # noqa: E402
from promp_tpu_torch.sampling.rollout import rollout as trollout  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

VARIANTS = ("MetaPointEnv", "MetaPointEnvV2", "MetaPointEnvCornerGoals",
            "MetaPointEnvMomentum", "MetaPointEnvWalls")
N_T, N_E, T = 3, 4, 12
STEP_TOL = dict(atol=1e-6, rtol=0)
ROLLOUT_TOL = dict(atol=1e-5, rtol=0)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def task_draw(name, key, n):
    """The random numbers of the JAX env's ``sample_tasks(key, n)``, in the
    port's ``draw`` form (None where the tasks take none)."""
    if name == "MetaPointEnvV2":
        return jax.random.uniform(key, (n, 2), jnp.float32, -2.0, 2.0)
    if name == "MetaPointEnvMomentum":
        return jax.random.randint(key, (n,), 0, 4)
    if name == "MetaPointEnvWalls":
        kg, k1, k2 = jax.random.split(key, 3)
        return (jax.random.randint(kg, (n,), 0, 4),
                jax.random.normal(k1, (n, 2)), jax.random.normal(k2, (n, 2)))
    return None


def both_tasks(name, key, n=N_T):
    jenv, tenv = jenvs.make_env(name), tenvs.make_env(name)
    jtasks = jenv.sample_tasks(key, n)
    draw = task_draw(name, key, n)
    ttasks = tenv.sample_tasks(None, n, "cpu",
                               draw=None if draw is None else to_torch(draw))
    return jenv, tenv, jtasks, ttasks


@pytest.mark.parametrize("name", VARIANTS)
def test_sample_tasks(name):
    _, _, jtasks, ttasks = both_tasks(name, jax.random.PRNGKey(7), n=16)
    want, got = to_np(jtasks), to_np(ttasks)
    if isinstance(want, dict):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **STEP_TOL)
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **STEP_TOL)


def _task_b(tasks, n_envs, xp):
    """(tasks, ...) -> (tasks, envs, ...), for JAX (xp=jnp) or torch."""
    def expand(v):
        if xp is jnp:
            return jnp.broadcast_to(v[:, None], (v.shape[0], n_envs)
                                    + v.shape[1:])
        return v[:, None].expand((v.shape[0], n_envs) + tuple(v.shape[1:]))
    return ({k: expand(v) for k, v in tasks.items()}
            if isinstance(tasks, dict) else expand(tasks))


@pytest.mark.parametrize("name", VARIANTS)
def test_reset_and_step(name):
    """Reset on JAX's keys, then T steps of random (partly clipped)
    actions, and one step from states next to the origin toward it (the
    basic envs' dones)."""
    key = jax.random.PRNGKey(11)
    jenv, tenv, jtasks, ttasks = both_tasks(name, key)
    keys = jax.random.split(jax.random.fold_in(key, 1),
                            N_T * N_E).reshape(N_T, N_E, -1)
    jtb = _task_b(jtasks, N_E, jnp)
    ttb = _task_b(ttasks, N_E, torch)
    reset = jax.vmap(jax.vmap(jenv.reset))
    step = jax.jit(jax.vmap(jax.vmap(jenv.step)))
    jstate, jobs = reset(keys, jtb)
    tstate, tobs = tenv.reset(ttb, None, draw=to_torch(jstate))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **STEP_TOL)
    rng = np.random.default_rng(0)
    high = tenv.action_space.high
    for t in range(T):
        act = rng.uniform(-1.5 * high, 1.5 * high,
                          (N_T, N_E, tenv.action_dim)).astype(np.float32)
        jstate, jobs, jrew, jdone, _ = step(jstate, jnp.asarray(act), jtb,
                                            keys)
        tstate, tobs, trew, tdone, _ = tenv.step(tstate, torch.tensor(act),
                                                 ttb)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                                   err_msg=f"obs {t}", **STEP_TOL)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                                   err_msg=f"reward {t}", **STEP_TOL)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        # hand the port JAX's state, so each step is held on its own
        tstate = to_torch(jstate)
    if name in ("MetaPointEnv", "MetaPointEnvV2", "MetaPointEnvCornerGoals"):
        near = rng.uniform(-0.05, 0.05, (N_T, N_E, 2)).astype(np.float32)
        act = (-near + rng.uniform(-0.012, 0.012, near.shape)).astype(
            np.float32)
        _, _, jrew, jdone, _ = step(jnp.asarray(near), jnp.asarray(act), jtb,
                                    keys)
        _, _, trew, tdone, _ = tenv.step(torch.tensor(near),
                                         torch.tensor(act), ttb)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **STEP_TOL)
        assert 0 < int(tdone.sum()) < N_T * N_E
    if name == "MetaPointEnvWalls":
        # from just inside each wall, straight outward: crossings both
        # through a gap and blocked by the wall
        for radius in (0.95, 1.95):
            angle = rng.uniform(0, 2 * np.pi, (N_T, N_E))
            unit = np.stack([np.cos(angle), np.sin(angle)], -1)
            near = (radius * unit).astype(np.float32)
            act = (0.2 * unit).astype(np.float32)
            _, jobs, jrew, _, _ = step(jnp.asarray(near), jnp.asarray(act),
                                       jtb, keys)
            _, tobs, trew, _, _ = tenv.step(torch.tensor(near),
                                            torch.tensor(act), ttb)
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                                       **STEP_TOL)
            np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                                       **STEP_TOL)
            pushed = np.abs(tobs.numpy() - (near + act)).max(-1) > 1e-4
            assert 0 < pushed.sum() < N_T * N_E, radius


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_under_normalize(name):
    """A random (8,) policy's rollout of normalize(env) through both scan
    engines on the same tasks, resets, noise and auto-reset draws."""
    key = jax.random.PRNGKey(5)
    _, _, jtasks, ttasks = both_tasks(name, key)
    jenv = jenvs.normalize(jenvs.make_env(name))
    tenv = tenvs.normalize(tenvs.make_env(name))
    jpol = JPolicy(obs_dim=jenv.obs_dim, action_dim=jenv.action_dim,
                   hidden_sizes=(8,))
    tpol = TPolicy(obs_dim=jenv.obs_dim, action_dim=jenv.action_dim,
                   hidden_sizes=(8,))
    params = jpol.init(jax.random.PRNGKey(2))
    rkey = jax.random.fold_in(key, 3)
    want = jrollout(jenv, jpol, jpol.replicate(params, N_T), jtasks, rkey,
                    N_E, T)
    draws = _round_draws(jenv, jtasks, rkey, "scan",
                         (N_T, N_E, T, jenv.action_dim), step_resets=True)
    tparams = from_numpy_params({k: np.asarray(v) for k, v in
                                 params.items()}, "cpu")
    got = trollout(tenv, tpol, tpol.replicate(tparams, N_T), ttasks, None,
                   N_E, T, reset_draw=draws[0], noise=draws[1],
                   reset_draws=draws[2])
    for k in ("observations", "actions", "rewards"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **ROLLOUT_TOL)
    for k in ("dones", "timesteps"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", VARIANTS)
def test_build_one_iteration(name):
    """One ProMP iteration of each variant through run.build."""
    config = dict(seed=0, env=name, rollouts_per_meta_task=2,
                  max_path_length=5, meta_batch_size=2, hidden_sizes=(8,),
                  num_promp_steps=1, n_itr=1, device="cpu")
    state = build(config).train()
    assert all(bool(torch.isfinite(v).all())
               for v in state["params"].values())
