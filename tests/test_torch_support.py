"""Shared helpers of the port's CPU tests (no tests of its own).

``maml_samples``: two rounds of processed samples for an algorithm's
objectives, from a seed (the MAML-family tests of the other algorithms).

``torch_single_thread``: one torch thread for the port's tests. Their
tensors are tiny, so more threads only add overhead, and the suite runs
several test processes on the host's cores at once.

``run_both``: one ProMP meta-iteration of the JAX Trainer and of the port's
Trainer on the same initial parameters, tasks, initial states and action
noise; ``check_parity`` compares the two. The ``jax_phases`` fixture lets
a module's runs share the JAX programs that do not depend on the rollout
backend.

The JAX Trainer draws its own randomness; this module repeats its key
splits (promp_tpu/trainer.py:98-99, 237 and 278-279; the scan engine's at
sampling/rollout.py:64-83 and its auto-resets' at :104-113; the Pallas
path's at trainer.py:131-135 and ops/pallas_rollout.py:112; a locomotion
env's reset at envs/mujoco/locomotion.py:69-80) and hands the draws to the
port.

The JAX side runs the Trainer's own jitted phases (_rollout, _process,
_adapt, _outer) in the order of Trainer._run_phases, so that each round's
trajectory can be held against the port's. K1's nearest-corner test
compares the goal's distance with the nearest corner's, which at the goal
corner is the same number computed by two expressions: XLA on the CPU may
round them 1 ulp apart and zero a reward the port pays. ``check_reward_flips``
allows a reward-branch flip only there (the reference pays 0, the port
pays) or at a true float tie; flips are counted and resolved the port's way
in the JAX round data before it is processed, so that everything after
sampling is compared on the same data.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.algos.promp import ProMP as JProMP  # noqa: E402
from promp_tpu.envs.mujoco.locomotion import LocomotionEnv as JLocomotionEnv  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu.trainer import Trainer as JTrainer  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.algos.promp import ProMP as TProMP  # noqa: E402
from promp_tpu_torch.ops.rollout_kernel import reward_tie_margin  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.trainer import Trainer as TTrainer  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T = 4, 5, 20
HIDDEN = (16, 16)
SEED = 3
TRAJ_TOL = 1e-4  # float32 over a T-step trajectory
# Losses and KLs atol 1e-6 / rtol 1e-4, parameters after the 5 Adam epochs
# atol 5e-6. Both sides sample, process, adapt and take second-order
# gradients in float32 in other summation orders; the gaps seen are below
# 1e-7 on the losses and 1e-6 on the parameters, which Adam moves by up to
# 5e-3, so 5e-6 is 0.1% of the step.
METRIC_TOL = dict(atol=1e-6, rtol=1e-4)
PARAM_TOL = dict(atol=5e-6, rtol=0)
# the main path's ProMP settings (bench.py:107-120)
ALGO = dict(inner_lr=0.1, num_inner_grad_steps=1, learning_rate=1e-3,
            num_ppo_steps=5, clip_eps=0.3, init_inner_kl_penalty=5e-4,
            adaptive_inner_kl_penalty=False)
PROC = dict(discount=0.99, gae_lambda=1.0, normalize_adv=True)
RUN = dict(meta_batch_size=N_T, rollouts_per_meta_task=N_E,
           max_path_length=T, n_itr=1, seed=SEED)


def make_port_trainer(backend, reward_type="sparse", n_inner=1, **kw):
    env = tenvs.normalize(tenvs.MetaPointEnvCorner(reward_type=reward_type))
    policy = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    algo = TProMP(policy=policy, **dict(ALGO, num_inner_grad_steps=n_inner))
    return TTrainer(algo=algo, env=env,
                    policy=policy, sample_processor=TProc(**PROC),
                    rollout_backend=backend, **dict(RUN, **kw))


def locomotion_reset_draw(env, key):
    """The random draw of one ``LocomotionEnv.reset`` (locomotion.py:69-80)
    in the port's ``draw`` form: (the uniform qpos noise, the qvel draw),
    the qvel draw being the standard-normal draw before its scaling for
    normal qvel noise and the uniform qvel noise itself for uniform."""
    nv = env.model.nv
    kq, kv = jax.random.split(key)
    qpos = jax.random.uniform(kq, (nv,), jnp.float32, -env.qpos_noise,
                              env.qpos_noise)
    if env.qvel_noise_kind == "normal":
        return qpos, jax.random.normal(kv, (nv,))
    return qpos, jax.random.uniform(kv, (nv,), jnp.float32, -env.qvel_noise,
                                    env.qvel_noise)


def jax_reset_draws(jenv, reset_keys, tasks):
    """The port's reset draws for (tasks, envs) reset keys: the JAX reset's
    own draw for a locomotion env, else the state the JAX reset returns
    (a point mass's draw)."""
    inner = getattr(jenv, "env", jenv)
    if isinstance(inner, JLocomotionEnv):
        return jax.vmap(jax.vmap(partial(locomotion_reset_draw, inner)))(
            reset_keys)
    obs0, _ = jax.vmap(lambda ks, t: jax.vmap(
        jenv.reset, in_axes=(0, None))(ks, t))(reset_keys, tasks)
    return obs0


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _jax_draws(jenv, tasks, key, backend, shape, step_resets=False):
    """(reset draw, noise) of one round, and with ``step_resets`` (scan
    only) the draws of every step's auto-resets (rollout.py:104-113), (T,
    tasks, envs, ...); ``shape`` is (tasks, envs, T, act)."""
    n_t, n_e, horizon, act = shape
    split_envs = lambda k: jax.random.split(k, n_t * n_e).reshape(
        n_t, n_e, -1)
    if backend == "scan":
        key_reset, key_scan = jax.random.split(key)
        step_keys = jax.vmap(lambda k: jax.random.split(k, 3))(
            jax.random.split(key_scan, horizon))
        noise = jax.vmap(lambda k: jax.random.normal(k, (n_t, n_e, act)))(
            step_keys[:, 0])
    else:
        key_reset, k_noise = jax.random.split(key)
        noise = jax.random.normal(k_noise, (n_t, horizon, n_e, act))
    out = (jax_reset_draws(jenv, split_envs(key_reset), tasks), noise)
    if step_resets:
        out += (jax.vmap(lambda k: jax_reset_draws(
            jenv, split_envs(k), tasks))(step_keys[:, 2]),)
    return out


def _round_draws(jenv, tasks, key, backend, shape=(N_T, N_E, T, 2),
                 step_resets=False):
    """(reset draw, noise) of one sampling round, in the port's layouts:
    noise is (T, tasks, envs, act) for "scan", (tasks, T, envs, act) for
    "kernel"; with ``step_resets``, also the auto-resets' draws."""
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                        _jax_draws(jenv, tasks, key, backend, shape,
                                   step_resets))


def check_reward_flips(got, want_rewards, goals):
    """Asserts that every step where the port's reward branch (``got``, a
    rollout dict) differs from the reference's rewards is a float tie
    (margin under 1e-5) or a goal-corner step the reference zeroes and the
    port pays; returns the (tasks, envs, T) mask of flips."""
    g, w = got["rewards"].numpy(), np.asarray(want_rewards)
    flips = (g == 0) != (w == 0)
    margin = reward_tie_margin(got["observations"], got["actions"],
                               torch.tensor(np.asarray(goals))).numpy()
    allowed = (margin < 1e-5) | ((w == 0) & (g != 0))
    assert allowed[flips].all(), \
        f"{(flips & ~allowed).sum()} reward-branch flips off a tie"
    return flips


def _round_check(got, want, tasks):
    """Holds one round's port trajectory against the JAX one; returns the
    JAX trajectory with flipped rewards set to the port's, and the number
    of flips."""
    for k in ("observations", "actions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TRAJ_TOL, rtol=0, err_msg=k)
    g, w = got["rewards"].numpy(), np.asarray(want["rewards"])
    flips = check_reward_flips(got, w, tasks)
    np.testing.assert_allclose(g[~flips], w[~flips], atol=1e-5, rtol=0)
    return dict(want, rewards=jnp.asarray(np.where(flips, g, w))), \
        int(flips.sum())


# the JAX Trainer's jitted phases besides sampling, which do not depend on
# the rollout backend
SHARED_PHASES = ("_update_tasks", "_process", "_adapt", "_outer")


@pytest.fixture(scope="module")
def jax_phases():
    """The JAX phases in SHARED_PHASES of the module's first parity run,
    handed to its later runs so that each program compiles once."""
    return {}


def run_both(backend, jax_phases, n_inner=1):
    """Returns (jax metrics, jax params, port metrics, port params, initial
    params, reward-branch flips), over ``n_inner`` inner steps (the phases
    in ``jax_phases`` must have been made for as many)."""
    jenv = jenvs.normalize(jenvs.MetaPointEnvCorner())
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    jalgo = JProMP(policy=jpol, **dict(ALGO, num_inner_grad_steps=n_inner))
    jtr = JTrainer(algo=jalgo, env=jenv, policy=jpol,
                   sample_processor=JProc(**PROC),
                   rollout_backend="pallas" if backend == "kernel" else "scan",
                   **RUN)
    for name in SHARED_PHASES:
        setattr(jtr, name, jax_phases.setdefault(name, getattr(jtr, name)))
    # a wide action noise spreads the points past the sparse reward's L1
    # dead zone within T steps, so the surrogate's gradient is not zero
    params = dict(jtr.train_state["params"])
    params["log_std_network/log_std_var"] = jnp.full((1, 2), 2.0, jnp.float32)
    jtr.train_state = dict(jtr.train_state, params=params)
    init = {k: np.asarray(v) for k, v in params.items()}
    jtr._rng, it_key = jax.random.split(jtr._rng)
    keys = jax.random.split(it_key, n_inner + 2)
    tasks = jtr._update_tasks(keys[0])
    draws = [_round_draws(jenv, tasks, keys[i + 1], backend)
             for i in range(n_inner + 1)]

    ttr = make_port_trainer(backend, device="cpu", n_inner=n_inner)
    ttr.train_state["params"] = from_numpy_params(init, "cpu")
    port_trajs = []
    port_rollout = ttr._rollout
    ttr._rollout = lambda *a: port_trajs.append(port_rollout(*a)) or \
        port_trajs[-1]
    tm = ttr._run_phases(tasks=torch.tensor(np.asarray(tasks)), draws=draws)

    task_params = jpol.replicate(jtr.train_state["params"], N_T)
    all_data, jm, n_flips = [], {}, 0
    for step in range(n_inner + 1):
        traj = jtr._rollout(task_params, tasks, keys[step + 1], step == 0)
        traj, flips = _round_check(port_trajs[step], traj, tasks)
        n_flips += flips
        samples = jtr._process(traj)
        for k, v in samples.pop("stats").items():
            jm[f"Step_{step}-{k}"] = v
        all_data.append(samples)
        if step < n_inner:
            task_params = jtr._adapt(task_params,
                                     jtr.train_state["step_sizes"], samples)
    train_state, _, metrics = jtr._outer(jtr.train_state, jtr.opt_state,
                                         all_data, jtr.hparams)
    jm.update(metrics)
    jparams = {k: np.asarray(v) for k, v in train_state["params"].items()}
    tparams = {k: v.numpy() for k, v in ttr.train_state["params"].items()}
    return jm, jparams, tm, tparams, init, n_flips


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def check_parity(result, max_flips, n_inner=1):
    jm, jparams, tm, tparams, init, flips = result
    assert flips <= max_flips, f"{flips} reward-branch flips at ties"
    for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter") + tuple(
            f"Step_{step}-AverageReturn" for step in range(n_inner + 1)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert int(tm["SkippedUpdates"]) == int(jm["SkippedUpdates"]) == 0
    for k in jparams:
        np.testing.assert_allclose(tparams[k], jparams[k], err_msg=k,
                                   **PARAM_TOL)
    # the outer step moved the parameters
    assert max(np.abs(tparams[k] - init[k]).max() for k in init) > 1e-4


def np_tree(tree):
    """A nested dict of JAX or numpy arrays as numpy arrays."""
    return {k: np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def maml_samples(jalgo, params, seed, shape=(2, 2, 5), dice=False):
    """(step sizes, two rounds of processed samples), numpy, for the JAX
    algorithm ``jalgo`` at ``params``: random observations, the sampling
    policies' actions and distributions (round 1's from ``jalgo.adapt`` on
    round 0), random advantages and adj_avg_rewards; with ``dice`` also
    random dones mid-path, their prefix mask, random adjusted rewards, and
    every buffer multiplied by the mask as the DICE processor does.
    ``shape`` is (tasks, paths, T)."""
    jpol = jalgo.policy
    n_t, n_p, horizon = shape
    rng = np.random.default_rng(seed)
    step_sizes = jalgo.init_step_sizes(params)
    task_params = jpol.replicate(params, n_t)
    rounds = []
    for step in (0, 1):
        obs = rng.normal(size=shape + (jpol.obs_dim,)).astype(np.float32)
        dist = np_tree(jax.vmap(jpol.apply, in_axes=(0, 0, None))(
            task_params, jnp.asarray(obs), step == 0))
        noise = rng.normal(size=dist["mean"].shape).astype(np.float32)
        data = dict(observations=obs,
                    actions=dist["mean"] + noise * np.exp(dist["log_std"]),
                    advantages=rng.normal(size=shape).astype(np.float32),
                    adj_avg_rewards=rng.normal(size=shape).astype(
                        np.float32),
                    agent_infos=dist)
        if dice:
            dones = rng.random(shape) < 0.2
            mask = (np.cumsum(dones, -1) - dones < 0.5).astype(np.float32)
            data = dict(
                observations=obs * mask[..., None],
                actions=data["actions"] * mask[..., None],
                advantages=data["advantages"] * mask,
                adj_avg_rewards=data["adj_avg_rewards"],
                agent_infos={k: v * mask[..., None] for k, v in dist.items()},
                adjusted_rewards=rng.normal(size=shape).astype(
                    np.float32) * mask,
                mask=mask)
        rounds.append(data)
        if step == 0:
            task_params = jalgo.adapt(task_params, step_sizes,
                                      jax_tree(data))
    return np_tree(step_sizes), rounds
