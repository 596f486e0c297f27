"""Slice 3 as a whole: one ProMP meta-iteration of the port's Trainer on
normalize(Walker2DRandParamsEnv()) against the JAX Trainer, at 2 tasks x 2
envs x 8 steps with an (8, 8) policy and 2 PPO epochs, on the same
initial parameters, dict tasks (the physics multipliers), reset draws,
every step's auto-reset draws and action noise (drawn as the JAX Trainer
draws them, test_torch_support.py). The initial log-std is 2.5, so that
walkers fall inside the window and both rounds carry auto-resets into the
processing and the updates.

As in tests/test_torch_trainer_cheetah.py, whose pattern and tolerances
this follows, the JAX Trainer processes the port's trajectories (the
port's sampling of this env is held against the JAX rollout in
tests/test_torch_rand_params.py), the processed returns are held at 1e-5,
and the JAX Trainer adapts and takes its outer step on the port's
processed samples: the feature baseline is underdetermined at this size
(2 * 17 + 4 = 38 features, 16 samples a task), so the two float32 ridge
fits differ and so would the advantages (ROADMAP.md §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    ALGO, METRIC_TOL, PARAM_TOL, PROC, SEED, _round_draws,
    torch_single_thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.algos.promp import ProMP as JProMP  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu.trainer import Trainer as JTrainer  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.algos.promp import ProMP as TProMP  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.trainer import Trainer as TTrainer  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T, HIDDEN = 2, 2, 8, (8, 8)
OBS, ACT = 17, 6
ENV = "Walker2DRandParamsEnv"
WALKER_ALGO = dict(ALGO, num_ppo_steps=2)
RUN = dict(meta_batch_size=N_T, rollouts_per_meta_task=N_E,
           max_path_length=T, n_itr=1, seed=SEED)
LOG_STD = 2.5


def _port_trainer(**kw):
    env = tenvs.normalize(tenvs.make_env(ENV))
    policy = TPolicy(obs_dim=OBS, action_dim=ACT, hidden_sizes=HIDDEN)
    return TTrainer(algo=TProMP(policy=policy, **WALKER_ALGO), env=env,
                    policy=policy, sample_processor=TProc(**PROC),
                    rollout_backend="scan", **dict(RUN, **kw))


def _as_jax(got, want):
    """The port's tensors in the structure and types of ``want``."""
    return jax.tree.map(lambda w, g: jnp.asarray(g.numpy(), w.dtype),
                        want, {k: got[k] for k in want})


def _jax_traj(got):
    """A port trajectory as the JAX rollout returns one."""
    return jax.tree.map(lambda g: jnp.asarray(g.numpy()), got)


@pytest.fixture(scope="module")
def both():
    jenv = jenvs.normalize(jenvs.make_env(ENV))
    jpol = JPolicy(obs_dim=OBS, action_dim=ACT, hidden_sizes=HIDDEN)
    jtr = JTrainer(algo=JProMP(policy=jpol, **WALKER_ALGO), env=jenv,
                   policy=jpol, sample_processor=JProc(**PROC),
                   rollout_backend="scan", **RUN)
    params = dict(jtr.train_state["params"])
    params["log_std_network/log_std_var"] = jnp.full((1, ACT), LOG_STD,
                                                     jnp.float32)
    jtr.train_state = dict(jtr.train_state, params=params)
    init = {k: np.asarray(v) for k, v in params.items()}
    jtr._rng, it_key = jax.random.split(jtr._rng)
    keys = jax.random.split(it_key, 3)
    tasks = jtr._update_tasks(keys[0])
    draws = [_round_draws(jenv, tasks, keys[i + 1], "scan", (N_T, N_E, T, ACT),
                          step_resets=True) for i in (0, 1)]

    ttr = _port_trainer(device="cpu")
    ttr.train_state["params"] = from_numpy_params(init, "cpu")
    port_trajs, port_samples = [], []
    port_rollout, port_process = ttr._rollout, ttr._process
    ttr._rollout = lambda *a: port_trajs.append(port_rollout(*a)) or \
        port_trajs[-1]
    ttr._process = lambda *a: port_samples.append(port_process(*a)) or \
        port_samples[-1]
    tm = ttr._run_phases(tasks={k: torch.tensor(np.asarray(v))
                                for k, v in tasks.items()}, draws=draws)
    # the port's inner step on its round-0 samples, from the initial params
    adapted = ttr.algo.adapt(
        ttr.policy.replicate(from_numpy_params(init, "cpu"), N_T),
        ttr.train_state["step_sizes"], port_samples[0])

    task_params = jpol.replicate(jtr.train_state["params"], N_T)
    all_data, jm = [], {}
    for step in (0, 1):
        samples = jtr._process(_jax_traj(port_trajs[step]))
        for k, v in samples.pop("stats").items():
            jm[f"Step_{step}-{k}"] = v
        np.testing.assert_allclose(port_samples[step]["returns"].numpy(),
                                   np.asarray(samples["returns"]), atol=1e-5,
                                   rtol=0)
        samples = _as_jax(port_samples[step], samples)
        all_data.append(samples)
        if step == 0:
            task_params = jtr._adapt(task_params,
                                     jtr.train_state["step_sizes"], samples)
            for k, v in task_params.items():
                np.testing.assert_allclose(adapted[k].detach().numpy(),
                                           np.asarray(v), err_msg=k,
                                           **PARAM_TOL)
    train_state, _, metrics = jtr._outer(jtr.train_state, jtr.opt_state,
                                         all_data, jtr.hparams)
    jm.update(metrics)
    jparams = {k: np.asarray(v) for k, v in train_state["params"].items()}
    tparams = {k: v.numpy() for k, v in ttr.train_state["params"].items()}
    return jm, jparams, tm, tparams, init, port_trajs


def test_one_meta_iteration_matches_jax(both):
    jm, jparams, tm, tparams, init, _ = both
    for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter",
              "Step_0-AverageReturn", "Step_1-AverageReturn"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert int(tm["SkippedUpdates"]) == int(jm["SkippedUpdates"]) == 0
    for k in jparams:
        np.testing.assert_allclose(tparams[k], jparams[k], err_msg=k,
                                   **PARAM_TOL)
    # the outer step moved the parameters
    assert max(np.abs(tparams[k] - init[k]).max() for k in init) > 1e-4


@pytest.mark.parametrize("step", [0, 1])
def test_rounds_carry_auto_resets(both, step):
    """Walkers fall in both rounds: the processed data holds episodes that
    end inside the window, and each is followed by a fresh one."""
    traj = both[5][step]
    dones, timesteps = traj["dones"], traj["timesteps"]
    assert bool(dones[..., :-1].any())
    after = torch.nonzero(dones[..., :-1])
    assert all(int(timesteps[i, j, t + 1]) == 0 for i, j, t in after)
    jm, _, tm, _, _, _ = both
    key = f"Step_{step}-AverageReturn"
    np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key,
                               **METRIC_TOL)
