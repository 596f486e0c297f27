"""One ProMP meta-iteration of the port's Trainer on
normalize(SwimmerRandVelEnv()) (the engine's generic route) against the
JAX Trainer, at 2 tasks x 2 envs x 5 steps with an (8, 8) policy and 2 PPO
epochs, on the same initial parameters, tasks, reset draws and action
noise (drawn as the JAX Trainer draws them, test_torch_support.py).

Held as tests/test_torch_trainer_cheetah.py holds the cheetah: the
processed returns at 1e-5; the advantages are not comparable at this size
(the feature baseline has 2 * 8 + 4 = 20 features and a task 10 samples,
so both ridge fits interpolate the returns, ROADMAP §3), so the JAX
Trainer adapts and takes its outer step on the port's processed samples,
at test_torch_support.py's tolerances. The swimmer's sampling is held
against JAX step by step in tests/test_torch_swimmer_sawyer.py.
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
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.trainer import Trainer as TTrainer  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, TT, HIDDEN = 2, 2, 5, (8, 8)
SWIM_ALGO = dict(ALGO, num_ppo_steps=2)
RUN = dict(meta_batch_size=N_T, rollouts_per_meta_task=N_E,
           max_path_length=TT, n_itr=1, seed=SEED)


def _as_jax(got, want):
    return jax.tree.map(lambda w, g: jnp.asarray(g.numpy(), w.dtype),
                        want, {k: got[k] for k in want})


@pytest.fixture(scope="module")
def swimmer_both():
    jenv = jenvs.normalize(jenvs.make_env("SwimmerRandVelEnv"))
    obs, act = jenv.obs_dim, jenv.action_dim
    jpol = JPolicy(obs_dim=obs, action_dim=act, hidden_sizes=HIDDEN)
    jtr = JTrainer(algo=JProMP(policy=jpol, **SWIM_ALGO), env=jenv,
                   policy=jpol, sample_processor=JProc(**PROC),
                   rollout_backend="scan", **RUN)
    init = {k: np.asarray(v) for k, v in jtr.train_state["params"].items()}
    jtr._rng, it_key = jax.random.split(jtr._rng)
    keys = jax.random.split(it_key, 3)
    tasks = jtr._update_tasks(keys[0])
    draws = [_round_draws(jenv, tasks, keys[i + 1], "scan",
                          (N_T, N_E, TT, act)) for i in (0, 1)]

    tenv = tenvs.normalize(tenvs.make_env("SwimmerRandVelEnv"))
    tpol = TPolicy(obs_dim=obs, action_dim=act, hidden_sizes=HIDDEN)
    ttr = TTrainer(algo=TProMP(policy=tpol, **SWIM_ALGO), env=tenv,
                   policy=tpol, sample_processor=TProc(**PROC),
                   rollout_backend="scan", device="cpu", **RUN)
    ttr.train_state["params"] = from_numpy_params(init, "cpu")
    port_trajs, port_samples = [], []
    port_rollout, port_process = ttr._rollout, ttr._process
    ttr._rollout = lambda *a: port_trajs.append(port_rollout(*a)) or \
        port_trajs[-1]
    ttr._process = lambda *a: port_samples.append(port_process(*a)) or \
        port_samples[-1]
    before = Engine.generic_substeps
    tm = ttr._run_phases(tasks=torch.tensor(np.asarray(tasks)), draws=draws)
    # every env step of both rounds took the generic route
    assert Engine.generic_substeps - before == 2 * TT * tenv.env.frame_skip

    task_params = jpol.replicate(jtr.train_state["params"], N_T)
    all_data, jm = [], {}
    for step in (0, 1):
        samples = jtr._process(jax.tree.map(lambda g: jnp.asarray(g.numpy()),
                                            port_trajs[step]))
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
    train_state, _, metrics = jtr._outer(jtr.train_state, jtr.opt_state,
                                         all_data, jtr.hparams)
    jm.update(metrics)
    jparams = {k: np.asarray(v) for k, v in train_state["params"].items()}
    tparams = {k: v.numpy() for k, v in ttr.train_state["params"].items()}
    return jm, jparams, tm, tparams, init


def test_swimmer_meta_iteration_matches_jax(swimmer_both):
    jm, jparams, tm, tparams, init = swimmer_both
    for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter",
              "Step_0-AverageReturn", "Step_1-AverageReturn"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert int(tm["SkippedUpdates"]) == int(jm["SkippedUpdates"]) == 0
    for k in jparams:
        np.testing.assert_allclose(tparams[k], jparams[k], err_msg=k,
                                   **PARAM_TOL)
    assert max(np.abs(tparams[k] - init[k]).max() for k in init) > 1e-4
    for key in ("Step_1-Env-reward_fwd", "Step_1-AverageForwardProgress"):
        assert key in tm and np.isfinite(float(tm[key])), key
