"""TRPO-MAML as a whole: one meta-iteration of the port's Trainer on
normalize(HalfCheetahRandDirecEnv()) against the JAX Trainer, at
maml_run_mujoco.py's settings (log-likelihood inner step, inner_lr 0.1,
step_size 0.01, the feature baseline, normalized advantages) cut to 2
tasks x 2 envs x 5 steps with an (8, 8) policy, on the same initial
parameters, tasks, reset draws and action noise (drawn as the JAX Trainer
draws them, test_torch_support.py).

As in tests/test_torch_trainer_cheetah.py, the JAX Trainer processes the
port's trajectories (the returns are held at 1e-5) and then adapts and
takes its outer step on the port's processed samples: the feature
baseline's 38 features interpolate a task's 10 returns at this size, so
the normalized advantages are solver noise (ROADMAP.md §3).

Tolerances: test_torch_support.METRIC_TOL on what precedes the TRPO step
(returns, LossBefore, MeanKLBefore); the line search's decisions
(BacktrackIters, StepRejected) equal, with the accepted candidate away
from a float32 tie of the acceptance test. The step itself is held in
float64, both packages' outer steps on the same samples, at atol 1e-8 on
the parameters and rtol 1e-7 on the losses and KLs: in float32, CG's ten
iterations on this ill-conditioned Fisher matrix carry the rounding into
the direction, and the JAX package's own float32 step lies 1.4e-4 from
its float64 step in the parameters (the port's 3.4e-6). So the float32
steps are held to each other at STEP_TOL, atol 3e-4 on the parameters and
rtol 2e-3 on LossAfter, MeanKL, dLoss and KLInner.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    METRIC_TOL, PROC, SEED, _round_draws, torch_single_thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import envs as jenvs  # noqa: E402
from promp_tpu.algos.trpo_maml import TRPOMAML as JTRPOMAML  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu.trainer import Trainer as JTrainer  # noqa: E402
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.algos.trpo_maml import TRPOMAML  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import (  # noqa: E402
    GaussianMLPPolicy as TPolicy, flatten_params, unflatten_params)
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.trainer import Trainer as TTrainer  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T, HIDDEN = 2, 2, 5, (8, 8)
OBS, ACT = 17, 6
ENV = "HalfCheetahRandDirecEnv"
# run_scripts/maml_run_mujoco.py's DEFAULT_CONFIG
ALGO = dict(inner_lr=0.1, num_inner_grad_steps=1, inner_type="log_likelihood",
            step_size=0.01)
STEP_TOL = dict(atol=3e-4, rtol=0)
STEP_METRIC_TOL = dict(atol=1e-6, rtol=2e-3)
F64_TOL = dict(atol=1e-8, rtol=0)
F64_METRIC_TOL = dict(atol=1e-12, rtol=1e-7)
RUN = dict(meta_batch_size=N_T, rollouts_per_meta_task=N_E,
           max_path_length=T, n_itr=1, seed=SEED)


def _as_jax(got, want):
    return jax.tree.map(lambda w, g: jnp.asarray(g.numpy(), w.dtype),
                        want, {k: got[k] for k in want})


@pytest.fixture(scope="module")
def both():
    jenv = jenvs.normalize(jenvs.make_env(ENV))
    jpol = JPolicy(obs_dim=OBS, action_dim=ACT, hidden_sizes=HIDDEN)
    jtr = JTrainer(algo=JTRPOMAML(policy=jpol, **ALGO), env=jenv,
                   policy=jpol, sample_processor=JProc(**PROC),
                   rollout_backend="scan", **RUN)
    init = {k: np.asarray(v) for k, v in jtr.train_state["params"].items()}
    jtr._rng, it_key = jax.random.split(jtr._rng)
    keys = jax.random.split(it_key, 3)
    tasks = jtr._update_tasks(keys[0])
    draws = [_round_draws(jenv, tasks, keys[i + 1], "scan", (N_T, N_E, T, ACT))
             for i in (0, 1)]

    tpol = TPolicy(obs_dim=OBS, action_dim=ACT, hidden_sizes=HIDDEN)
    ttr = TTrainer(algo=TRPOMAML(policy=tpol, **ALGO),
                   env=tenvs.normalize(tenvs.make_env(ENV)), policy=tpol,
                   sample_processor=TProc(**PROC), rollout_backend="scan",
                   device="cpu", **RUN)
    ttr.train_state["params"] = from_numpy_params(init, "cpu")
    port_trajs, port_samples = [], []
    port_rollout, port_process = ttr._rollout, ttr._process
    ttr._rollout = lambda *a: port_trajs.append(port_rollout(*a)) or \
        port_trajs[-1]
    ttr._process = lambda *a: port_samples.append(port_process(*a)) or \
        port_samples[-1]
    tm = ttr._run_phases(tasks=torch.tensor(np.asarray(tasks)), draws=draws)

    task_params = jpol.replicate(jtr.train_state["params"], N_T)
    all_data, jm = [], {}
    for step in (0, 1):
        traj = jax.tree.map(lambda g: jnp.asarray(g.numpy()),
                            port_trajs[step])
        samples = jtr._process(traj)
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
    return dict(jm=jm, jparams=jparams, tm=tm, tparams=tparams, init=init,
                trainer=ttr, samples=port_samples, jalgo=jtr.algo)


def test_one_meta_iteration_matches_jax(both):
    jm, tm = both["jm"], both["tm"]
    for k in ("LossBefore", "MeanKLBefore", "Step_0-AverageReturn",
              "Step_1-AverageReturn"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    for k in ("LossAfter", "MeanKL", "dLoss", "KLInner"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **STEP_METRIC_TOL)
    assert int(tm["BacktrackIters"]) == int(jm["BacktrackIters"])
    assert bool(tm["StepRejected"]) == bool(jm["StepRejected"]) is False
    assert float(tm["MeanKL"]) <= ALGO["step_size"]
    assert float(tm["LossAfter"]) < float(tm["LossBefore"])
    for k in both["jparams"]:
        np.testing.assert_allclose(both["tparams"][k], both["jparams"][k],
                                   err_msg=k, **STEP_TOL)
    init = both["init"]
    assert max(np.abs(both["tparams"][k] - init[k]).max() for k in init) \
        > 1e-2


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else
            v.double() if v.is_floating_point() else v
            for k, v in tree.items()}


def test_outer_step_in_float64_matches_jax(both):
    """Both packages' TRPO outer steps in float64 on the port's samples."""
    ttr = both["trainer"]
    samples = [_f64({k: v for k, v in s.items() if k != "env_infos"})
               for s in both["samples"]]
    state = _f64({"params": from_numpy_params(both["init"], "cpu"),
                  "step_sizes": ttr.train_state["step_sizes"]})
    tstate, _, tm = ttr.algo.optimize_policy(state, (), samples, {})
    with jax.enable_x64():
        to_jax = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        jstate, _, jm = jax.jit(both["jalgo"].optimize_policy)(
            jax.tree.map(to_jax, state), (),
            [jax.tree.map(to_jax, s) for s in samples], {})
        jm = jax.tree.map(np.asarray, jm)
        jparams = jax.tree.map(np.asarray, jstate["params"])
    for k in ("LossBefore", "LossAfter", "MeanKLBefore", "MeanKL", "dLoss",
              "KLInner"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **F64_METRIC_TOL)
    assert int(tm["BacktrackIters"]) == int(jm["BacktrackIters"])
    assert not bool(tm["StepRejected"]) and not bool(jm["StepRejected"])
    for k, v in jparams.items():
        assert tstate["params"][k].dtype == torch.float64
        np.testing.assert_allclose(tstate["params"][k].numpy(), v,
                                   err_msg=k, **F64_TOL)


def test_accepted_step_is_not_a_tie(both):
    """The decision compared above is not a float32 tie: the accepted
    candidate and the one rejected before it are more than 1e-4
    (relative) from the acceptance test's thresholds."""
    ttr, tm = both["trainer"], both["tm"]
    init = from_numpy_params(both["init"], "cpu")
    flat0, spec = flatten_params(init)
    new_flat, _ = flatten_params(from_numpy_params(both["tparams"], "cpu"))
    n = int(tm["BacktrackIters"])
    ratio = ttr.algo.backtrack_ratio
    step = (flat0 - new_flat) / ratio ** n
    loss_before, delta = float(tm["LossBefore"]), ALGO["step_size"]
    for i in range(max(n - 1, 0), n + 1):
        loss, kl, _ = ttr.algo.surrogate_and_kl(
            unflatten_params(flat0 - ratio ** i * step, spec),
            ttr.train_state["step_sizes"], both["samples"])
        assert abs(float(loss) - loss_before) > 1e-4 * abs(loss_before), i
        assert abs(float(kl) - delta) > 1e-4 * delta, i
