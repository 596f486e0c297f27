"""One float64 step each of TRPO-MAML, VPG-MAML with E-MAML and DICE-MAML
of the port against the JAX package, through both seed-exact samplers
(sampling/compat_sampler.py) seeded alike, at 4 tasks x 3 envs x 20 steps
with a (32, 32) policy and output bias 3 (the trajectories leave the
zero-reward zone). The bars are tests/test_parity_oracle_ext.py's, which
hold the JAX package against an independent float64 oracle: TRPO's
backtrack count equal and its step taken, parameters 1e-6; VPG/E-MAML's
``LossBefore`` 1e-9, parameters 1e-6; DICE's adjusted rewards 1e-10,
adaptation 1e-9, parameters 1e-6. The JAX run goes first and the port's
after it, each from its own ``np.random.seed``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401
from test_torch_compat_sampler import (  # noqa: E402
    HIDDEN, META_BS, N_ENVS, PROC, T, _jax_samples, _params)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import algos as jalgos  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.compat_sampler import CompatPointMassSampler as JSampler  # noqa: E402
from promp_tpu.sampling.dice_processor import DiceSampleProcessor as JDice  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu_torch import algos as talgos  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.compat_sampler import (  # noqa: E402
    CompatPointMassSampler as TSampler, batch_paths)
from promp_tpu_torch.sampling.dice_processor import DiceSampleProcessor as TDice  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402


def _one_step(jalgo_cls, talgo_cls, seed, jproc, tproc, hparams, **kw):
    """One float64 step of a MAML algorithm through both compat samplers
    (seed ``seed``, output bias 3): (JAX, port) results, each a dict of
    the round-0 processed samples, the adapted params, the new params
    and the metrics."""
    params = _params(3.0)
    results = []
    for pkg in ("jax", "port"):
        with jax.enable_x64(pkg == "jax"):
            if pkg == "jax":
                policy = JPolicy(obs_dim=2, action_dim=2,
                                 hidden_sizes=HIDDEN)
                algo = jalgo_cls(policy=policy, inner_lr=0.1,
                                 num_inner_grad_steps=1, **kw)
                p = jax.tree.map(jnp.asarray, params)
                sampler = JSampler(policy, META_BS, N_ENVS, T, seed=seed,
                                   dtype=jnp.float64)
                batched, proc = _jax_samples, jproc
            else:
                policy = TPolicy(obs_dim=2, action_dim=2,
                                 hidden_sizes=HIDDEN)
                algo = talgo_cls(policy=policy, inner_lr=0.1,
                                 num_inner_grad_steps=1, **kw)
                p = from_numpy_params(params, "cpu")
                sampler = TSampler(policy, META_BS, N_ENVS, T, seed=seed,
                                   dtype=torch.float64, device="cpu")
                batched, proc = (lambda paths: batch_paths(paths, "cpu"),
                                 tproc)
            step_sizes = algo.init_step_sizes(p)
            tasks = sampler.sample_tasks()
            task_params = policy.replicate(p, META_BS)
            proc0 = proc.process(batched(sampler.obtain_samples(
                task_params, tasks)))
            proc0.pop("stats")
            adapted = algo.adapt(task_params, step_sizes, proc0)
            proc1 = proc.process(batched(sampler.obtain_samples(
                adapted, tasks, floor_std=False)))
            proc1.pop("stats")
            ts = {"params": p, "step_sizes": step_sizes}
            new, _, metrics = algo.optimize_policy(
                ts, algo.init_opt_state(ts), [proc0, proc1], hparams(algo))
            results.append(dict(proc0=proc0, adapted=adapted,
                                params=new["params"], metrics=metrics))
    return results


def _to_np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _hold(got, want, key, tol):
    for k, v in want[key].items():
        np.testing.assert_allclose(_to_np(got[key][k]), _to_np(v), atol=tol,
                                   rtol=0, err_msg=f"{key} {k}")


def test_trpo_maml_float64_step_matches_jax():
    want, got = _one_step(jalgos.TRPOMAML, talgos.TRPOMAML, 7, JProc(**PROC),
                          TProc(**PROC), lambda algo: {}, step_size=0.01,
                          cg_iters=10)
    assert int(got["metrics"]["BacktrackIters"]) == int(
        want["metrics"]["BacktrackIters"])
    assert bool(got["metrics"]["StepRejected"]) == bool(
        want["metrics"]["StepRejected"]) is False
    _hold(got, want, "params", 1e-6)


def test_vpg_maml_emaml_float64_step_matches_jax():
    want, got = _one_step(jalgos.VPGMAML, talgos.VPGMAML, 7, JProc(**PROC),
                          TProc(**PROC), lambda algo: algo.init_hparams(),
                          learning_rate=1e-3, exploration=True, max_epochs=1)
    np.testing.assert_allclose(float(got["metrics"]["LossBefore"]),
                               float(want["metrics"]["LossBefore"]),
                               atol=1e-9, rtol=0)
    _hold(got, want, "params", 1e-6)
    moved = max(float(np.abs(_to_np(got["params"][k])
                             - _params(3.0)[k]).max())
                for k in want["params"])
    assert moved > 1e-5


def test_dice_maml_float64_step_matches_jax():
    want, got = _one_step(
        jalgos.DICEMAML, talgos.DICEMAML, 11,
        JDice(max_path_length=T, discount=0.99, normalize_adv=True),
        TDice(max_path_length=T, discount=0.99, normalize_adv=True),
        lambda algo: algo.init_hparams(), learning_rate=1e-3, max_epochs=1)
    np.testing.assert_allclose(
        _to_np(got["proc0"]["adjusted_rewards"]),
        _to_np(want["proc0"]["adjusted_rewards"]), atol=1e-10, rtol=0)
    assert np.abs(_to_np(want["proc0"]["adjusted_rewards"])).max() > 1e-3
    _hold(got, want, "adapted", 1e-9)
    _hold(got, want, "params", 1e-6)
