"""The port's seed-exact sampler (sampling/compat_sampler.py) and its
float64 mode against the JAX package.

Both samplers replay the reference's global numpy MT19937 stream, seeded
alike; the JAX run goes first and the port's after it, each from its own
``np.random.seed``, so that they draw the same numbers. The bars are
tests/test_parity_oracle.py's, which hold the JAX package against an
independent float64 oracle: ProMP over two meta-iterations at 4 tasks x 3
envs x 20 steps with a (32, 32) policy, at output bias 0 and 3. In the
first iteration observations and actions within 1e-12, rewards with every
branch equal and the paid values within 1e-12 (the same numpy env on
policy outputs that agree to ~1e-15, not to the bit: XLA's and torch's
float64 matmul and tanh round apart in the last bits), processed returns
and advantages within 1e-10; adapted parameters within 1e-7 / 2e-6 and
final parameters within 1e-6 / 1e-5 in both iterations. The second
iteration samples from each package's own parameters, which those bars
hold only to 1e-6 / 1e-5 (at bias 3 the first outer step leaves them
2e-8 apart), so its trajectories and processed samples are held at the
final parameters' bar, its reward branches equal. The float64 steps of
TRPO-MAML, VPG-MAML with E-MAML and DICE-MAML are in
tests/test_torch_compat_maml.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu import algos as jalgos  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu.sampling.compat_sampler import CompatPointMassSampler as JSampler  # noqa: E402
from promp_tpu.sampling.processor import SampleProcessor as JProc  # noqa: E402
from promp_tpu_torch import algos as talgos  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.sampling.compat_sampler import (  # noqa: E402
    CompatPointMassSampler as TSampler, batch_paths)
from promp_tpu_torch.sampling.processor import SampleProcessor as TProc  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

META_BS, N_ENVS, T = 4, 3, 20
HIDDEN = (32, 32)
PROMP = dict(inner_lr=0.1, learning_rate=1e-3, num_ppo_steps=3,
             clip_eps=0.3, init_inner_kl_penalty=5e-4,
             adaptive_inner_kl_penalty=False)
PROC = dict(discount=0.99, gae_lambda=1.0, normalize_adv=True)
HPARAMS = dict(inner_kl_coeff=np.full((1,), 5e-4, np.float64),
               clip_eps=np.float64(0.3))


def _params(bias):
    """float64 numpy parameters from the JAX policy's init (key 0), the
    output bias set to ``bias``."""
    policy = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    params = {k: np.asarray(v, np.float64)
              for k, v in policy.init(jax.random.PRNGKey(0)).items()}
    if bias:
        params["mean_network/output/bias"] = np.full(2, bias)
    return params


def _jax_samples(paths):
    """JAX-side batched samples: the port's ``batch_paths`` as JAX arrays
    (tests/test_parity_oracle.py's ``_to_batched``)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return jnp.asarray(tree.numpy())
    return conv(batch_paths(paths, "cpu"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------ the numpy stream
def test_numpy_stream_determinism():
    """A pure function of the numpy seed."""
    policy = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=(8,))
    params = policy.replicate(policy.init(torch.Generator().manual_seed(0),
                                          "cpu"), 3)

    def run():
        s = TSampler(policy, meta_batch_size=3, envs_per_task=2,
                     max_path_length=5, seed=22, device="cpu")
        tasks = s.sample_tasks()
        return s.obtain_samples(params, tasks), tasks

    (d1, t1), (d2, t2) = run(), run()
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(a, b)
    for p1, p2 in zip(d1, d2):
        np.testing.assert_array_equal(p1["observations"], p2["observations"])
        np.testing.assert_array_equal(p1["rewards"], p2["rewards"])


def test_reference_rng_order():
    """Task sampling consumes np.random.choice(range(4), n) first."""
    policy = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=(8,))
    s = TSampler(policy, meta_batch_size=5, envs_per_task=1,
                 max_path_length=2, seed=7, device="cpu")
    tasks = s.sample_tasks()
    np.random.seed(7)
    idx = np.random.choice(range(4), size=5)
    for a, b in zip(tasks, [s.CORNERS[i] for i in idx]):
        np.testing.assert_array_equal(a, b)


def test_the_sampler_takes_the_card_by_default():
    policy = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=(8,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TSampler(policy, 2, 2, 2)


# ------------------------------------------------------------- ProMP x 2
def _jax_promp(params, n_itr=2):
    """The JAX package's float64 ProMP through its compat sampler, seed 1:
    each iteration's (paths, processed, adapted) and the final params."""
    with jax.enable_x64():
        policy = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
        algo = jalgos.ProMP(policy=policy, **PROMP)
        proc = JProc(**PROC)
        params = jax.tree.map(jnp.asarray, params)
        ts = {"params": params, "step_sizes": algo.init_step_sizes(params)}
        opt = algo.init_opt_state(ts)
        sampler = JSampler(policy, META_BS, N_ENVS, T, seed=1,
                           dtype=jnp.float64)
        out = []
        for _ in range(n_itr):
            tasks = sampler.sample_tasks()
            task_params = policy.replicate(ts["params"], META_BS)
            paths0 = sampler.obtain_samples(task_params, tasks)
            proc0 = proc.process(_jax_samples(paths0))
            proc0.pop("stats")
            adapted = algo.adapt(task_params, ts["step_sizes"], proc0)
            paths1 = sampler.obtain_samples(adapted, tasks, floor_std=False)
            proc1 = proc.process(_jax_samples(paths1))
            proc1.pop("stats")
            ts, opt, _ = algo.optimize_policy(ts, opt, [proc0, proc1],
                                              HPARAMS)
            out.append(dict(paths=(paths0, paths1),
                            proc=_np((proc0, proc1)), adapted=_np(adapted),
                            params=_np(ts["params"])))
    return out


def _port_promp(params, n_itr=2):
    policy = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    algo = talgos.ProMP(policy=policy, **PROMP)
    proc = TProc(**PROC)
    params = from_numpy_params(params, "cpu")
    ts = {"params": params, "step_sizes": algo.init_step_sizes(params)}
    opt = algo.init_opt_state(ts)
    sampler = TSampler(policy, META_BS, N_ENVS, T, seed=1,
                       dtype=torch.float64, device="cpu")
    out = []
    for _ in range(n_itr):
        tasks = sampler.sample_tasks()
        task_params = policy.replicate(ts["params"], META_BS)
        paths0 = sampler.obtain_samples(task_params, tasks)
        proc0 = proc.process(batch_paths(paths0, "cpu"))
        proc0.pop("stats")
        adapted = algo.adapt(task_params, ts["step_sizes"], proc0)
        paths1 = sampler.obtain_samples(adapted, tasks, floor_std=False)
        proc1 = proc.process(batch_paths(paths1, "cpu"))
        proc1.pop("stats")
        ts, opt, metrics = algo.optimize_policy(ts, opt, [proc0, proc1],
                                                HPARAMS)
        assert int(metrics["SkippedUpdates"]) == 0
        out.append(dict(paths=(paths0, paths1), proc=(proc0, proc1),
                        adapted=adapted, params=ts["params"]))
    return out


@pytest.mark.parametrize("bias", [0.0, 3.0])
def test_two_float64_promp_meta_iterations_match_jax(bias):
    tol_adapt = 1e-7 if bias == 0.0 else 2e-6
    tol_final = 1e-6 if bias == 0.0 else 1e-5
    params = _params(bias)
    want = _jax_promp(params)
    got = _port_promp(params)
    rewarded = 0.0
    for itr, (g, w) in enumerate(zip(got, want)):
        # the first iteration samples from the same parameters; the second
        # from each package's own, held only to tol_final
        traj_tol = 1e-12 if itr == 0 else tol_final
        proc_tol = 1e-10 if itr == 0 else tol_final
        for gp_round, wp_round in zip(g["paths"], w["paths"]):
            for gp, wp in zip(gp_round, wp_round):
                for k in ("observations", "actions"):
                    np.testing.assert_allclose(gp[k], wp[k], atol=traj_tol,
                                               rtol=0, err_msg=k)
                # every reward branch equal; the paid values within the
                # trajectories' bar (the states they come from agree to
                # ~1e-15 in the first iteration, not to the bit)
                np.testing.assert_array_equal(gp["rewards"] == 0,
                                              wp["rewards"] == 0)
                np.testing.assert_allclose(gp["rewards"], wp["rewards"],
                                           atol=traj_tol, rtol=0)
                rewarded += float(np.abs(gp["rewards"]).sum())
        for gproc, wproc in zip(g["proc"], w["proc"]):
            for k in ("returns", "advantages"):
                assert gproc[k].dtype == torch.float64
                np.testing.assert_allclose(gproc[k].numpy(), wproc[k],
                                           atol=proc_tol, rtol=0, err_msg=k)
        for k, v in w["adapted"].items():
            np.testing.assert_allclose(g["adapted"][k].detach().numpy(), v,
                                       atol=tol_adapt, rtol=0, err_msg=k)
        for k, v in w["params"].items():
            assert g["params"][k].dtype == torch.float64
            np.testing.assert_allclose(
                g["params"][k].detach().numpy(), v, atol=tol_final, rtol=0,
                err_msg=f"iteration {itr} param {k}")
    # bias 3 leaves the zero-reward zone: the surrogate branch is exercised
    assert bias == 0.0 or rewarded > 1e-3
