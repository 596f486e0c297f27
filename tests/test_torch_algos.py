"""Adam, MAMLAlgo and ProMP of the port against promp_tpu's on the same
processed samples and parameters.

Tolerances (float32): adapted parameters, losses and KLs atol 1e-5 / rtol
1e-5 (one inner gradient step over a few hundred samples; only summation
order differs); gradients, including the second-order meta-gradient through
the inner step, atol 1e-5 / rtol 1e-4; parameters after the Adam epochs
atol 1e-5 (the first Adam steps move each parameter by about lr * sign(g),
so the gradients' own rounding enters only through m / sqrt(v)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.algos.promp import ProMP as JProMP  # noqa: E402
from promp_tpu.optimizers.adam import Adam as JAdam  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu_torch.algos.promp import ProMP as TProMP  # noqa: E402
from promp_tpu_torch.optimizers.adam import Adam as TAdam  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params, to_numpy_params  # noqa: E402

N_T, P, T = 3, 4, 6
HIDDEN = (8, 8)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _jx(tree):
    return {k: _jx(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    got, want = to_numpy_params(got), _np(want)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _close_np(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _close_np(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _samples(seed, params, jpol):
    """Processed-sample buffers of one round: random obs/actions, the
    sampling policy's own distributions, normalized advantages."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(N_T, P, T, 2)).astype(np.float32)
    dist = jax.vmap(jpol.apply)(jpol.replicate(params, N_T), jnp.asarray(obs))
    act = np.asarray(dist["mean"]) + rng.normal(size=(N_T, P, T, 2)).astype(
        np.float32) * np.exp(np.asarray(dist["log_std"]))
    adv = rng.normal(size=(N_T, P, T)).astype(np.float32)
    return dict(observations=obs, actions=act.astype(np.float32),
                advantages=adv,
                agent_infos={k: np.asarray(v) for k, v in dist.items()})


@pytest.fixture(scope="module")
def setup():
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    params = jpol.init(jax.random.PRNGKey(0))
    kw = dict(inner_lr=0.1, num_inner_grad_steps=1, learning_rate=1e-3,
              num_ppo_steps=3, clip_eps=0.3, init_inner_kl_penalty=5e-4)
    jalgo, talgo = JProMP(policy=jpol, **kw), TProMP(policy=tpol, **kw)
    step_sizes = jalgo.init_step_sizes(params)
    data0 = _samples(1, params, jpol)
    adapted = jax.jit(jalgo.adapt)(jpol.replicate(params, N_T), step_sizes,
                                   _jx(data0))
    data1 = _samples(2, params, jpol)
    # post-update round: the adapted policies' own distributions
    dist1 = jax.vmap(jpol.apply, in_axes=(0, 0, None))(
        adapted, jnp.asarray(data1["observations"]), False)
    data1["agent_infos"] = _np(dist1)
    return dict(jpol=jpol, tpol=tpol, jalgo=jalgo, talgo=talgo,
                params=_np(params), step_sizes=_np(step_sizes),
                data=[data0, data1], adapted=_np(adapted))


def _t(tree):
    return from_numpy_params(tree, "cpu")


def test_adam_matches_and_skips_non_finite():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 2)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    grads[1]["b"][2] = np.nan  # the whole second update must be skipped
    jopt, topt = JAdam(learning_rate=0.01), TAdam(learning_rate=0.01)
    jp, js = _jx(params), jopt.init(_jx(params))
    tp, ts = _t(params), topt.init(_t(params))
    jupdate = jax.jit(jopt.update)
    for i, g in enumerate(grads):
        jp, js = jupdate(_jx(g), js, jp)
        before = {k: v.clone() for k, v in tp.items()}
        tp, ts = topt.update(_t(g), ts, tp)
        if i == 1:
            for k in tp:
                assert torch.equal(tp[k], before[k])
        _close(tp, jp)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
    assert int(ts.count) == int(js.count) == 2
    assert int(ts.skipped) == int(js.skipped) == 1


def test_adapt(setup):
    s = setup
    got = s["talgo"].adapt(s["tpol"].replicate(_t(s["params"]), N_T),
                           _t(s["step_sizes"]), _t(s["data"][0]))
    _close(got, s["adapted"])


def test_unrolled_adaptation(setup):
    s = setup
    jdata = [_jx(d) for d in s["data"]]
    want_p, want_kls = jax.jit(s["jalgo"].unrolled_adaptation)(
        _jx(s["params"]), _jx(s["step_sizes"]), jdata)
    got_p, got_kls = s["talgo"].unrolled_adaptation(
        _t(s["params"]), _t(s["step_sizes"]), [_t(d) for d in s["data"]])
    # step 0 adapts with the floored forward, as adapt() does not; here the
    # log_std is far above the floor, so both give the sampled round's params
    _close(got_p, want_p)
    _close(got_p, s["adapted"])
    np.testing.assert_allclose(float(got_kls[0]), float(want_kls[0]), **TOL)


def test_meta_objective_and_second_order_gradient(setup):
    s = setup
    jdata = [_jx(d) for d in s["data"]]
    coeff = np.array([5e-4], np.float32)

    def jloss(params):
        return s["jalgo"].meta_objective(params, _jx(s["step_sizes"]), jdata,
                                         jnp.asarray(coeff), 0.3)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jx(s["params"]))
    tdata = [_t(d) for d in s["data"]]
    tg, (tl, taux) = torch.func.grad_and_value(
        lambda p: s["talgo"].meta_objective(
            p, _t(s["step_sizes"]), tdata, torch.as_tensor(coeff), 0.3),
        has_aux=True)(_t(s["params"]))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(taux["outer_kl"]), float(jaux["outer_kl"]),
                               **TOL)
    np.testing.assert_allclose(taux["inner_kls"].numpy(),
                               np.asarray(jaux["inner_kls"]), **TOL)
    _close(tg, jg, GRAD_TOL)


def test_optimize_policy_with_outer_kl_gate(setup):
    """The KL-gated epochs (outer_kl_limit > 0); the ungated outer step of
    the main path is held in tests/test_torch_trainer*.py."""
    s = setup
    outer_kl_limit = 1e-4
    kw = dict(inner_lr=0.1, num_inner_grad_steps=1, learning_rate=1e-2,
              num_ppo_steps=3, clip_eps=0.3, init_inner_kl_penalty=5e-4,
              outer_kl_limit=outer_kl_limit)
    jalgo = JProMP(policy=s["jpol"], **kw)
    talgo = TProMP(policy=s["tpol"], **kw)
    jts = {"params": _jx(s["params"]), "step_sizes": _jx(s["step_sizes"])}
    tts = {"params": _t(s["params"]), "step_sizes": _t(s["step_sizes"])}
    jts, jos, jm = jax.jit(jalgo.optimize_policy)(
        jts, jalgo.init_opt_state(jts), [_jx(d) for d in s["data"]],
        jalgo.init_hparams())
    tts, tos, tm = talgo.optimize_policy(
        tts, talgo.init_opt_state(tts), [_t(d) for d in s["data"]],
        talgo.init_hparams())
    _close(tts["params"], jts["params"])
    _close(tts["step_sizes"], jts["step_sizes"])
    for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    assert int(tm["SkippedUpdates"]) == int(jm["SkippedUpdates"]) == 0
    assert int(tos.count) == int(jos.count)
    # the KL gate halts the epochs once the policy has moved
    assert 0 < int(tos.count) < 3


def test_update_hparams():
    talgo = TProMP(policy=TPolicy(obs_dim=2, action_dim=2),
                   num_inner_grad_steps=3, anneal_factor=0.5)
    jalgo = JProMP(policy=JPolicy(obs_dim=2, action_dim=2),
                   num_inner_grad_steps=3, anneal_factor=0.5)
    metrics = {"inner_kls": np.array([0.001, 0.01, 0.05], np.float32)}
    got = talgo.update_hparams(talgo.init_hparams(), metrics)
    want = jalgo.update_hparams(jalgo.init_hparams(), metrics)
    np.testing.assert_array_equal(got["inner_kl_coeff"],
                                  want["inner_kl_coeff"])
    assert got["clip_eps"] == want["clip_eps"]
