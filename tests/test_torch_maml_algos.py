"""VPG-MAML (both inner types, with and without the E-MAML exploration
term), TRPO-MAML's surrogate and KL (with and without it), DICE-MAML and
VPG-DICE-MAML of the port against the JAX package's, on the same
parameters and samples: the meta-objective, its second-order gradient
through the unrolled inner step, and one outer step.

Sizes: 2 tasks x 2 paths x 5 steps, an (8, 8) policy (obs 2, action 2);
the DICE cases with dones mid-path and the buffers masked as the DICE
processor masks them (test_torch_support.maml_samples). Tolerances:
test_torch_support.METRIC_TOL on losses, KLs and gradients, PARAM_TOL on
the parameters after the outer step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    METRIC_TOL, PARAM_TOL, jax_tree, maml_samples, torch_single_thread)

import jax  # noqa: E402

from promp_tpu import algos as jalgos  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu_torch import algos as talgos  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy as TPolicy  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

HIDDEN = (8, 8)
# (algorithm, its settings, DICE samples)
CASES = {
    "vpg_lr": ("VPGMAML", dict(inner_type="likelihood_ratio"), False),
    "vpg_ll": ("VPGMAML", dict(inner_type="log_likelihood"), False),
    "emaml_vpg_lr": ("VPGMAML", dict(exploration=True), False),
    "emaml_vpg_ll": ("VPGMAML", dict(inner_type="log_likelihood",
                                     exploration=True), False),
    "dice": ("DICEMAML", {}, True),
    "vpg_dice": ("VPG_DICEMAML", {}, True),
}
COMMON = dict(inner_lr=0.1, num_inner_grad_steps=1, learning_rate=1e-2,
              max_epochs=2)


def _t(tree):
    return from_numpy_params(tree, "cpu")


def _setup(name, kw, dice, seed=11):
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    tpol = TPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    jalgo = getattr(jalgos, name)(policy=jpol, **dict(COMMON, **kw))
    talgo = getattr(talgos, name)(policy=tpol, **dict(COMMON, **kw))
    params = {k: np.asarray(v)
              for k, v in jpol.init(jax.random.PRNGKey(seed)).items()}
    step_sizes, data = maml_samples(jalgo, jax_tree(params), seed,
                                    dice=dice)
    return jalgo, talgo, params, step_sizes, data


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]),
                                   err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_meta_objective_and_gradient(case):
    jalgo, talgo, params, step_sizes, data = _setup(*CASES[case])
    jdata = [jax_tree(d) for d in data]
    tdata = [_t(d) for d in data]
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jalgo.meta_objective(p, jax_tree(step_sizes), jdata, {}),
        has_aux=True))(jax_tree(params))
    tg, (tl, taux) = torch.func.grad_and_value(
        lambda p: talgo.meta_objective(p, _t(step_sizes), tdata, {}),
        has_aux=True)(_t(params))
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    _close(taux, jaux, METRIC_TOL, "aux")
    _close(tg, jg, METRIC_TOL, "gradient")
    assert max(np.abs(np.asarray(v)).max() for v in jg.values()) > 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_optimize_policy(case):
    jalgo, talgo, params, step_sizes, data = _setup(*CASES[case])
    jts = {"params": jax_tree(params), "step_sizes": jax_tree(step_sizes)}
    tts = {"params": _t(params), "step_sizes": _t(step_sizes)}
    jts, jos, jm = jax.jit(jalgo.optimize_policy)(
        jts, jalgo.init_opt_state(jts), [jax_tree(d) for d in data], {})
    tts, tos, tm = talgo.optimize_policy(
        tts, talgo.init_opt_state(tts), [_t(d) for d in data], {})
    _close(tts["params"], jts["params"], PARAM_TOL, "params")
    _close(tts["step_sizes"], jts["step_sizes"], PARAM_TOL, "step sizes")
    for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert int(tm["SkippedUpdates"]) == int(jm["SkippedUpdates"]) == 0
    assert int(tos.count) == int(jos.count) == COMMON["max_epochs"]
    assert max(np.abs(tts["params"][k].numpy() - params[k]).max()
               for k in params) > 1e-3


@pytest.mark.parametrize("exploration", [False, True],
                         ids=["trpo", "emaml_trpo"])
def test_trpo_surrogate_and_kl(exploration):
    jalgo, talgo, params, step_sizes, data = _setup(
        "TRPOMAML", dict(inner_type="log_likelihood",
                         exploration=exploration), False)
    jdata = [jax_tree(d) for d in data]
    tdata = [_t(d) for d in data]

    def jfn(p):
        loss, kl, inner = jalgo.surrogate_and_kl(p, jax_tree(step_sizes),
                                                 jdata)
        return loss, (kl, inner)

    (jl, (jkl, jinner)), jg = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(jax_tree(params))

    def tfn(p):
        loss, kl, inner = talgo.surrogate_and_kl(p, _t(step_sizes), tdata)
        return loss, (kl, inner)

    tg, (tl, (tkl, tinner)) = torch.func.grad_and_value(
        tfn, has_aux=True)(_t(params))
    for got, want in ((tl, jl), (tkl, jkl), (tinner, jinner)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **METRIC_TOL)
    _close(tg, jg, METRIC_TOL, "gradient")
    # the exploration term changes the surrogate, not the KLs
    assert float(tkl) < 1e-6 < abs(float(tl))
