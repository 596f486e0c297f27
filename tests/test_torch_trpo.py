"""The port's conjugate-gradient trust-region optimizer
(promp_tpu_torch/optimizers/trpo.py) against promp_tpu/optimizers/trpo.py:
CG on one SPD system, the exact and the finite-difference Hessian-vector
products of a small TRPO-MAML KL, and whole TRPO steps (a quadratic, the
same quadratic with NaN candidates, and a small TRPO-MAML objective) with
the same decisions.

Sizes: 2 tasks x 2 paths x 5 steps, an (8, 8) policy (obs 2, action 2).
Tolerances: CG's solution rtol 1e-5 (float32, 6 iterations on a
well-conditioned 6 x 6 system); the HVPs rtol 1e-4 / atol 1e-6 (a
third-order product through the unrolled inner step, float32 in two
summation orders; the finite difference divides a gradient difference by
2e-5 on both sides, so its rounding is the same expression's); the TRPO
steps' parameters test_torch_support.PARAM_TOL, their losses and KLs
METRIC_TOL. The line search's decisions must be equal, so each case
asserts that its accepted and last rejected candidates are not float32
ties of the acceptance test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    METRIC_TOL, PARAM_TOL, jax_tree, maml_samples, torch_single_thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.algos.trpo_maml import TRPOMAML as JTRPOMAML  # noqa: E402
from promp_tpu.optimizers import trpo as jtrpo  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy as JPolicy  # noqa: E402
from promp_tpu_torch.algos.trpo_maml import TRPOMAML  # noqa: E402
from promp_tpu_torch.optimizers import trpo  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy  # noqa: E402

HIDDEN = (8, 8)
HVP_TOL = dict(rtol=1e-4, atol=1e-6)
DELTA = 0.01


def _t(tree, dtype=torch.float32):
    return {k: _t(v, dtype) if isinstance(v, dict)
            else torch.tensor(v, dtype=dtype) for k, v in tree.items()}


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.astype(np.float64)
            for k, v in tree.items()}


def test_conjugate_gradients_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(6, 6)).astype(np.float32)
    a = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = jax.jit(lambda b: jtrpo.conjugate_gradients(
        lambda x: jnp.asarray(a) @ x, b, cg_iters=6))(jnp.asarray(b))
    ta = torch.tensor(a)
    got = trpo.conjugate_gradients(lambda x: ta @ x, torch.tensor(b),
                                   cg_iters=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, b),
                               rtol=1e-4, atol=1e-5)
    # a residual under the tolerance stops CG before its first iteration
    x = trpo.conjugate_gradients(lambda x: ta @ x, torch.full((6,), 1e-6))
    assert not x.any()


@pytest.fixture(scope="module")
def maml():
    """A small TRPO-MAML problem: both algorithms, initial params and two
    rounds of samples."""
    jpol = JPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    tpol = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    jalgo = JTRPOMAML(policy=jpol, step_size=DELTA)
    talgo = TRPOMAML(policy=tpol, step_size=DELTA)
    params = {k: np.asarray(v)
              for k, v in jpol.init(jax.random.PRNGKey(4)).items()}
    step_sizes, data = maml_samples(jalgo, jax_tree(params), seed=5)
    return dict(jalgo=jalgo, talgo=talgo, params=params,
                step_sizes=step_sizes, data=data)


def _objectives(m, dtype=np.float32):
    """(JAX loss, JAX kl, port loss, port kl) closures over the samples."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    jdata = [jax_tree(d) for d in m["data"]]
    tdata = [_t(d, tdtype) for d in m["data"]]
    jss, tss = jax_tree(m["step_sizes"]), _t(m["step_sizes"], tdtype)
    jsk = lambda p: m["jalgo"].surrogate_and_kl(p, jss, jdata)  # noqa: E731
    tsk = lambda p: m["talgo"].surrogate_and_kl(p, tss, tdata)  # noqa: E731
    return (lambda p: jsk(p)[0], lambda p: jsk(p)[1],
            lambda p: tsk(p)[0], lambda p: tsk(p)[1])


@pytest.mark.parametrize("approach", ["exact", "finite_difference"])
def test_hvp_of_trpo_maml_kl_matches_jax(maml, approach):
    _, jkl, _, tkl = _objectives(maml)
    params = maml["params"]
    rng = np.random.default_rng(6)
    vec = {k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in params.items()}
    flat_v = torch.cat([torch.tensor(vec[k]).reshape(-1)
                        for k in sorted(vec)])
    if approach == "exact":
        want = jax.jit(lambda p, v: jax.jvp(jax.grad(jkl), (p,), (v,))[1])(
            jax_tree(params), jax_tree(vec))
        want = np.concatenate([np.asarray(want[k]).ravel()
                               for k in sorted(want)])
        tparams = _t(params)
    else:
        # in float64: in float32 the gradient difference over 2e-5 carries
        # about 1% of rounding noise on either side
        m64 = dict(maml, params=_f64(params), step_sizes=_f64(
            maml["step_sizes"]), data=[_f64(d) for d in maml["data"]])
        with jax.enable_x64():
            _, jkl, _, tkl = _objectives(m64, np.float64)
            jparams = jax_tree(m64["params"])
            _, spec = jtrpo.flatten_params(jparams)
            jhvp = jtrpo.FiniteDifferenceHvp().build_eval(jkl, jparams,
                                                          spec, 0.0)
            want = np.asarray(jax.jit(jhvp)(jnp.asarray(
                flat_v.numpy().astype(np.float64))))
        tparams = _t(m64["params"], torch.float64)
        flat_v = flat_v.double()
    opt = trpo.ConjugateGradientOptimizer(hvp_approach=approach, hvp_reg=0.0)
    got = opt._hvp(tkl, tparams, trpo.flatten_params(tparams)[1])(flat_v)
    np.testing.assert_allclose(got.numpy(), want, **HVP_TOL)
    assert np.abs(want).max() > 1e-3   # the KL's curvature is not zero


def _check_step(got, want, init):
    (tp, ti), (jp, ji) = got, want
    assert int(ti["backtrack_iters"]) == int(ji["backtrack_iters"])
    assert bool(ti["step_taken"]) == bool(ji["step_taken"])
    assert bool(ti["violated"]) == bool(ji["violated"])
    for k in ("loss_before", "loss", "kl"):
        np.testing.assert_allclose(float(ti[k]), float(ji[k]), err_msg=k,
                                   **METRIC_TOL)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **PARAM_TOL)
    if bool(ti["step_taken"]):
        assert max(np.abs(tp[k].numpy() - init[k]).max() for k in init) > 1e-4


def _assert_no_tie(eval_fn, params, got, opt, delta):
    """The accepted candidate and the one rejected before it are more than
    1e-4 (relative) away from the acceptance test's thresholds."""
    new_params, info = got
    flat, spec = trpo.flatten_params(params)
    n = int(info["backtrack_iters"])
    loss_before = float(info["loss_before"])
    # the accepted candidate is flat - ratio**n * step
    step = (flat - trpo.flatten_params(new_params)[0]) \
        / opt.backtrack_ratio ** n
    for i in range(max(n - 1, 0), n + 1):
        loss, kl = eval_fn(trpo.unflatten_params(
            flat - opt.backtrack_ratio ** i * step, spec))
        assert abs(float(loss) - loss_before) > 1e-4 * abs(loss_before), i
        assert abs(float(kl) - delta) > 1e-4 * delta, i


def _quadratic(xp, backend):
    """loss(x) = 1 + g.d + 0.5 d.Q d, kl(x) = 0.5 d.H d with d = x - x0: a
    stiff loss, so that the full trust-region step overshoots and the line
    search backtracks."""
    rng = np.random.default_rng(7)
    n = 5
    m = rng.normal(size=(n, n)).astype(np.float32)
    h = (m @ m.T / n + np.eye(n)).astype(np.float32)
    q = (60.0 * h).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    x0 = rng.normal(size=n).astype(np.float32)
    h, q, g, x0c = (backend(a) for a in (h, q, g, x0))

    def loss(p, nan=False):
        d = p["x"] - x0c
        value = 1.0 + xp.sum(g * d) + 0.5 * xp.sum(d * (q @ d))
        if nan:
            moved = xp.sum(d * d) > 0
            value = xp.where(moved, xp.asarray(float("nan")), value)
        return value

    def kl(p):
        d = p["x"] - x0c
        return 0.5 * xp.sum(d * (h @ d))

    return {"x": x0}, loss, kl


@pytest.mark.parametrize("nan", [False, True], ids=["quadratic", "nan"])
def test_optimize_quadratic_same_decisions(nan):
    init, jloss, jkl = _quadratic(jnp, jnp.asarray)
    _, tloss, tkl = _quadratic(torch, torch.tensor)
    want = jax.jit(lambda p: jtrpo.ConjugateGradientOptimizer().optimize(
        lambda q: jloss(q, nan), jkl, p, DELTA))(jax_tree(init))
    opt = trpo.ConjugateGradientOptimizer()
    got = opt.optimize(lambda q: (tloss(q, nan), tkl(q)), _t(init), DELTA)
    _check_step(got, want, init)
    if nan:
        # every candidate is NaN: all 15 tried, the step rejected
        assert int(got[1]["backtrack_iters"]) == 14
        assert not bool(got[1]["step_taken"])
        assert torch.equal(got[0]["x"], torch.tensor(init["x"]))
    else:
        assert 1 <= int(got[1]["backtrack_iters"]) < 14
        assert bool(got[1]["step_taken"])
        _assert_no_tie(lambda p: (tloss(p), tkl(p)), _t(init), got, opt,
                       DELTA)


def test_optimize_trpo_maml_same_decisions(maml):
    jl, jk, tl, tk = _objectives(maml)
    init = maml["params"]
    want = jax.jit(lambda p: jtrpo.ConjugateGradientOptimizer().optimize(
        jl, jk, p, DELTA))(jax_tree(init))
    opt = trpo.ConjugateGradientOptimizer()
    got = opt.optimize(lambda p: (tl(p), tk(p)), _t(init), DELTA)
    _check_step(got, want, init)
    assert bool(got[1]["step_taken"])
    _assert_no_tie(lambda p: (tl(p), tk(p)), _t(init), got, opt, DELTA)
