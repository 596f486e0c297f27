"""promp_tpu_torch.ops.distributions against promp_tpu.ops.distributions on
the same numpy inputs. Tolerance: float32 per op, atol 1e-5 / rtol 1e-5
(both compute the same formula; only exp/log rounding and the summation
order may differ)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from promp_tpu.ops import distributions as jd  # noqa: E402
from promp_tpu_torch.ops import distributions as td  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _dists(seed=0, shape=(3, 7, 2)):
    rng = np.random.default_rng(seed)
    mk = lambda: dict(mean=rng.normal(size=shape).astype(np.float32),
                      log_std=rng.uniform(-1.5, 0.5, shape).astype(np.float32))
    return mk(), mk(), rng.normal(size=shape).astype(np.float32)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def test_kl():
    old, new, _ = _dists()
    np.testing.assert_allclose(td.kl(_t(old), _t(new)).numpy(),
                               np.asarray(jd.kl(_j(old), _j(new))), **TOL)


def test_kl_tiny_std_keeps_denominator_term():
    old, new, _ = _dists(1)
    new["log_std"][:] = -12.0  # std^2 ~ 4e-11, below the 1e-8 term
    np.testing.assert_allclose(td.kl(_t(old), _t(new)).numpy(),
                               np.asarray(jd.kl(_j(old), _j(new))),
                               rtol=1e-5)


def test_log_likelihood_and_ratio():
    old, new, x = _dists(2)
    np.testing.assert_allclose(
        td.log_likelihood(torch.as_tensor(x), _t(new)).numpy(),
        np.asarray(jd.log_likelihood(jnp.asarray(x), _j(new))), **TOL)
    np.testing.assert_allclose(
        td.likelihood_ratio(torch.as_tensor(x), _t(old), _t(new)).numpy(),
        np.asarray(jd.likelihood_ratio(jnp.asarray(x), _j(old), _j(new))),
        **TOL)


def test_entropy():
    old, _, _ = _dists(3)
    np.testing.assert_allclose(td.entropy(_t(old)).numpy(),
                               np.asarray(jd.entropy(_j(old))), **TOL)


def test_sample_with_given_noise():
    old, _, noise = _dists(4)
    expect = old["mean"] + noise * np.exp(old["log_std"])
    got = td.sample(None, _t(old), noise=torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, expect, **TOL)
    drawn = td.sample(torch.Generator().manual_seed(0), _t(old))
    assert drawn.shape == (3, 7, 2) and bool(torch.isfinite(drawn).all())
