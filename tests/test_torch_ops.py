"""Discounting and baselines of the port against promp_tpu.ops on the same
numpy inputs.

Tolerances (float32): discounted sums over T = 30 and GAE take atol 1e-5 /
rtol 1e-5 (both run a log-depth scan of affine maps, in possibly different
association order); normalization 1e-5. Ridge fits solve normal equations
in float32 with LAPACK on both sides, so fitted predictions are compared at
rtol 1e-4 / atol 1e-4, and an ill-conditioned fit only through its
(well-conditioned) predictions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.ops import baselines as jb  # noqa: E402
from promp_tpu.ops import discounting as jdc  # noqa: E402
from promp_tpu_torch.ops import baselines as tb  # noqa: E402
from promp_tpu_torch.ops import discounting as tdc  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
FIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _stream(seed=0, shape=(3, 4, 30)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    dones = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    return x, dones


@pytest.mark.parametrize("with_resets", [False, True])
def test_discount_cumsum(with_resets):
    x, dones = _stream()
    reset = dones if with_resets else None
    want = jax.jit(jdc.discount_cumsum, static_argnums=1)(
        jnp.asarray(x), 0.97,
        None if reset is None else jnp.asarray(reset))
    got = tdc.discount_cumsum(torch.as_tensor(x), 0.97,
                              reset=None if reset is None
                              else torch.as_tensor(reset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_discount_cumsum_is_the_recursion():
    x, dones = _stream(1, (2, 17))
    y = np.zeros_like(x)
    acc = np.zeros(x.shape[0], np.float64)
    for t in reversed(range(x.shape[-1])):
        acc = x[:, t] + 0.9 * (1 - dones[:, t]) * acc
        y[:, t] = acc
    got = tdc.discount_cumsum(torch.as_tensor(x), 0.9,
                              reset=torch.as_tensor(dones))
    np.testing.assert_allclose(got.numpy(), y, **TOL)


@pytest.mark.parametrize("with_resets", [False, True])
def test_gae(with_resets):
    r, dones = _stream(2)
    v = np.random.default_rng(3).normal(size=r.shape).astype(np.float32)
    reset = dones if with_resets else None
    want = jax.jit(jdc.gae_advantages, static_argnums=(2, 3))(
        jnp.asarray(r), jnp.asarray(v), 0.99, 0.95,
        None if reset is None else jnp.asarray(reset))
    got = tdc.gae_advantages(torch.as_tensor(r), torch.as_tensor(v), 0.99,
                             0.95, reset=None if reset is None
                             else torch.as_tensor(reset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_normalize_and_shift():
    a, mask = _stream(4)
    np.testing.assert_allclose(
        tdc.normalize_advantages(torch.as_tensor(a)).numpy(),
        np.asarray(jdc.normalize_advantages(jnp.asarray(a))), **TOL)
    np.testing.assert_allclose(
        tdc.normalize_advantages(torch.as_tensor(a),
                                 torch.as_tensor(mask)).numpy(),
        np.asarray(jdc.normalize_advantages(jnp.asarray(a),
                                            jnp.asarray(mask))), **TOL)
    np.testing.assert_allclose(
        tdc.shift_advantages_to_positive(torch.as_tensor(a)).numpy(),
        np.asarray(jdc.shift_advantages_to_positive(jnp.asarray(a))), **TOL)


def _rollout_like(seed=5, p=6, t=25):
    rng = np.random.default_rng(seed)
    obs = rng.normal(scale=3.0, size=(p, t, 2)).astype(np.float32)
    obs[0, 0] = [15.0, -12.0]  # past the +-10 clip
    timesteps = np.tile(np.arange(t, dtype=np.int32), (p, 1))
    targets = rng.normal(size=(p, t)).astype(np.float32)
    return obs, timesteps, targets


def test_features():
    obs, ts, _ = _rollout_like()
    np.testing.assert_allclose(
        tb.feature_features(torch.as_tensor(obs), torch.as_tensor(ts)).numpy(),
        np.asarray(jb.feature_features(jnp.asarray(obs), jnp.asarray(ts))),
        **TOL)
    np.testing.assert_allclose(
        tb.time_features(torch.as_tensor(ts)).numpy(),
        np.asarray(jb.time_features(jnp.asarray(ts))), **TOL)


@pytest.mark.parametrize("kind", ["feature", "time"])
def test_fit_predict(kind):
    obs, ts, y = _rollout_like()
    mask = np.ones_like(y)
    mask[-1, 10:] = 0.0
    if kind == "feature":
        jf = jb.feature_features(jnp.asarray(obs), jnp.asarray(ts))
        tf = tb.feature_features(torch.as_tensor(obs), torch.as_tensor(ts))
    else:
        jf = jb.time_features(jnp.asarray(ts))
        tf = tb.time_features(torch.as_tensor(ts))
    jf, tf = jf.reshape(-1, jf.shape[-1]), tf.reshape(-1, tf.shape[-1])
    for m in (None, mask.reshape(-1)):
        jc = jax.jit(jb.fit_linear_baseline)(
            jf, jnp.asarray(y.reshape(-1)),
            None if m is None else jnp.asarray(m))
        tc = tb.fit_linear_baseline(tf, torch.as_tensor(y.reshape(-1)),
                                    mask=None if m is None
                                    else torch.as_tensor(m))
        np.testing.assert_allclose(
            tb.predict_linear_baseline(tf, tc).numpy(),
            np.asarray(jb.predict_linear_baseline(jf, jc)), **FIT_TOL)


def test_fit_batched_over_tasks():
    obs, ts, y = _rollout_like()
    tf = tb.feature_features(torch.as_tensor(obs), torch.as_tensor(ts))
    both = tb.fit_linear_baseline(tf.reshape(2, -1, 8),
                                  torch.as_tensor(y).reshape(2, -1))
    for i in range(2):
        alone = tb.fit_linear_baseline(tf.reshape(2, -1, 8)[i],
                                       torch.as_tensor(y).reshape(2, -1)[i])
        np.testing.assert_allclose(both[i].numpy(), alone.numpy(), **FIT_TOL)


def test_nan_ladder():
    """Two identical columns of size ~100 make F^T F singular to float32
    rounding: reg 1e-5 .. 1e-2 vanish against its diagonal (~5e5) and the
    LU solve yields NaN; only reg 1e-1 survives. Both packages must climb
    the ladder to the same rung."""
    rng = np.random.default_rng(0)
    c = rng.uniform(90, 110, 50).astype(np.float32)
    feats = np.stack([c, c, rng.normal(size=50).astype(np.float32)], 1)
    y = rng.normal(size=50).astype(np.float32)
    gram = torch.as_tensor(feats.T @ feats)
    first, _ = torch.linalg.solve_ex(gram + 1e-5 * torch.eye(3),
                                     torch.as_tensor(feats.T @ y))
    assert not bool(torch.isfinite(first).all())
    jc = np.asarray(jax.jit(jb.fit_linear_baseline)(jnp.asarray(feats),
                                                    jnp.asarray(y)))
    tc = tb.fit_linear_baseline(torch.as_tensor(feats), torch.as_tensor(y))
    assert np.isfinite(jc).all() and bool(torch.isfinite(tc).all())
    np.testing.assert_allclose(feats @ tc.numpy(), feats @ jc, **FIT_TOL)
    np.testing.assert_allclose(tc.numpy()[2], jc[2], **FIT_TOL)
