"""GaussianMLPPolicy of the port against the JAX policy, with the JAX
parameters loaded through promp_tpu_torch.weights. Tolerance: float32, atol
1e-5 / rtol 1e-5 (a 3-layer MLP at width 16; only summation order differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.policies import gaussian_mlp as jp  # noqa: E402
from promp_tpu_torch.policies import gaussian_mlp as tp  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params, to_numpy_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (16, 16)


@pytest.fixture(scope="module")
def setup():
    jpol = jp.GaussianMLPPolicy(obs_dim=3, action_dim=2, hidden_sizes=HIDDEN)
    tpol = tp.GaussianMLPPolicy(obs_dim=3, action_dim=2, hidden_sizes=HIDDEN)
    jparams = jpol.init(jax.random.PRNGKey(0))
    # a log_std below the floor, so floor_std changes the result
    jparams = dict(jparams)
    jparams["log_std_network/log_std_var"] = jnp.array([[-20.0, 0.3]])
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    obs = np.random.default_rng(0).normal(size=(4, 5, 3)).astype(np.float32)
    return jpol, tpol, jparams, np_params, obs


def test_weights_round_trip(setup):
    _, _, _, np_params, _ = setup
    back = to_numpy_params(from_numpy_params(np_params, "cpu"))
    assert back.keys() == np_params.keys()
    for k in np_params:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], np_params[k])


def test_init_names_shapes_and_scale(setup):
    jpol, tpol, jparams, _, _ = setup
    params = tpol.init(torch.Generator().manual_seed(0), "cpu")
    assert params.keys() == jparams.keys()
    for k, v in params.items():
        assert tuple(v.shape) == tuple(jparams[k].shape), k
        assert v.dtype == torch.float32
    # glorot-uniform bound sqrt(6 / (fan_in + fan_out)), zero biases
    k0 = params["mean_network/hidden_0/kernel"]
    assert float(k0.abs().max()) <= np.sqrt(6.0 / (3 + 16))
    assert float(params["mean_network/output/bias"].abs().max()) == 0.0
    np.testing.assert_allclose(
        params["log_std_network/log_std_var"].numpy(), 0.0)


@pytest.mark.parametrize("floor_std", [True, False])
def test_apply_matches_jax(setup, floor_std):
    jpol, tpol, jparams, np_params, obs = setup
    want = jpol.apply(jparams, jnp.asarray(obs), floor_std=floor_std)
    got = tpol.apply(from_numpy_params(np_params, "cpu"),
                     torch.as_tensor(obs), floor_std=floor_std)
    for k in ("mean", "log_std"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert float(got["log_std"][0, 0, 0]) == (
        pytest.approx(tpol.min_log_std) if floor_std else -20.0)


def test_replicate_and_flatten_round_trip(setup):
    jpol, tpol, jparams, np_params, _ = setup
    params = from_numpy_params(np_params, "cpu")
    rep = tpol.replicate(params, 3)
    jrep = jpol.replicate(jparams, 3)
    for k in params:
        np.testing.assert_array_equal(rep[k].numpy(), np.asarray(jrep[k]))
    flat, spec = tp.flatten_params(params)
    jflat, _ = jp.flatten_params(jparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = tp.unflatten_params(flat, spec)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), np_params[k])
