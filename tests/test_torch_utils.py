"""The port's misc helpers (promp_tpu_torch/utils/misc.py) and baseline
classes (promp_tpu_torch/ops/baseline_classes.py) against the JAX
package's (promp_tpu/utils/misc.py, promp_tpu/ops/baseline_classes.py),
mirroring tests/test_utils.py.

Tolerances: the helpers are exact (equal values, float64 for the
explained variance); the baselines' float32 ridge solves on the same
inputs within atol 1e-4 on the coefficients and 1e-4 on the predictions
(both packages solve the same 10x10 normal equations in other orders).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.ops import baseline_classes as jbase  # noqa: E402
from promp_tpu.utils import misc as jmisc  # noqa: E402
from promp_tpu_torch.ops import baseline_classes as tbase  # noqa: E402
from promp_tpu_torch.utils import misc as tmisc  # noqa: E402

BASELINE_TOL = dict(atol=1e-4, rtol=1e-4)


class TestExtract:
    def test_dict(self):
        d = {"a": 1, "b": 2, "c": 3}
        assert tmisc.extract(d, "c", "a") == jmisc.extract(d, "c", "a") \
            == (3, 1)

    def test_list_of_dicts(self):
        ds = [{"a": 1, "b": 10}, {"a": 2, "b": 20}]
        assert tmisc.extract(ds, "a", "b") == jmisc.extract(ds, "a", "b") \
            == ([1, 2], [10, 20])

    def test_unsupported(self):
        with pytest.raises(NotImplementedError):
            tmisc.extract(42, "a")


class TestExplainedVariance:
    @pytest.mark.parametrize("case", ["perfect", "mean", "worse", "noisy"])
    def test_against_jax(self, case):
        rng = np.random.RandomState(3)
        y = rng.randn(500)
        ypred = {"perfect": y, "mean": np.full_like(y, y.mean()),
                 "worse": -3 * y, "noisy": y + 0.5 * rng.randn(500)}[case]
        want = jmisc.explained_variance_1d(ypred, y)
        assert tmisc.explained_variance_1d(ypred, y) == want
        # torch tensors go through the same float64 path
        assert tmisc.explained_variance_1d(
            torch.tensor(ypred, dtype=torch.float32),
            torch.tensor(y, dtype=torch.float32)) == \
            jmisc.explained_variance_1d(ypred.astype(np.float32),
                                        y.astype(np.float32))

    def test_constant_target(self):
        y = np.ones(10)
        for ypred in (np.ones(10), np.arange(10.0)):
            assert tmisc.explained_variance_1d(ypred, y) == \
                jmisc.explained_variance_1d(ypred, y)
        assert tmisc.explained_variance_1d(np.ones(10), y) == 1.0
        assert tmisc.explained_variance_1d(np.arange(10.0), y) == 0.0


class TestTensorDictHelpers:
    def _dicts(self):
        return [
            {"x": np.ones((2, 3)), "info": {"r": np.zeros(2)}},
            {"x": 2 * np.ones((4, 3)), "info": {"r": np.ones(4)}},
        ]

    @staticmethod
    def _torch(d):
        return {k: TestTensorDictHelpers._torch(v) if isinstance(v, dict)
                else torch.tensor(v) for k, v in d.items()}

    @staticmethod
    def _check(got, want):
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], dict):
                TestTensorDictHelpers._check(got[k], want[k])
            else:
                g = got[k].numpy() if isinstance(got[k], torch.Tensor) \
                    else got[k]
                assert g.shape == want[k].shape
                np.testing.assert_array_equal(g, want[k])

    @pytest.mark.parametrize("kind", ["numpy", "torch"])
    def test_concat(self, kind):
        ds = self._dicts()
        want = jmisc.concat_tensor_dict_list(ds)
        if kind == "torch":
            ds = [self._torch(d) for d in ds]
        got = tmisc.concat_tensor_dict_list(ds)
        assert isinstance(got["x"], torch.Tensor) == (kind == "torch")
        self._check(got, want)

    @pytest.mark.parametrize("kind", ["numpy", "torch"])
    def test_stack(self, kind):
        ds = [{"x": np.ones(3), "info": {"r": np.zeros(2)}},
              {"x": np.zeros(3), "info": {"r": np.ones(2)}}]
        want = jmisc.stack_tensor_dict_list(ds)
        if kind == "torch":
            ds = [self._torch(d) for d in ds]
        self._check(tmisc.stack_tensor_dict_list(ds), want)


class TestSetSeed:
    def test_numpy_and_generator_determinism(self):
        g1 = tmisc.set_seed(123, device="cpu")
        a = np.random.rand(4), torch.rand(3, generator=g1)
        g2 = tmisc.set_seed(123, device="cpu")
        b = np.random.rand(4), torch.rand(3, generator=g2)
        np.testing.assert_array_equal(a[0], b[0])
        assert torch.equal(a[1], b[1])

    def test_large_seed_wraps(self):
        tmisc.set_seed(2**63 - 1, device="cpu")


def _baseline_data(seed, mask=False):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(3, 7, 3)).astype(np.float32)
    timesteps = np.tile(np.arange(7, dtype=np.int32), (3, 1))
    targets = rng.normal(size=(3, 7)).astype(np.float32)
    m = (rng.random((3, 7)) < 0.8).astype(np.float32) if mask else None
    return obs, timesteps, targets, m


@pytest.mark.parametrize("cls", ["LinearFeatureBaseline",
                                 "LinearTimeBaseline", "ZeroBaseline"])
@pytest.mark.parametrize("mask", [False, True])
def test_baseline_fit_predict(cls, mask):
    obs, ts, targets, m = _baseline_data(1, mask)
    jb, tb = getattr(jbase, cls)(), getattr(tbase, cls)()
    # before a fit both predict zeros
    np.testing.assert_array_equal(
        tb.predict(torch.tensor(obs), torch.tensor(ts)).numpy(),
        np.asarray(jb.predict(jnp.asarray(obs), jnp.asarray(ts))))
    jb.fit(jnp.asarray(obs), jnp.asarray(ts), jnp.asarray(targets),
           None if m is None else jnp.asarray(m))
    tb.fit(torch.tensor(obs), torch.tensor(ts), torch.tensor(targets),
           None if m is None else torch.tensor(m))
    if cls != "ZeroBaseline":
        np.testing.assert_allclose(tb.get_param_values().numpy(),
                                   np.asarray(jb.get_param_values()),
                                   **BASELINE_TOL)
    obs2, ts2, _, _ = _baseline_data(2)
    np.testing.assert_allclose(
        tb.predict(torch.tensor(obs2), torch.tensor(ts2)).numpy(),
        np.asarray(jb.predict(jnp.asarray(obs2), jnp.asarray(ts2))),
        **BASELINE_TOL)


def test_baseline_set_params():
    tb = tbase.LinearTimeBaseline()
    coeffs = torch.tensor([1.0, 0.0, 0.0, 2.0])
    tb.set_params(coeffs)
    assert tb.get_param_values() is coeffs
    ts = torch.arange(5)
    np.testing.assert_allclose(tb.predict(None, ts).numpy(),
                               (ts.numpy() / 100.0 + 2.0).astype(np.float32),
                               rtol=1e-6)


def test_multithreaded_cpu_solve_at_ant_size():
    """The ridge fit at the ant's 230 features with two torch threads
    finishes and agrees with the one-thread batched solve (torch's batched
    CPU solve stalls there; ops/baselines.py solves one system at a time).
    Run in a subprocess with a time limit, so that a stall fails the test
    instead of holding the worker."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch\n"
        "from promp_tpu_torch.ops.baselines import fit_linear_baseline\n"
        "g = torch.Generator().manual_seed(0)\n"
        "f = torch.randn(2, 400, 230, generator=g)\n"
        "y = torch.randn(2, 400, generator=g)\n"
        "torch.set_num_threads(1)\n"
        "one = fit_linear_baseline(f, y)\n"
        "torch.set_num_threads(2)\n"
        "two = fit_linear_baseline(f, y)\n"
        "assert two.shape == (2, 230) and torch.isfinite(two).all()\n"
        "torch.testing.assert_close(two, one, atol=1e-4, rtol=1e-4)\n")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
