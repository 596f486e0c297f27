"""The port's DICE sample processor (promp_tpu_torch/sampling/
dice_processor.py) against promp_tpu/sampling/dice_processor.py on the
same trajectories: dones mid-path (the mask runs through the first done,
inclusive), a path whose done is its last step and one with no done; with
and without ``return_baseline`` and ``positive_adv``; and a kernel-backend
trajectory (dones all false, no env_infos), whose mask is all ones.

Sizes: 2 tasks x 4 paths x 8 steps, obs 2: 32 rows a task, of which the
mask keeps about 20, for the 8 features of the feature baseline (at 2
paths x 5 steps the masked fit would be near-singular, and its residuals
solver noise, ROADMAP.md §3). Tolerances: test_torch_support.METRIC_TOL
on every buffer and statistic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import METRIC_TOL, np_tree, torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.sampling import dice_processor as jdice  # noqa: E402
from promp_tpu_torch.sampling import dice_processor as tdice  # noqa: E402

SHAPE = (2, 4, 8)


def _trajectory(seed, dones=True):
    """A random rollout dict: dones at chosen steps (path 0 mid-path twice,
    path 1 at its last step, path 2 never, path 3 at random) unless
    ``dones`` is False; env_infos one float leaf."""
    rng = np.random.default_rng(seed)
    n_t, n_p, horizon = SHAPE
    done = np.zeros(SHAPE, bool)
    if dones:
        done[:, 0, [3, 6]] = True
        done[:, 1, -1] = True
        done[:, 3] = rng.random((n_t, horizon)) < 0.3
    timesteps = np.tile(np.arange(horizon, dtype=np.int32), (n_t, n_p, 1))
    traj = dict(
        observations=rng.normal(size=SHAPE + (2,)).astype(np.float32),
        actions=rng.normal(size=SHAPE + (2,)).astype(np.float32),
        rewards=rng.normal(size=SHAPE).astype(np.float32),
        dones=done,
        timesteps=timesteps,
        agent_infos=dict(
            mean=rng.normal(size=SHAPE + (2,)).astype(np.float32),
            log_std=rng.normal(size=SHAPE + (2,)).astype(np.float32) * 0.1),
        env_infos=dict(reward_ctrl=rng.normal(size=SHAPE).astype(
            np.float32)) if dones else {})
    return traj


def _to(xp_asarray, tree):
    return {k: _to(xp_asarray, v) if isinstance(v, dict) else xp_asarray(v)
            for k, v in tree.items()}


def test_prefix_mask_matches_jax():
    dones = _trajectory(0)["dones"]
    got = tdice.prefix_mask(torch.tensor(dones)).numpy()
    want = np.asarray(jdice.prefix_mask(jnp.asarray(dones)))
    np.testing.assert_array_equal(got, want)
    # through the first done, inclusive
    np.testing.assert_array_equal(got[0, 0], [1, 1, 1, 1, 0, 0, 0, 0])
    assert got[0, 1].all() and got[0, 2].all()


def _check(kw, traj):
    want = np_tree(jax.jit(jdice.DiceSampleProcessor(**kw).process)(
        _to(jnp.asarray, traj)))
    got = tdice.DiceSampleProcessor(**kw).process(_to(torch.tensor, traj))
    got_stats, want_stats = got.pop("stats"), want.pop("stats")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for kk in v:
                np.testing.assert_allclose(got[k][kk].numpy(), v[kk],
                                           err_msg=f"{k}/{kk}", **METRIC_TOL)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, err_msg=k,
                                       **METRIC_TOL)
    assert set(got_stats) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(float(got_stats[k]), float(v), err_msg=k,
                                   **METRIC_TOL)
    return got


@pytest.mark.parametrize("positive_adv", [False, True],
                         ids=["normalized", "positive"])
@pytest.mark.parametrize("return_baseline", [None, "LinearFeatureBaseline"],
                         ids=["time_baseline", "return_baseline"])
def test_process_matches_jax(return_baseline, positive_adv):
    got = _check(dict(max_path_length=SHAPE[-1],
                      return_baseline=return_baseline,
                      positive_adv=positive_adv), _trajectory(1))
    assert ("advantages" in got) == (return_baseline is not None)
    mask = got["mask"].numpy()
    assert 0 < mask.mean() < 1
    # the buffers are zero off the mask
    assert not got["observations"].numpy()[mask == 0].any()
    assert not got["agent_infos"]["mean"].numpy()[mask == 0].any()


def test_kernel_trajectory_has_a_full_mask():
    """K1's trajectories come with dones all false and no env_infos."""
    got = _check(dict(max_path_length=SHAPE[-1]),
                 _trajectory(2, dones=False))
    assert got["mask"].numpy().all()
    assert got["env_infos"] == {}
