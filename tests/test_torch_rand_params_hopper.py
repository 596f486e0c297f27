"""The port's ``normalize(HopperRandParamsEnv())`` rollout through its
auto-resets, and one step of ``HalfCheetahRandParamsEnv``, against the JAX
package, at the bars of tests/test_torch_rand_params.py (whose helpers
these are; split from it to keep each file's JAX compiles near 30 s). The
cheetah's step takes the port's next state on the JAX side: its physics
with the multipliers is K3's plain version, held against the Pallas K3 on
half_cheetah in tests/test_torch_substep_mods.py, and the task-to-mods
wiring is the walker's and the hopper's, held through their rollouts."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_rand_params import (  # noqa: E402
    check_one_step, check_rollout, rollout_pair)
from test_torch_support import torch_single_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def hopper_rollouts():
    return rollout_pair("HopperRandParamsEnv")


def test_hopper_rollout_matches_jax_through_auto_resets(hopper_rollouts):
    check_rollout(*hopper_rollouts)


def test_cheetah_rand_params_step_matches_jax():
    check_one_step("HalfCheetahRandParamsEnv", physics=False)
