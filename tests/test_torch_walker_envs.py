"""One step of the port's Walker2DRandVelEnv (K2's route: no physics
mods) against the JAX package's, physics included, and of
Walker2DRandDirecEnv, whose physics is the same, with the JAX step taking
the port's next state; at the bars of tests/test_torch_rand_params.py's
``check_one_step``."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_rand_params import check_one_step  # noqa: E402
from test_torch_support import torch_single_thread  # noqa: E402,F401


@pytest.mark.parametrize("name, physics", [("Walker2DRandVelEnv", True),
                                           ("Walker2DRandDirecEnv", False)])
def test_walker_step_matches_jax(name, physics):
    check_one_step(name, physics)
