"""The whole slice: one ProMP meta-iteration of the port's Trainer against
the JAX Trainer, at 4 tasks x 5 envs x 20 steps, on the same parameters,
tasks, initial states and noise: rollout_backend "scan" against "scan",
and "kernel" (K1's plain version, on the CPU) against "pallas" (the Pallas
kernel in interpret mode); plus the Trainer's own contract (no quiet
fallback, snapshots, the training loop).

Tolerances are stated in test_torch_support.py; reward flips at K1's
goal-corner comparison are counted and resolved as it describes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    check_parity, jax_phases, make_port_trainer, run_both,
    torch_single_thread)
from promp_tpu_torch.utils import logger  # noqa: E402


def test_one_meta_iteration_matches_jax_scan(jax_phases):
    # the env's reward uses one norm form for the goal and the corners, so
    # its ties resolve alike in both packages
    check_parity(run_both("scan", jax_phases), max_flips=0)


def test_one_meta_iteration_matches_jax_pallas(jax_phases):
    # 3 of the 800 rewards flip at K1's goal-corner comparison (see
    # test_torch_support.py); allow a few
    check_parity(run_both("kernel", jax_phases), max_flips=6)


def test_kernel_backend_refuses_an_env_it_does_not_cover():
    with pytest.raises(ValueError, match="reward_type is 'dense'"):
        make_port_trainer("kernel", reward_type="dense", device="cpu")
    with pytest.raises(ValueError, match="rollout_backend"):
        make_port_trainer("pallas", device="cpu")


def test_entry_point_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_port_trainer("scan")


def test_train_snapshot_and_restore(tmp_path):
    """train() logs every key, and a run resumed from a snapshot continues
    exactly as the uninterrupted run."""
    try:
        logger.configure(dir=str(tmp_path), format_strs=["csv"])
        straight = make_port_trainer("kernel", device="cpu", n_itr=2)
        straight.train()
        logger.Logger.CURRENT.close()
        header = (tmp_path / "progress.csv").read_text().splitlines()[0]
        for key in ("Time-Sampling", "Time-SampleProc", "Time-InnerStep",
                    "Time-OuterStep", "PolicyExecTime", "EnvExecTime",
                    "LossBefore", "KLOuter", "SkippedUpdates",
                    "Step_1-AverageReturn", "ItrTime"):
            assert key in header.split(","), key
        assert (tmp_path / "params.pkl").exists()

        logger.Logger.CURRENT = logger.Logger(None, [])
        first = make_port_trainer("kernel", device="cpu", n_itr=1)
        first.train()
        snap = first.get_itr_snapshot(0)
        resumed = make_port_trainer("kernel", device="cpu", n_itr=2, seed=99)
        resumed.restore(snap)
        assert resumed.start_itr == 1
        resumed.train()
        for k, v in straight.train_state["params"].items():
            assert torch.equal(resumed.train_state["params"][k], v), k
    finally:
        logger.Logger.CURRENT = None


def test_set_seed_returns_a_seeded_generator():
    from promp_tpu_torch.utils.misc import set_seed
    a = torch.rand(3, generator=set_seed(5, "cpu"))
    assert torch.equal(a, torch.rand(3, generator=set_seed(5, "cpu")))
    set_seed(5, "cpu")
    draws = (np.random.rand(), torch.rand(()).item())
    set_seed(5, "cpu")
    assert (np.random.rand(), torch.rand(()).item()) == draws
    # like the Trainer, it asks for the card unless told otherwise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            set_seed(5)
