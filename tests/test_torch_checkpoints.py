"""The port's checkpoints (promp_tpu_torch/utils/checkpoints.py) against
the JAX package's (promp_tpu/utils/checkpoints.py): ``latest_snapshot``
picks the same file over the same directories, and a CPU Trainer resumed
by ``resume_trainer`` from a run's snapshots ends equal to the bit to an
uninterrupted one (parameters, step sizes, Adam state, hyperparameters and
the generator's state). Exact comparisons."""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.utils import checkpoints as jck  # noqa: E402
from promp_tpu_torch.optimizers.adam import tree_leaves  # noqa: E402
from promp_tpu_torch.run import build, run_experiment  # noqa: E402
from promp_tpu_torch.utils import checkpoints as tck  # noqa: E402
from promp_tpu_torch.utils import logger  # noqa: E402

TINY = dict(seed=4, env="MetaPointEnvCorner",
            env_kwargs={"reward_type": "dense"}, rollouts_per_meta_task=3,
            max_path_length=6, meta_batch_size=3, hidden_sizes=(8, 8),
            num_promp_steps=2, adaptive_inner_kl_penalty=True,
            log_formats=["csv"], device="cpu")


@pytest.mark.parametrize("names", [
    [],
    ["params.pkl", "itr_3.pkl"],
    ["itr_2.pkl", "itr_10.pkl", "itr_9.pkl"],
    ["itr_x.pkl", "itr_1.pkl", "progress.csv", "itr_4.pkl.tmp.7"],
    ["itr_x.pkl", "params.json"],
])
def test_latest_snapshot_matches_jax(tmp_path, names):
    for name in names:
        (tmp_path / name).write_bytes(b"")
    want = jck.latest_snapshot(str(tmp_path))
    assert tck.latest_snapshot(str(tmp_path)) == want
    if names:
        assert tck.latest_snapshot(str(tmp_path)) != str(tmp_path / "x")


def test_save_load_roundtrip_atomic(tmp_path):
    snap = {"itr": 3, "w": np.arange(4.0)}
    path = str(tmp_path / "sub" / "params.pkl")
    tck.save_snapshot(path, snap)
    got = tck.load_snapshot(path)
    assert got["itr"] == 3
    np.testing.assert_array_equal(got["w"], snap["w"])
    assert os.listdir(tmp_path / "sub") == ["params.pkl"]
    # the JAX package reads the port's file
    assert jck.load_snapshot(path)["itr"] == 3


def test_resume_without_snapshot_starts_at_zero(tmp_path):
    trainer = build(dict(TINY, n_itr=1))
    assert tck.resume_trainer(trainer, str(tmp_path)) == 0


def _state(trainer):
    return (trainer.train_state, trainer.opt_state,
            trainer._gen.get_state())


@pytest.mark.parametrize("mode", ["all", "last"])
def test_resumed_trainer_equals_uninterrupted(tmp_path, mode):
    logger.configure(dir=str(tmp_path / "whole"), format_strs=[],
                     snapshot_mode="none")
    whole = build(dict(TINY, n_itr=3))
    whole.train()

    run_dir = str(tmp_path / "run")
    run_experiment(dict(TINY, n_itr=2, snapshot_mode=mode),
                   dump_path=run_dir)
    logger.configure(dir=str(tmp_path / "resumed"), format_strs=[],
                     snapshot_mode="none")
    resumed = build(dict(TINY, n_itr=3))
    assert tck.resume_trainer(resumed, run_dir) == 2
    resumed.train()

    a, b = _state(whole), _state(resumed)
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) > 10
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(b[1].count) == 3 * 2   # 2 Adam epochs an iteration
    for k, v in whole.hparams.items():
        np.testing.assert_array_equal(resumed.hparams[k], v)
    # the adaptive KL coefficient moved, so the resumed run read it back
    assert not np.array_equal(whole.hparams["inner_kl_coeff"],
                              build(dict(TINY)).hparams["inner_kl_coeff"])
    logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def test_restore_refuses_another_devices_generator(tmp_path):
    trainer = build(dict(TINY, n_itr=1))
    snap = pickle.loads(pickle.dumps(trainer.get_itr_snapshot(0)))
    assert snap["rng_device"] == "cpu"
    snap["rng_device"] = "cuda"
    with pytest.raises(ValueError, match="generator"):
        trainer.restore(snap)
