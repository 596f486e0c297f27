"""The port's Trainer modes (promp_tpu_torch/trainer.py): ``fused`` and the
phase-split loop reach the same train_state from one seed; with
``timing_every`` the unmeasured iterations log the last measured Time-*
values and skip the policy re-timing; ``profile_dir`` writes a Chrome
trace of iteration ``profile_itr``; and a TRPO-MAML run, whose optimizer
state is ``()``, resumes from a snapshot exactly as the uninterrupted run.

Port only (the modes change no number of the iteration), on the CPU, at 2
tasks x 2 envs x 5 steps with an (8, 8) policy on the sparse point mass
(K1's plain version) and the dense one (the scan engine).
"""
import csv
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu_torch import envs  # noqa: E402
from promp_tpu_torch.algos import TRPOMAML, ProMP  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor  # noqa: E402
from promp_tpu_torch.trainer import Trainer  # noqa: E402
from promp_tpu_torch.utils import logger  # noqa: E402

TIME_KEYS = ("Time-Sampling", "Time-SampleProc", "Time-InnerStep",
             "Time-OuterStep", "Time-MAMLSteps", "PolicyExecTime",
             "EnvExecTime")


def _trainer(algo="ProMP", reward_type="sparse", **kw):
    env = envs.normalize(envs.MetaPointEnvCorner(reward_type=reward_type))
    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=(8, 8))
    if algo == "ProMP":
        algo = ProMP(policy=policy, num_ppo_steps=2)
    else:
        algo = TRPOMAML(policy=policy, inner_type="log_likelihood")
    run = dict(meta_batch_size=2, rollouts_per_meta_task=2, max_path_length=5,
               n_itr=2, seed=5, device="cpu",
               rollout_backend="kernel" if reward_type == "sparse" else "scan")
    return Trainer(algo=algo, env=env, policy=policy,
                   sample_processor=SampleProcessor(normalize_adv=True),
                   **dict(run, **kw))


@pytest.fixture
def csv_log(tmp_path):
    """Logs to a CSV under tmp_path; yields a function that returns its
    rows."""
    logger.configure(dir=str(tmp_path), format_strs=["csv"])

    def rows():
        logger.Logger.CURRENT.close()
        with open(tmp_path / "progress.csv") as f:
            return list(csv.DictReader(f))

    try:
        yield rows
    finally:
        logger.Logger.CURRENT = None


def test_fused_and_phase_split_reach_the_same_state(csv_log):
    split = _trainer()
    split.train()
    fused = _trainer(fused=True)
    fused.train()
    for part in ("params", "step_sizes"):
        for k, v in split.train_state[part].items():
            assert torch.equal(fused.train_state[part][k], v), (part, k)
    assert torch.equal(fused.opt_state.mu["params"]["mean_network/output/bias"],
                       split.opt_state.mu["params"]["mean_network/output/bias"])
    rows = csv_log()
    assert len(rows) == 4
    for key in TIME_KEYS:
        assert rows[0][key] != "", key         # the phase-split run's
        assert rows[3][key] == "", key         # the fused run logs none
    assert rows[3]["LossBefore"] == rows[1]["LossBefore"]


def test_timing_every_carries_the_measured_times_forward(csv_log):
    trainer = _trainer(n_itr=3, timing_every=2)
    forwards = []
    policy_fwd = trainer._policy_fwd
    trainer._policy_fwd = lambda *a: forwards.append(1) or policy_fwd(*a)
    trainer.train()
    rows = csv_log()
    assert len(rows) == 3
    for key in TIME_KEYS:
        assert rows[1][key] == rows[0][key], key   # carried from itr 0
    for key in ("Time-Sampling", "Time-OuterStep"):
        assert rows[2][key] != rows[0][key], key   # measured again
    # the policy's forwards are re-timed once a round, in itrs 0 and 2 only
    assert len(forwards) == 2 * 2


def test_profile_dir_writes_a_trace(tmp_path):
    trainer = _trainer(profile_dir=str(tmp_path / "trace"), profile_itr=1)
    trainer.train()
    assert trainer.profile_trace == str(tmp_path / "trace" / "trace_itr1.json")
    with open(trainer.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)
    assert len(list((tmp_path / "trace").iterdir())) == 1


def test_trpo_snapshot_and_restore_with_empty_opt_state():
    straight = _trainer("TRPOMAML", reward_type="dense")
    assert straight.opt_state == ()
    straight.train()
    first = _trainer("TRPOMAML", reward_type="dense", n_itr=1)
    first.train()
    snap = first.get_itr_snapshot(0)
    assert snap["opt_state"] == ()
    resumed = _trainer("TRPOMAML", reward_type="dense", seed=99)
    resumed.restore(snap)
    assert resumed.opt_state == () and resumed.start_itr == 1
    resumed.train()
    for k, v in straight.train_state["params"].items():
        assert torch.equal(resumed.train_state["params"][k], v), k
