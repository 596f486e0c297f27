"""One ProMP meta-iteration of the port's Trainer on
normalize(AntRandGoalEnv()) and normalize(HumanoidRandDirecEnv()), the
main path of bench.py's "ant" and "humanoid" workloads, at a tiny size on
the CPU (2 tasks x 2 envs x 3 steps, a (8, 8) policy; every env step runs
K2's plain version): the observation and action widths, finite losses,
KLs, returns and parameters, no skipped Adam update, and the envs'
diagnostics logged. The envs themselves are held against the JAX package
in tests/test_torch_ant.py and tests/test_torch_humanoid.py; a JAX Trainer
on these bodies would not fit the CPU's test budget.
"""
import csv
import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_support import ALGO, PROC, torch_single_thread  # noqa: E402,F401
from promp_tpu_torch import envs as tenvs  # noqa: E402
from promp_tpu_torch.algos.promp import ProMP  # noqa: E402
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy  # noqa: E402
from promp_tpu_torch.sampling.processor import SampleProcessor  # noqa: E402
from promp_tpu_torch.trainer import Trainer  # noqa: E402
from promp_tpu_torch.utils import logger  # noqa: E402

CASES = [("AntRandGoalEnv", 113, 8, "AverageForwardReturn"),
         ("HumanoidRandDirecEnv", 376, 17, "Env-reward_linvel")]


@pytest.mark.parametrize("name, obs_dim, act_dim, diag", CASES)
def test_one_meta_iteration(tmp_path, name, obs_dim, act_dim, diag):
    env = tenvs.normalize(tenvs.make_env(name))
    assert (env.obs_dim, env.action_dim) == (obs_dim, act_dim)
    policy = GaussianMLPPolicy(obs_dim=obs_dim, action_dim=act_dim,
                               hidden_sizes=(8, 8))
    trainer = Trainer(algo=ProMP(policy=policy, **dict(ALGO,
                                                       num_ppo_steps=2)),
                      env=env, policy=policy,
                      sample_processor=SampleProcessor(**PROC),
                      meta_batch_size=2, rollouts_per_meta_task=2,
                      max_path_length=3, n_itr=1, seed=1,
                      rollout_backend="scan", device="cpu")
    try:
        logger.configure(dir=str(tmp_path), format_strs=["csv"])
        state = trainer.train()
    finally:
        logger.Logger.CURRENT.close()
    with open(tmp_path / "progress.csv") as f:
        (row,) = list(csv.DictReader(f))
    for key in ("LossBefore", "LossAfter", "KLInner", "KLOuter",
                "Step_0-AverageReturn", "Step_1-AverageReturn",
                f"Step_0-{diag}", f"Step_1-{diag}"):
        assert math.isfinite(float(row[key])), key
    assert float(row["SkippedUpdates"]) == 0
    assert state["params"]["mean_network/hidden_0/kernel"].shape == (
        obs_dim, 8)
    assert state["params"]["mean_network/output/kernel"].shape == (8,
                                                                   act_dim)
    assert all(bool(torch.isfinite(v).all())
               for v in state["params"].values())
