"""Smoke run of the PyTorch/CUDA port (promp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit;
  2. build: K1 (csrc/rollout_kernel.cu) compiled with nvcc, and its time;
  3. k1_vs_plain: K1 against its plain PyTorch version at the main path's
     shape (40 tasks x 20 envs x 100 steps, a (64, 64) policy) on the same
     inputs: errors, reward-branch flips and their tie margins, paid
     rewards and their sums, timings;
  4. trainer: the main path, 3 ProMP meta-iterations on
     normalize(MetaPointEnvCorner()) at the reference settings with
     rollout_backend="kernel"; K1's launches (2 per iteration), finite
     losses, KLs and returns, no skipped Adam updates, per-iteration times.
Then the {"kernels": [...]} line, the card's name and power limit as
nvidia-smi prints them, and the final {"ok": true, ...} line. Any failure
raises, and the script exits non-zero without the final line. It needs a
CUDA device and imports neither JAX nor the JAX package.
"""
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# main-path shape (the reference run-script defaults)
N_TASKS, N_ENVS, HORIZON, HIDDEN = 40, 20, 100, (64, 64)
N_ITR = 3
# K1 against its plain version, float32: per-op rounding differs (FMA
# chains vs matmul summation order, tanhf/expf ulps) and compounds over the
# 100-step trajectory, hence 1e-4 on obs/actions/means; a reward whose
# branch agrees is a difference of two sqrt's of those states (1e-5). A
# reward-branch flip is allowed only at a true float tie (the L1 radius,
# or another corner as near as the goal: margin < 1e-5), and at most
# MAX_FLIPS of the 80,000 steps may flip (0 seen so far). The summed
# rewards may then differ by TOL_REWARD a step plus one step's progress
# (at most 0.2 * sqrt(2)) a flip.
TOL_TRAJ, TOL_REWARD, TOL_TIE = 1e-4, 1e-5, 1e-5
MAX_FLIPS = 8
MAX_STEP_PROGRESS = 0.2 * 2 ** 0.5
# published H100 SXM peaks at 700 W: FP32 without tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
TIMED_RUNS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, runs=TIMED_RUNS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(device, seed=0):
    """Random policy parameters per task (from a seed) at the main-path
    shape, with per-task output biases that drive the point out of the
    L1 radius so that both reward branches are taken."""
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    gen = torch.Generator(device=device).manual_seed(seed)
    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    params = policy.init(gen, device)
    task_params = {k: v.expand((N_TASKS,) + v.shape).contiguous()
                   for k, v in params.items()}
    task_params["mean_network/output/bias"] = (
        torch.rand((N_TASKS, 2), generator=gen, device=device) * 16.0 - 8.0)
    task_params["log_std_network/log_std_var"] = (
        torch.rand((N_TASKS, 1, 2), generator=gen, device=device) - 0.5)
    corners = torch.tensor([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0],
                            [2.0, 2.0]], device=device)
    goals = corners[torch.randint(0, 4, (N_TASKS,), generator=gen,
                                  device=device)]
    obs0 = torch.rand((N_TASKS, N_ENVS, 2), generator=gen,
                      device=device) * 0.4 - 0.2
    noise = torch.randn((N_TASKS, HORIZON, N_ENVS, 2), generator=gen,
                        device=device)
    return task_params, goals, obs0, noise


def k1_bound(task_params, goals, obs0, noise):
    """Least time for K1's work on this card: every input read once and
    every output written once, against the FP32 multiply-adds of the MLP."""
    h0 = task_params["mean_network/hidden_0/kernel"].shape[-1]
    h1 = task_params["mean_network/hidden_1/kernel"].shape[-1]
    steps = noise.shape[0] * noise.shape[1] * noise.shape[2]
    flops = 2.0 * steps * (2 * h0 + h0 * h1 + h1 * 2)
    in_bytes = sum(t.numel() * 4 for t in
                   (*task_params.values(), goals, obs0, noise))
    out_bytes = steps * (2 + 2 + 2 + 1) * 4  # obs, actions, means, rewards
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, in_bytes + out_bytes)


def phase_k1(device):
    from promp_tpu_torch.ops.rollout_kernel import (
        pointmass_rollout, pointmass_rollout_plain, reward_tie_margin)
    args = k1_inputs(device)
    out = pointmass_rollout(*args)
    ref = pointmass_rollout_plain(*args)
    torch.cuda.synchronize()
    errs = {k: float((out[k] - ref[k]).abs().max())
            for k in ("observations", "actions")}
    errs["means"] = float((out["agent_infos"]["mean"]
                           - ref["agent_infos"]["mean"]).abs().max())
    for k, v in out.items():
        if k != "agent_infos" and not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"K1 output {k} is not finite")
    flips = (out["rewards"] == 0) != (ref["rewards"] == 0)
    agree = ~flips
    n_flips = int(flips.sum())
    rew_err = float((out["rewards"] - ref["rewards"])[agree].abs().max())
    margins = reward_tie_margin(ref["observations"], ref["actions"], args[1])
    flip_margin = float(margins[flips].max()) if n_flips else 0.0
    nonzero = {k: int((r["rewards"] != 0).sum())
               for k, r in (("kernel", out), ("plain", ref))}
    reward_sum = {k: float(r["rewards"].double().sum())
                  for k, r in (("kernel", out), ("plain", ref))}
    result = dict(
        phase="k1_vs_plain", shape=[N_TASKS, N_ENVS, HORIZON, *HIDDEN],
        max_abs_err=dict(errs, rewards_branch_agrees=rew_err),
        reward_branch_flips=n_flips, max_tie_margin_of_flips=flip_margin,
        nonzero_rewards=nonzero, reward_sum=reward_sum,
        tolerances=dict(trajectory=TOL_TRAJ, reward=TOL_REWARD, tie=TOL_TIE,
                        max_flips=MAX_FLIPS))
    result["ms"] = median_ms(lambda: pointmass_rollout(*args))
    result["plain_ms"] = median_ms(lambda: pointmass_rollout_plain(*args))
    bound_ms, bound_by, flops, nbytes = k1_bound(*args)
    result.update(bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                  bytes=nbytes)
    emit(result)
    if max(errs.values()) > TOL_TRAJ or rew_err > TOL_REWARD:
        raise RuntimeError(f"K1 disagrees with its plain version: {result}")
    if flip_margin >= TOL_TIE:
        raise RuntimeError(f"K1 flips a reward branch away from a tie: "
                           f"margin {flip_margin}")
    if n_flips > MAX_FLIPS:
        raise RuntimeError(f"K1 flips {n_flips} reward branches, more than "
                           f"{MAX_FLIPS}")
    steps = out["rewards"].numel()
    if not 0 < nonzero["plain"] < steps:
        raise RuntimeError(f"one reward branch is never taken: {nonzero}")
    if abs(nonzero["kernel"] - nonzero["plain"]) > n_flips:
        raise RuntimeError(f"K1 pays {nonzero['kernel']} rewards, the plain "
                           f"version {nonzero['plain']}")
    sum_tol = TOL_REWARD * steps + MAX_STEP_PROGRESS * n_flips
    if abs(reward_sum["kernel"] - reward_sum["plain"]) > sum_tol:
        raise RuntimeError(f"K1's summed reward {reward_sum['kernel']} is off "
                           f"the plain version's {reward_sum['plain']} by "
                           f"more than {sum_tol}")
    return result


def phase_trainer(device):
    from promp_tpu_torch.algos.promp import ProMP
    from promp_tpu_torch.envs import MetaPointEnvCorner, normalize
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.processor import SampleProcessor
    from promp_tpu_torch.trainer import Trainer
    from promp_tpu_torch.utils import logger

    env = normalize(MetaPointEnvCorner())
    policy = GaussianMLPPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                               hidden_sizes=HIDDEN)
    algo = ProMP(policy=policy, inner_lr=0.1, num_inner_grad_steps=1,
                 learning_rate=1e-3, num_ppo_steps=5, clip_eps=0.3,
                 init_inner_kl_penalty=5e-4, adaptive_inner_kl_penalty=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as log_dir:
        logger.configure(dir=log_dir, format_strs=["csv"])
        trainer = Trainer(
            algo=algo, env=env, policy=policy,
            sample_processor=SampleProcessor(discount=0.99, gae_lambda=1.0,
                                             normalize_adv=True),
            meta_batch_size=N_TASKS, rollouts_per_meta_task=N_ENVS,
            max_path_length=HORIZON, n_itr=N_ITR, seed=1,
            rollout_backend="kernel", device=device)
        pointmass_rollout.launches = 0
        t0 = time.time()
        state = trainer.train()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = pointmass_rollout.launches
        logger.Logger.CURRENT.close()
        with open(os.path.join(log_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
    keys = ("ItrTime", "Time-Sampling", "Time-SampleProc", "Time-InnerStep",
            "Time-OuterStep", "PolicyExecTime", "EnvExecTime", "LossBefore",
            "LossAfter", "KLInner", "KLOuter", "SkippedUpdates",
            "Step_0-AverageReturn", "Step_1-AverageReturn")
    iterations = [{k: float(r[k]) for k in keys} for r in rows]
    emit(dict(phase="trainer", iterations=iterations, seconds=seconds,
              k1_launches=launches))
    if launches != 2 * N_ITR:
        raise RuntimeError(f"K1 launched {launches} times in {N_ITR} "
                           f"iterations, expected {2 * N_ITR}")
    if len(iterations) != N_ITR:
        raise RuntimeError(f"{len(iterations)} iterations logged")
    for it in iterations:
        for k in ("LossBefore", "LossAfter", "KLInner", "KLOuter",
                  "Step_0-AverageReturn", "Step_1-AverageReturn"):
            if not torch.isfinite(torch.tensor(it[k])):
                raise RuntimeError(f"{k} is not finite: {iterations}")
        if it["SkippedUpdates"] != 0:
            raise RuntimeError(f"Adam skipped updates: {iterations}")
    for k, v in state["params"].items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"parameter {k} is not finite")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from promp_tpu_torch.ops import rollout_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              nvidia_smi=smi_line, torch=torch.__version__,
              cuda=torch.version.cuda))
    device = "cuda"

    t0 = time.time()
    lib_path = rollout_kernel.build()
    emit(dict(phase="build", seconds=time.time() - t0,
              library=os.path.basename(lib_path)))

    k1 = phase_k1(device)
    launches = phase_trainer(device)

    emit({"kernels": [dict(
        name="K1_pointmass_rollout", route="cuda",
        source="promp_tpu_torch/csrc/rollout_kernel.cu",
        replaces="promp_tpu/ops/pallas_rollout.py:31",
        launches=launches,
        max_abs_err=max(k1["max_abs_err"].values()),
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None)]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
