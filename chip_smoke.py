"""Smoke run of the PyTorch/CUDA port (promp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit;
  2. build: K1 (csrc/rollout_kernel.cu) and K2 (csrc/substep_chain.cu,
     filled in for half_cheetah) compiled with nvcc, one process each,
     started together; each one's time, and K2's ptxas report;
  3. k1_vs_plain: K1 against its plain PyTorch version at the main path's
     shape (40 tasks x 20 envs x 100 steps, a (64, 64) policy) on the same
     inputs: errors, reward-branch flips and their tie margins, paid
     rewards and their sums, timings;
  4. trainer: slice 1's main path, 3 ProMP meta-iterations on
     normalize(MetaPointEnvCorner()) at the reference settings with
     rollout_backend="kernel"; K1's launches (2 per iteration), finite
     losses, KLs and returns, no skipped Adam updates, per-iteration times;
  5. k2_vs_plain: K2 against its plain PyTorch version, one env step (5
     substeps) at a time from the same inputs: the states of a 100-step
     cheetah rollout at 40 x 20 with a seeded (64, 64) policy at steps 0,
     25, 50, 75 and 99, and random states; errors, active contacts, timings;
  6. trainer_cheetah: slice 2's main path, 3 ProMP meta-iterations on
     normalize(HalfCheetahRandVelEnv()) at the same settings with
     rollout_backend="scan"; K2's launches (one per env step: 2 x 100 per
     iteration), finite losses, KLs, returns and parameters, no skipped
     Adam updates, per-iteration times and forward velocities.
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
# K2 against its plain version, one env step from the same inputs: the JAX
# package's own K2 bars (tests/test_pallas_substep.py:82-85), as
# |kernel - plain| <= atol + rtol * |plain|
K2_Q_TOL, K2_QD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-3)
K2_STEPS = (0, 25, 50, 75, 99)       # rollout steps whose states are held
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


def _promp_trainer(env, device, backend, log_dir):
    """The main path's Trainer (bench.py::build_trainer's settings)."""
    from promp_tpu_torch.algos.promp import ProMP
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.processor import SampleProcessor
    from promp_tpu_torch.trainer import Trainer
    from promp_tpu_torch.utils import logger

    policy = GaussianMLPPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                               hidden_sizes=HIDDEN)
    algo = ProMP(policy=policy, inner_lr=0.1, num_inner_grad_steps=1,
                 learning_rate=1e-3, num_ppo_steps=5, clip_eps=0.3,
                 init_inner_kl_penalty=5e-4, adaptive_inner_kl_penalty=False)
    logger.configure(dir=log_dir, format_strs=["csv"])
    return Trainer(
        algo=algo, env=env, policy=policy,
        sample_processor=SampleProcessor(discount=0.99, gae_lambda=1.0,
                                         normalize_adv=True),
        meta_batch_size=N_TASKS, rollouts_per_meta_task=N_ENVS,
        max_path_length=HORIZON, n_itr=N_ITR, seed=1,
        rollout_backend=backend, device=device)


def _train(env, device, backend, counter, extra_keys=()):
    """Runs N_ITR meta-iterations with ``counter`` (a kernel wrapper) set
    to 0 just before; returns (per-iteration logged values, seconds,
    launches). Raises unless every iteration is finite and skips no Adam
    update."""
    from promp_tpu_torch.utils import logger

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as log_dir:
        trainer = _promp_trainer(env, device, backend, log_dir)
        counter.launches = 0
        t0 = time.time()
        state = trainer.train()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = counter.launches
        logger.Logger.CURRENT.close()
        with open(os.path.join(log_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
    keys = ("ItrTime", "Time-Sampling", "Time-SampleProc", "Time-InnerStep",
            "Time-OuterStep", "PolicyExecTime", "EnvExecTime", "LossBefore",
            "LossAfter", "KLInner", "KLOuter", "SkippedUpdates",
            "Step_0-AverageReturn", "Step_1-AverageReturn") + extra_keys
    iterations = [{k: float(r[k]) for k in keys} for r in rows]
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
    return iterations, seconds, launches


def phase_trainer(device):
    from promp_tpu_torch.envs import MetaPointEnvCorner, normalize
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout

    iterations, seconds, launches = _train(
        normalize(MetaPointEnvCorner()), device, "kernel", pointmass_rollout)
    emit(dict(phase="trainer", iterations=iterations, seconds=seconds,
              k1_launches=launches))
    if launches != 2 * N_ITR:
        raise RuntimeError(f"K1 launched {launches} times in {N_ITR} "
                           f"iterations, expected {2 * N_ITR}")
    return launches


class _Recorder:
    """Wraps an env for ``rollout`` and keeps the (state, action) given to
    its ``step`` at the steps in ``steps``."""

    def __init__(self, env, steps):
        self.env, self.steps, self.t, self.kept = env, set(steps), 0, {}

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action, task):
        if self.t in self.steps:
            self.kept[self.t] = (state, action)
        self.t += 1
        return self.env.step(state, action, task)


def k2_inputs(env, device, seed=0):
    """(label, q, qd, tau) sets of (N_TASKS * N_ENVS, nv) inputs of one env
    step: the states and actuation of a cheetah rollout with a seeded
    (64, 64) policy at the steps K2_STEPS, and random states drawn as the
    JAX package's K2 tests draw them."""
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.rollout import rollout

    engine = env.env.engine
    nv = engine.model.nv
    gen = torch.Generator(device=device).manual_seed(seed)
    policy = GaussianMLPPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                               hidden_sizes=HIDDEN)
    params = policy.replicate(policy.init(gen, device), N_TASKS)
    tasks = env.sample_tasks(gen, N_TASKS, device)
    recorder = _Recorder(env, K2_STEPS)
    rollout(recorder, policy, params, tasks, gen, N_ENVS, HORIZON)
    sets = []
    for t in K2_STEPS:
        state, action = recorder.kept[t]
        tau = engine.actuation(env.scale_action(action))
        sets.append((f"rollout_step_{t}",) + tuple(
            x.reshape(-1, nv).contiguous()
            for x in (state["q"], state["qd"], tau)))
    n = N_TASKS * N_ENVS
    q = 0.3 * torch.randn((n, nv), generator=gen, device=device)
    q[:, 2] += 0.6
    qd = torch.randn((n, nv), generator=gen, device=device)
    tau = 0.5 * torch.randn((n, nv), generator=gen, device=device)
    sets.append(("random", q, qd, tau))
    return sets


def _excess(got, want, tol):
    """Largest |got - want| / (atol + rtol * |want|): at most 1 passes."""
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def phase_k2(device):
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import (
        SubstepSource, substep_chain, substep_chain_plain)

    env = normalize(make_env("HalfCheetahRandVelEnv"))
    engine = env.env.engine
    n_steps = env.env.frame_skip * engine.n_substeps
    kernel = substep_chain(engine, n_steps)
    plain = substep_chain_plain(engine, n_steps)
    sets = k2_inputs(env, device)
    checks, errs = [], {"q": 0.0, "qd": 0.0}
    for label, q, qd, tau in sets:
        qk, qdk = kernel(q, qd, tau)
        probe = []
        qp, qdp = plain(q, qd, tau, probe)
        torch.cuda.synchronize()
        n_contacts = len(engine.model.con_body)
        active = int(sum(p.sum() for p in probe[:n_contacts]))
        finite = all(bool(torch.isfinite(x).all()) for x in (qk, qdk))
        check = dict(
            inputs=label, envs=q.shape[0], active_contacts=active,
            max_abs_err_q=float((qk - qp).abs().max()),
            max_abs_err_qd=float((qdk - qdp).abs().max()),
            excess_q=_excess(qk, qp, K2_Q_TOL),
            excess_qd=_excess(qdk, qdp, K2_QD_TOL), finite=finite)
        checks.append(check)
        errs["q"] = max(errs["q"], check["max_abs_err_q"])
        errs["qd"] = max(errs["qd"], check["max_abs_err_qd"])
    q, qd, tau = sets[0][1:]
    result = dict(phase="k2_vs_plain", model="half_cheetah", n_steps=n_steps,
                  checks=checks, tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL))
    result["ms"] = median_ms(lambda: kernel(q, qd, tau))
    result["plain_ms"] = median_ms(lambda: plain(q, qd, tau))
    source = SubstepSource(engine)
    flops = float(source.n_ops * n_steps * q.shape[0])
    nbytes = 5 * q.numel() * 4   # q, qd, tau read; q, qd written
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    result.update(bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  flops=flops, bytes=nbytes, ops_per_substep=source.n_ops,
                  max_abs_err=errs)
    emit(result)
    for check in checks:
        if not check["finite"]:
            raise RuntimeError(f"K2 output is not finite: {check}")
        if check["excess_q"] > 1 or check["excess_qd"] > 1:
            raise RuntimeError(f"K2 disagrees with its plain version: "
                               f"{check}")
    if not any(c["active_contacts"] for c in checks):
        raise RuntimeError("no contact was active in any K2 check")
    return result


def phase_trainer_cheetah(device):
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    iterations, seconds, launches = _train(
        normalize(make_env("HalfCheetahRandVelEnv")), device, "scan",
        substep_chain, extra_keys=tuple(
            f"Step_{k}-{key}" for k in (0, 1) for key in
            ("AvgForwardVel", "AvgFinalForwardVel", "AvgCtrlCost")))
    emit(dict(phase="trainer_cheetah", iterations=iterations,
              seconds=seconds, k2_launches=launches))
    if launches != 2 * HORIZON * N_ITR:
        raise RuntimeError(f"K2 launched {launches} times in {N_ITR} "
                           f"iterations, expected {2 * HORIZON * N_ITR}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from promp_tpu_torch.ops import nvcc_build, rollout_kernel, substep_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              nvidia_smi=smi_line, torch=torch.__version__,
              cuda=torch.version.cuda))
    device = "cuda"

    from promp_tpu_torch.envs.mujoco.engine import Engine
    from promp_tpu_torch.envs.mujoco.model import get_model
    t0 = time.time()
    builds = nvcc_build.build_all([
        rollout_kernel.build_job(),
        substep_kernel.build_job(Engine(get_model("half_cheetah")))])
    emit(dict(phase="build", seconds=time.time() - t0, libraries=[
        dict(library=os.path.basename(b.path), seconds=b.seconds)
        for b in builds], k2_ptxas=[
            line.strip() for line in builds[1].log.splitlines()
            if "registers" in line or "spill" in line]))

    k1 = phase_k1(device)
    k1_launches = phase_trainer(device)
    k2 = phase_k2(device)
    k2_launches = phase_trainer_cheetah(device)

    emit({"kernels": [
        dict(name="K1_pointmass_rollout", route="cuda",
             source="promp_tpu_torch/csrc/rollout_kernel.cu",
             replaces="promp_tpu/ops/pallas_rollout.py:31",
             launches=k1_launches,
             max_abs_err=max(k1["max_abs_err"].values()),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="K2_substep_chain", route="cuda",
             source="promp_tpu_torch/csrc/substep_chain.cu",
             replaces="promp_tpu/ops/pallas_substep.py:143",
             launches=k2_launches,
             max_abs_err=max(k2["max_abs_err"].values()),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None)]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
