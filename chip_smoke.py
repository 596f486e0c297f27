"""Smoke run of the PyTorch/CUDA port (promp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit;
  2. build: K1 (csrc/rollout_kernel.cu, for the (64, 64) policy and for
     (32, 48) and (128, 128)), K2 (csrc/substep_chain.cu, filled in for
     half_cheetah, walker2d, hopper, ant and humanoid) and K3 (the same
     template with the rand-params mods, for the first three bodies)
     compiled with nvcc, one process each, all started together; each
     one's time and ptxas report (registers, spills), the block's shared
     memory and, where the toolkit has cuobjdump, the kernel's SASS
     instruction count; for K1 its launch geometry, for K2 and K3 the
     warp-split schedule's figures (warps, stages a substep, the busiest
     part's ops, shared slots);
  3. k1_vs_plain: K1 against its plain PyTorch version at the main path's
     shape (40 tasks x 20 envs x 100 steps, a (64, 64) policy) on the same
     inputs: errors, reward-branch flips and their tie margins, paid
     rewards and their sums, a sha256 of the kernel's outputs, timings
     (one wrapper call, and the kernel alone: launches through its C entry
     back to back), the bound and the design's floor; then the same bars
     at the edge shapes K1_EDGES (ragged env groups, 1025 envs, one task,
     7 steps, (32, 48) widths with W2 in registers, (128, 128) with W2 in
     shared memory past 48 KB a block), launched into outputs one row
     longer and filled with a sentinel that empty env slots must not touch;
  4. trainer: slice 1's main path, 3 ProMP meta-iterations on
     normalize(MetaPointEnvCorner()) at the reference settings with
     rollout_backend="kernel"; K1's launches (2 per iteration), finite
     losses, KLs and returns, no skipped Adam updates, per-iteration times;
  5. k2_vs_plain: K2 against its plain PyTorch version, one env step (5
     substeps) at a time from the same inputs: the states of a 100-step
     cheetah rollout at 40 x 20 with a seeded (64, 64) policy at steps 0,
     25, 50, 75 and 99, and random states; then on ragged batches (801 and
     19 random states, outputs one row longer and filled with a sentinel
     that the padded lanes must not touch); errors, active contacts,
     timings;
  6. trainer_cheetah: slice 2's main path, 3 ProMP meta-iterations on
     normalize(HalfCheetahRandVelEnv()) at the same settings with
     rollout_backend="scan"; K2's launches (one per env step: 2 x 100 per
     iteration), finite losses, KLs, returns and parameters, no skipped
     Adam updates, per-iteration times and forward velocities;
  7. k3_vs_plain: K3 (csrc/substep_chain.cu with the mods) against its plain
     PyTorch version, one env step at a time from the same inputs, on
     walker2d (the states, actions and per-task multipliers of a 100-step
     Walker2DRandParamsEnv rollout at 40 x 20, which auto-resets, at steps
     0, 25, 50, 75 and 99, and random states with per-env multipliers),
     hopper and half_cheetah (random states, per-env multipliers), and on
     the ragged batches as K2; errors, active contacts, timings, bounds;
  8. k2_walker_hopper: K2 on walker2d and hopper, one random-state check
     each;
  9. trainer_walker_randparams: slice 3's main path, 3 ProMP
     meta-iterations on normalize(Walker2DRandParamsEnv()) at the same
     settings; K3's launches (2 x 100 per iteration) and none of K2's, the
     episodes that ended inside the window (the auto-reset branch ran on
     the card), finite losses, KLs, returns and parameters, no skipped Adam
     updates, per-iteration times;
 10. k2_ant_humanoid: K2 against its plain version on ant and humanoid
     (10 substeps an env step), as k2_vs_plain: the states of a 100-step
     rollout of normalize(AntRandGoalEnv()) and of
     normalize(HumanoidRandDirecEnv()) at 40 x 20 with a seeded (64, 64)
     policy at steps 0, 25, 50, 75 and 99, random states, and the ragged
     batches; errors, active contacts, timings, bounds, the grid's blocks
     against the card's SMs;
 11. trainer_ant and trainer_humanoid: slice 6's main path, 3 ProMP
     meta-iterations each on normalize(AntRandGoalEnv()) and
     normalize(HumanoidRandDirecEnv()) at the same settings; K2's launches
     (2 x 100 per iteration) and none of K3's, the humanoid's episodes
     that ended inside the window, finite losses, KLs, returns and
     parameters, no skipped Adam updates, per-iteration times;
 12. step_ops: the aten operations one env step of the scan engine
     dispatches on the cheetah, the ant, the humanoid and the walker (with
     and without the walker's auto-reset branch), and one pack of the
     walker's multipliers;
 13. the other algorithms, 3 meta-iterations each at the same shape:
     trainer_vpg_pointmass (VPG-MAML) and trainer_dice_pointmass
     (DICE-MAML with the DICE processor) on the point mass with K1 (6
     launches each; the DICE mask all ones, since K1 never ends an
     episode); trainer_trpo_cheetah and trainer_emaml_cheetah (TRPO-MAML
     at run_scripts/maml_run_mujoco.py's and e-maml_run_mujoco.py's
     settings) on normalize(HalfCheetahRandDirecEnv()) with K2 (600 each;
     every step taken inside the trust region and better, BacktrackIters
     in [0, 14]); trainer_vpg_dice_walker (VPG-DICE-MAML, the return
     baseline, inner_lr 1e-3) on the walker with K3 (600; the DICE mask's
     mean below 1); finite losses, KLs, returns and parameters, no
     skipped Adam update;
 14. trainer_modes: ProMP on the main path's cheetah, a phase-split and a
     fused Trainer from one seed (2 iterations each, parameters within
     1e-6), timing_every=2 over 3 iterations (iteration 1 logs iteration
     0's Time-* values), and a torch.profiler trace of one iteration (its
     10 device kernels with the most time and its kernel launches).
 15. run_scripts: the DEFAULT_CONFIGs of promp_tpu_torch/run_scripts/
     pro-mp_run_mujoco.py, maml_run_mujoco.py and e-maml_run_mujoco.py
     (loaded by path) through run.run_experiment at n_itr 2 with
     snapshot_mode "all": params.json, a progress.csv of 2 rows with
     finite losses, itr_0.pkl and itr_1.pkl, K2 200 an iteration and K3
     0; then pro-mp_run_point_mass.py as a subprocess on the card from a
     --config_file (n_itr 2): exit code 0 and the same files;
 16. config3: BASELINE.json config 3 with two inner steps, three sampling
     rounds an iteration: ProMP at pro-mp_run_mujoco's config on
     Walker2DRandParamsEnv for 2 iterations (K3 300 an iteration, K2 0)
     and E-MAML at e-maml_run_mujoco's config on AntRandGoalEnv for 1
     (K2 300); the Step_0..2 returns, KLs and TRPO's MeanKL, every TRPO
     step taken inside the trust region or its rejection printed;
 17. resume: ProMP on HalfCheetahRandVelEnv, 3 iterations uninterrupted
     against 2 through run_experiment, then a fresh build resumed by
     checkpoints.resume_trainer and trained to 3: parameters, step sizes,
     Adam state and the card's generator state equal to the bit (K2
     1,200);
 18. point_variants: one ProMP iteration through run_experiment on each of
     the five point variants at the point-mass script's width;
 19. sweep: run_sweep's serial mode over two seeds of the point mass
     (n_itr 1, the two runs' parameters differ), and the docker and slurm
     launch files, generated and not run;
 20. native: every snapshot of phases 15-19 went through the g++-built
     AsyncCheckpointWriter with 0 errors; one AsyncFileSink round trip.
 21. float64_compat: ProMP in float64 through the seed-exact sampler
     (sampling/compat_sampler.py), 2 meta-iterations at 40 x 20 x 100 on
     the card (finite, no skipped update, K1 launched 0 times), and at
     COMPAT_CHECK on the card against the same run on the CPU: parameters
     within 1e-6;
 22. generic_vs_k2: one env step of the generic engine (Engine.generic_chain,
     plain PyTorch) against K2 on the cheetah and the ant, k2_inputs'
     rollout and random states at 800 envs, at the K2 bars; both times and
     the generic step's aten operations;
 23. trainer_swimmer: 2 ProMP meta-iterations on
     normalize(SwimmerRandVelEnv()) at the main path's width: 800 generic
     substeps an iteration, K2 and K3 0; the aten operations of one env
     step;
 24. trainer_sawyer: one ProMP meta-iteration on each of the four Sawyer
     envs, 800 generic substeps each, K2 and K3 0; pick-and-place's
     grasped steps (printed, not a gate);
 25. render_rollout: sampling/render.py's rollout of one 100-step episode
     on the swimmer and the point mass: shapes and finite values.
Phases 15-21, 23 and 24 print their wall time (``seconds``).
Then the {"kernels": [...]} line (each kernel's launches on the slice's
main path, and by path in ``launches_by_path``), the card's name and power limit as
nvidia-smi prints them, and the final {"ok": true, ...} line. Any failure
raises, and the script exits non-zero without the final line. It needs a
CUDA device and imports neither JAX nor the JAX package.
"""
import csv
import ctypes
import hashlib
import json
import os
import pickle
import re
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
# K1's edge shapes (tasks, envs, steps, widths): env counts that leave the
# last group of envs ragged, past the one-thread design's 1024 cap, one
# task, a short horizon, and two more width pairs (a library each)
K1_EDGES = ((N_TASKS, 19, HORIZON, HIDDEN), (N_TASKS, 33, HORIZON, HIDDEN),
            (4, 1025, HORIZON, HIDDEN), (1, N_ENVS, HORIZON, HIDDEN),
            (N_TASKS, N_ENVS, 7, HIDDEN), (N_TASKS, N_ENVS, HORIZON, (32, 48)),
            (N_TASKS, N_ENVS, HORIZON, (128, 128)))
# K1's width pairs and whether each keeps W2 in registers: (128, 128) takes
# the shared-memory branch, at more than 48 KB of shared memory a block
K1_WIDTHS = {HIDDEN: True, (32, 48): True, (128, 128): False}
K1_BATCH = 20          # launches between two events for K1's own time
# K2 against its plain version, one env step from the same inputs: the JAX
# package's own K2 bars (tests/test_pallas_substep.py:82-85), as
# |kernel - plain| <= atol + rtol * |plain|
K2_Q_TOL, K2_QD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-3)
K2_STEPS = (0, 25, 50, 75, 99)       # rollout steps whose states are held
# K3 holds to the same bars; the rand-params multipliers in the JAX order
K3_KEYS = ("body_inertia", "body_mass", "dof_damping", "friction")
K3_BODIES = ("walker2d", "hopper", "half_cheetah")
# slice 6's envs (bench.py's "ant" and "humanoid" workloads), K2 only
K2_ENVS_3D = {"ant": "AntRandGoalEnv", "humanoid": "HumanoidRandDirecEnv"}
PLAIN_RUNS_ADDED = 3   # timed runs of the plain chains of slice 3's bodies
# batches that leave a block's lanes partly empty: 25 full blocks and one
# env, and one block of 19
RAGGED_BATCHES = (801, 19)
SENTINEL = 12345.0
# published H100 SXM peaks at 700 W: FP32 without tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
TIMED_RUNS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_lines(log):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def sass_count(path):
    """The SASS instructions in the library at ``path`` as cuobjdump lists
    them, or None where the toolkit has no cuobjdump."""
    from promp_tpu_torch.ops import nvcc_build

    tool = os.path.join(os.path.dirname(nvcc_build.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if out.returncode != 0:
        return None
    return sum(1 for line in out.stdout.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line))


def block_shared_bytes(path, symbol="substep_chain_shared_bytes"):
    """The dynamic shared memory a block of the library at ``path`` takes,
    as its source lays it out (``symbol`` returns it)."""
    from promp_tpu_torch.ops import nvcc_build

    fn = getattr(nvcc_build.load(path), symbol)
    fn.restype = ctypes.c_int
    return fn()


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


def k1_inputs(device, seed=0, n_tasks=N_TASKS, n_envs=N_ENVS,
              horizon=HORIZON, hidden=HIDDEN):
    """Random policy parameters per task (from a seed), by default at the
    main-path shape, with per-task output biases that drive the point out
    of the L1 radius so that both reward branches are taken."""
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    gen = torch.Generator(device=device).manual_seed(seed)
    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=hidden)
    params = policy.init(gen, device)
    task_params = {k: v.expand((n_tasks,) + v.shape).contiguous()
                   for k, v in params.items()}
    task_params["mean_network/output/bias"] = (
        torch.rand((n_tasks, 2), generator=gen, device=device) * 16.0 - 8.0)
    task_params["log_std_network/log_std_var"] = (
        torch.rand((n_tasks, 1, 2), generator=gen, device=device) - 0.5)
    corners = torch.tensor([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0],
                            [2.0, 2.0]], device=device)
    goals = corners[torch.randint(0, 4, (n_tasks,), generator=gen,
                                  device=device)]
    obs0 = torch.rand((n_tasks, n_envs, 2), generator=gen,
                      device=device) * 0.4 - 0.2
    noise = torch.randn((n_tasks, horizon, n_envs, 2), generator=gen,
                        device=device)
    return task_params, goals, obs0, noise


def batched_ms(fn, n=K1_BATCH, runs=TIMED_RUNS // 4):
    """Median over ``runs`` of the time of ``n`` back-to-back calls of
    ``fn`` between two events, over ``n``: where a call's host time is
    shorter than its launch's, the launches queue behind each other and
    this is the card's time a launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def k1_bound(task_params, goals, obs0, noise):
    """Least time for K1's work on this card: every input read once and
    every output written once, against the FP32 multiply-adds of the MLP;
    and the design's floor: the same FP32 rate shared evenly by the SMs,
    the busiest SM running ceil(blocks / SMs) blocks of its launch
    geometry."""
    from promp_tpu_torch.ops.rollout_kernel import launch_geometry
    h0 = task_params["mean_network/hidden_0/kernel"].shape[-1]
    h1 = task_params["mean_network/hidden_1/kernel"].shape[-1]
    n_tasks, horizon, n_envs = noise.shape[:3]
    flops_env_step = 2.0 * (2 * h0 + h0 * h1 + h1 * 2)
    steps = n_tasks * horizon * n_envs
    flops = flops_env_step * steps
    in_bytes = sum(t.numel() * 4 for t in
                   (*task_params.values(), goals, obs0, noise))
    out_bytes = steps * (2 + 2 + 2 + 1) * 4  # obs, actions, means, rewards
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    geo = launch_geometry(n_tasks, n_envs, h0, h1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = geo.grid[0] * geo.grid[1]
    block_flops = flops_env_step * horizon * min(geo.envs_per_block, n_envs)
    floor_ms = -(-blocks // sms) * block_flops / (PEAK_FP32_FLOPS / sms) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=in_bytes + out_bytes,
                design_floor_ms=max(floor_ms, t_bytes), blocks=blocks,
                sms=sms)


def _k1_compare(out, ref, goals, both_branches):
    """K1's outputs ``out`` against the plain version's ``ref`` at the bars:
    returns the figures, and the reason they fail the bars or None."""
    from promp_tpu_torch.ops.rollout_kernel import reward_tie_margin
    errs = {k: float((out[k] - ref[k]).abs().max())
            for k in ("observations", "actions")}
    errs["means"] = float((out["agent_infos"]["mean"]
                           - ref["agent_infos"]["mean"]).abs().max())
    finite = all(bool(torch.isfinite(v).all())
                 for k, v in out.items() if k != "agent_infos")
    flips = (out["rewards"] == 0) != (ref["rewards"] == 0)
    n_flips = int(flips.sum())
    rew_err = float((out["rewards"] - ref["rewards"])[~flips].abs().max())
    margins = reward_tie_margin(ref["observations"], ref["actions"], goals)
    flip_margin = float(margins[flips].max()) if n_flips else 0.0
    nonzero = {k: int((r["rewards"] != 0).sum())
               for k, r in (("kernel", out), ("plain", ref))}
    reward_sum = {k: float(r["rewards"].double().sum())
                  for k, r in (("kernel", out), ("plain", ref))}
    figures = dict(max_abs_err=dict(errs, rewards_branch_agrees=rew_err),
                   reward_branch_flips=n_flips,
                   max_tie_margin_of_flips=flip_margin,
                   nonzero_rewards=nonzero, reward_sum=reward_sum)
    steps = out["rewards"].numel()
    sum_tol = TOL_REWARD * steps + MAX_STEP_PROGRESS * n_flips
    if not finite:
        return figures, "an output is not finite"
    if max(errs.values()) > TOL_TRAJ or rew_err > TOL_REWARD:
        return figures, "it disagrees with its plain version"
    if flip_margin >= TOL_TIE:
        return figures, "it flips a reward branch away from a tie"
    if n_flips > MAX_FLIPS:
        return figures, f"it flips more than {MAX_FLIPS} reward branches"
    if both_branches and not 0 < nonzero["plain"] < steps:
        return figures, "one reward branch is never taken"
    if abs(nonzero["kernel"] - nonzero["plain"]) > n_flips:
        return figures, "it pays another number of rewards"
    if abs(reward_sum["kernel"] - reward_sum["plain"]) > sum_tol:
        return figures, f"its summed reward is off by more than {sum_tol}"
    return figures, None


def _k1_edge(device, n_tasks, n_envs, horizon, hidden):
    """K1 at one edge shape, launched directly into outputs one row longer
    than the rollout's and filled with SENTINEL, against its plain version
    at the bars (the launch is a check and is not counted)."""
    from promp_tpu_torch.ops import rollout_kernel as rk
    # drawn on the CPU, where seed 1 takes both reward branches at every
    # edge shape, then moved to the card
    tp, *rest = k1_inputs("cpu", seed=1, n_tasks=n_tasks, n_envs=n_envs,
                          horizon=horizon, hidden=hidden)
    args = ({k: v.to(device) for k, v in tp.items()},
            *(t.to(device) for t in rest))
    n = n_tasks * n_envs * horizon
    widths = (2, 2, 1, 2)   # obs, actions, rewards, means
    outs = [torch.full((w * (n + 1),), SENTINEL, device=device)
            for w in widths]
    call, log_std = rk.bind_launch(*args, outs)
    call()
    torch.cuda.synchronize()
    if not all(bool((o[w * n:] == SENTINEL).all())
               for o, w in zip(outs, widths)):
        raise RuntimeError(f"K1 wrote past a rollout of {n_tasks} x "
                           f"{n_envs} x {horizon}")
    shape = (n_tasks, n_envs, horizon)
    obs, act, rew, mean = (o[:w * n].view(shape + ((w,) if w > 1 else ()))
                           for o, w in zip(outs, widths))
    out = dict(observations=obs, actions=act, rewards=rew,
               agent_infos=dict(mean=mean, log_std=log_std))
    ref = rk.pointmass_rollout_plain(*args)
    figures, fault = _k1_compare(out, ref, args[1], both_branches=True)
    check = dict(shape=[n_tasks, n_envs, horizon, *hidden],
                 groups=rk.launch_geometry(n_tasks, n_envs, *hidden).grid[1],
                 **figures)
    if fault:
        raise RuntimeError(f"K1 at an edge shape: {fault}: {check}")
    return check


def _sha256(out):
    digest = hashlib.sha256()
    for t in (out["observations"], out["actions"], out["rewards"],
              out["agent_infos"]["mean"]):
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


def phase_k1(device):
    from promp_tpu_torch.ops.rollout_kernel import (
        bind_launch, pointmass_rollout, pointmass_rollout_plain)
    args = k1_inputs(device)
    out = pointmass_rollout(*args)
    ref = pointmass_rollout_plain(*args)
    torch.cuda.synchronize()
    figures, fault = _k1_compare(out, ref, args[1], both_branches=True)
    result = dict(
        phase="k1_vs_plain", shape=[N_TASKS, N_ENVS, HORIZON, *HIDDEN],
        **figures, outputs_sha256=_sha256(out),
        tolerances=dict(trajectory=TOL_TRAJ, reward=TOL_REWARD, tie=TOL_TIE,
                        max_flips=MAX_FLIPS))
    result["ms"] = median_ms(lambda: pointmass_rollout(*args))
    result["kernel_ms"] = batched_ms(bind_launch(*args, [
        torch.empty_like(t) for t in (out["observations"], out["actions"],
                                      out["rewards"],
                                      out["agent_infos"]["mean"])])[0])
    result["plain_ms"] = median_ms(lambda: pointmass_rollout_plain(*args))
    result.update(k1_bound(*args))
    emit(result)
    if fault:
        raise RuntimeError(f"K1: {fault}: {result}")
    emit(dict(phase="k1_edges", checks=[_k1_edge(device, *shape)
                                        for shape in K1_EDGES]))
    return result


def _promp(policy):
    """The main path's ProMP (bench.py::build_trainer's settings)."""
    from promp_tpu_torch.algos.promp import ProMP
    return ProMP(policy=policy, inner_lr=0.1, num_inner_grad_steps=1,
                 learning_rate=1e-3, num_ppo_steps=5, clip_eps=0.3,
                 init_inner_kl_penalty=5e-4, adaptive_inner_kl_penalty=False)


def _processor():
    from promp_tpu_torch.sampling.processor import SampleProcessor
    return SampleProcessor(discount=0.99, gae_lambda=1.0, normalize_adv=True)


def _trainer(env, device, backend, make_algo=_promp, processor=None, **kw):
    """A Trainer at the main path's shape, seed 1, a (64, 64) policy;
    ``make_algo(policy)`` gives the algorithm (the main path's ProMP),
    ``processor`` the sample processor (the main path's), ``kw`` more of
    the Trainer's arguments."""
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.trainer import Trainer

    policy = GaussianMLPPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                               hidden_sizes=HIDDEN)
    return Trainer(
        algo=make_algo(policy), env=env, policy=policy,
        sample_processor=processor or _processor(),
        **dict(dict(meta_batch_size=N_TASKS, rollouts_per_meta_task=N_ENVS,
                    max_path_length=HORIZON, n_itr=N_ITR, seed=1,
                    rollout_backend=backend, device=device), **kw))


PROMP_KEYS = ("LossBefore", "LossAfter", "KLInner", "KLOuter",
              "SkippedUpdates")
TRPO_KEYS = ("LossBefore", "LossAfter", "MeanKLBefore", "MeanKL", "dLoss",
             "KLInner", "BacktrackIters", "StepRejected")
TIME_KEYS = ("ItrTime", "Time-Sampling", "Time-SampleProc", "Time-InnerStep",
             "Time-OuterStep", "PolicyExecTime", "EnvExecTime")
RETURN_KEYS = ("Step_0-AverageReturn", "Step_1-AverageReturn")


def _train(env, device, backend, counters, extra_keys=(), loss_keys=PROMP_KEYS,
           time_keys=TIME_KEYS, n_itr=N_ITR, on_trainer=None, **trainer_kw):
    """Runs ``n_itr`` meta-iterations of ``_trainer(env, device, backend,
    **trainer_kw)`` with every launch count in ``counters`` ({name: (kernel
    wrapper, attribute)}) set to 0 just before; ``on_trainer(trainer)``,
    if given, may wrap the trainer's phases first. Returns a dict: the
    per-iteration logged values (``time_keys``, ``loss_keys``, the returns
    and ``extra_keys``), seconds, {name: launches}, the number of episodes
    that ended inside a round, the DICE mask's mean of each round where the
    samples carry one, the trainer and its final train_state. Raises unless
    every loss, KL, return and parameter is finite and no Adam update was
    skipped."""
    from promp_tpu_torch.utils import logger

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as log_dir:
        logger.configure(dir=log_dir, format_strs=["csv"])
        trainer = _trainer(env, device, backend, n_itr=n_itr, **trainer_kw)
        dones, masks = [], []
        sample, process = trainer._rollout, trainer._process

        def counted(*args):
            out = sample(*args)
            dones.append(out["dones"].sum())   # read after the run
            return out

        def processed(traj):
            out = process(traj)
            if "mask" in out:
                masks.append(out["mask"].mean())
            return out

        trainer._rollout, trainer._process = counted, processed
        if on_trainer is not None:
            on_trainer(trainer)
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        t0 = time.time()
        state = trainer.train()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {name: getattr(obj, attr)
                    for name, (obj, attr) in counters.items()}
        n_dones = int(sum(int(d) for d in dones))
        logger.Logger.CURRENT.close()
        with open(os.path.join(log_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
    keys = time_keys + loss_keys + RETURN_KEYS + extra_keys
    iterations = [{k: float(r[k]) for k in keys} for r in rows]
    if len(iterations) != n_itr:
        raise RuntimeError(f"{len(iterations)} iterations logged")
    for it in iterations:
        for k in loss_keys + RETURN_KEYS:
            if not torch.isfinite(torch.tensor(it[k])):
                raise RuntimeError(f"{k} is not finite: {iterations}")
        if it.get("SkippedUpdates", 0) != 0:
            raise RuntimeError(f"Adam skipped updates: {iterations}")
    for k, v in state["params"].items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"parameter {k} is not finite")
    return dict(iterations=iterations, seconds=seconds, launches=launches,
                dones=n_dones, mask_means=[float(m) for m in masks],
                trainer=trainer, state=state)


def phase_trainer(device):
    from promp_tpu_torch.envs import MetaPointEnvCorner, normalize
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout

    run = _train(normalize(MetaPointEnvCorner()), device, "kernel",
                 {"k1": (pointmass_rollout, "launches")})
    launches = run["launches"]["k1"]
    emit(dict(phase="trainer", iterations=run["iterations"],
              seconds=run["seconds"], k1_launches=launches))
    if launches != 2 * N_ITR:
        raise RuntimeError(f"K1 launched {launches} times in {N_ITR} "
                           f"iterations, expected {2 * N_ITR}")
    return launches


class _Recorder:
    """Wraps an env for ``rollout`` and keeps the (state, action, task)
    given to its ``step`` at the steps in ``steps``, and the dones."""

    def __init__(self, env, steps):
        self.env, self.steps, self.t, self.kept = env, set(steps), 0, {}
        self.dones = 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action, task):
        if self.t in self.steps:
            self.kept[self.t] = (state, action, task)
        self.t += 1
        out = self.env.step(state, action, task)
        self.dones = self.dones + out[3].sum()
        return out


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
        state, action, _ = recorder.kept[t]
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


def _hold(kind, engine, kernel, plain, sets):
    """Holds ``kernel`` against ``plain`` on each (label, *inputs) set, one
    call each from the same inputs, at the K2 bars; returns (checks, max
    abs errors). Raises on a non-finite output, an error over the bars,
    or no active contact in any set."""
    n_contacts = len(engine.model.con_body)
    checks, errs = [], {"q": 0.0, "qd": 0.0}
    for label, *ins in sets:
        qk, qdk = kernel(*ins)
        probe = []
        qp, qdp = plain(*ins, probe)
        torch.cuda.synchronize()
        active = int(sum(p.sum() for p in probe[:n_contacts]))
        finite = all(bool(torch.isfinite(x).all()) for x in (qk, qdk))
        check = dict(
            inputs=label, envs=ins[0].shape[0], active_contacts=active,
            max_abs_err_q=float((qk - qp).abs().max()),
            max_abs_err_qd=float((qdk - qdp).abs().max()),
            excess_q=_excess(qk, qp, K2_Q_TOL),
            excess_qd=_excess(qdk, qdp, K2_QD_TOL), finite=finite)
        checks.append(check)
        errs["q"] = max(errs["q"], check["max_abs_err_q"])
        errs["qd"] = max(errs["qd"], check["max_abs_err_qd"])
    for check in checks:
        if not check["finite"]:
            raise RuntimeError(f"{kind} output is not finite: {check}")
        if check["excess_q"] > 1 or check["excess_qd"] > 1:
            raise RuntimeError(f"{kind} disagrees with its plain version: "
                               f"{check}")
    if not any(c["active_contacts"] for c in checks):
        raise RuntimeError(f"no contact was active in any {kind} check")
    return checks, errs


def _hold_ragged(kind, engine, n_steps, mod_keys, device):
    """Holds the kernel, launched directly on outputs one row longer than
    the batch and filled with SENTINEL, against the plain version on each
    of RAGGED_BATCHES random states (with per-env multipliers for K3) at
    the K2 bars; raises if a padded lane wrote the extra row. These
    launches are checks and are not counted."""
    from promp_tpu_torch.ops.substep_kernel import (
        load_launch, substep_chain_plain)

    launch = load_launch(engine, mod_keys)
    plain = substep_chain_plain(engine, n_steps, mod_keys)
    sets = []
    for n in RAGGED_BATCHES:
        gen = torch.Generator(device=device).manual_seed(n)
        label, *ins = random_chain_inputs(engine, gen, device, bool(mod_keys),
                                          n=n)
        sets.append((f"{label}_ragged_{n}", *ins))

    def kernel(*ins):
        n, nv = ins[0].shape
        outs = [torch.full((n + 1, nv), SENTINEL, device=device)
                for _ in range(2)]
        mods = ins[3].data_ptr() if mod_keys else None
        err = launch(*[t.data_ptr() for t in ins[:3]], mods,
                     *[o.data_ptr() for o in outs], n, n_steps,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kind} launch failed with cudaError {err}")
        torch.cuda.synchronize()
        if not all(bool((o[n] == SENTINEL).all()) for o in outs):
            raise RuntimeError(f"{kind} wrote past a batch of {n}")
        return outs[0][:n], outs[1][:n]

    return _hold(kind, engine, kernel, plain, sets)


def _merge(errs, more):
    return {k: max(errs[k], more[k]) for k in errs}


def _chain_bound(source, n_steps, batch, nv):
    """Least time of one chain launch: the emitted ops a substep x n_steps
    x batch at the FP32 peak, against q, qd, tau (and the mods row) read
    once and q, qd written once at the memory rate."""
    flops = float(source.n_ops * n_steps * batch)
    nbytes = batch * (5 * nv + source.nm) * 4
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, ops_per_substep=source.n_ops,
                nm=source.nm)


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
    checks, errs = _hold("K2", engine, kernel, plain, sets)
    ragged, ragged_errs = _hold_ragged("K2", engine, n_steps, (), device)
    checks, errs = checks + ragged, _merge(errs, ragged_errs)
    q, qd, tau = sets[0][1:]
    result = dict(phase="k2_vs_plain", model="half_cheetah", n_steps=n_steps,
                  checks=checks, tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL))
    result["ms"] = median_ms(lambda: kernel(q, qd, tau))
    result["plain_ms"] = median_ms(lambda: plain(q, qd, tau))
    result.update(_chain_bound(SubstepSource(engine), n_steps, q.shape[0],
                               engine.model.nv), max_abs_err=errs)
    emit(result)
    return result


# slice 3's bodies and the rand-params env each runs in
K3_ENVS = {"walker2d": "Walker2DRandParamsEnv",
           "hopper": "HopperRandParamsEnv",
           "half_cheetah": "HalfCheetahRandParamsEnv"}


def random_chain_inputs(engine, gen, device, mods, n=N_TASKS * N_ENVS):
    """(label, q, qd, tau[, mods_packed]) of ``n`` random states about the
    model's initial pose (drawn as the K2 tests draw them), with per-env
    random multipliers (every row its own) when ``mods``."""
    from promp_tpu_torch.envs.mujoco.rand_params import (
        sample_param_multipliers)
    from promp_tpu_torch.ops.substep_kernel import pack_mods

    m = engine.model
    init = torch.as_tensor(m.init_qpos, dtype=torch.float32, device=device)
    q = init + 0.3 * torch.randn((n, m.nv), generator=gen, device=device)
    q[:, 2] += 0.6
    qd = torch.randn((n, m.nv), generator=gen, device=device)
    tau = 0.5 * torch.randn((n, m.nv), generator=gen, device=device)
    if not mods:
        return ("random", q, qd, tau)
    multipliers = sample_param_multipliers(gen, m, n, 3.0, device=device)
    return ("random_per_env_mods", q, qd, tau,
            pack_mods(m, K3_KEYS, multipliers, (n,)))


def k3_walker_inputs(env, device, seed=0):
    """(label, q, qd, tau, mods_packed) sets of (N_TASKS * N_ENVS, ·)
    inputs of one env step: the states, actuation and per-task multipliers
    of a Walker2DRandParamsEnv rollout with a seeded (64, 64) policy at the
    steps K2_STEPS; and the rollout's number of dones."""
    from promp_tpu_torch.ops.substep_kernel import pack_mods
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
        state, action, task = recorder.kept[t]
        tau = engine.actuation(env.scale_action(action))
        sets.append((f"rollout_step_{t}",) + tuple(
            x.reshape(-1, nv).contiguous()
            for x in (state["q"], state["qd"], tau)) + (
            pack_mods(engine.model, K3_KEYS, task, state["q"].shape[:-1]),))
    return sets, int(recorder.dones)


def phase_k3(device):
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import (
        SubstepSource, substep_chain, substep_chain_plain)

    results = {}
    for body, env_name in K3_ENVS.items():
        env = normalize(make_env(env_name))
        engine = env.env.engine
        n_steps = env.env.frame_skip * engine.n_substeps
        kernel = substep_chain(engine, n_steps, K3_KEYS)
        plain = substep_chain_plain(engine, n_steps, K3_KEYS)
        gen = torch.Generator(device=device).manual_seed(1)
        sets, dones = ([], None)
        if body == "walker2d":
            sets, dones = k3_walker_inputs(env, device)
        sets.append(random_chain_inputs(engine, gen, device, mods=True))
        checks, errs = _hold("K3", engine, kernel, plain, sets)
        ragged, ragged_errs = _hold_ragged("K3", engine, n_steps, K3_KEYS,
                                           device)
        checks, errs = checks + ragged, _merge(errs, ragged_errs)
        ins = sets[0][1:]
        result = dict(phase="k3_vs_plain", model=body, n_steps=n_steps,
                      checks=checks, rollout_dones=dones,
                      tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL))
        result["ms"] = median_ms(lambda: kernel(*ins))
        result["plain_ms"] = median_ms(lambda: plain(*ins),
                                       runs=PLAIN_RUNS_ADDED)
        result.update(_chain_bound(SubstepSource(engine, K3_KEYS), n_steps,
                                   ins[0].shape[0], engine.model.nv),
                      max_abs_err=errs)
        emit(result)
        results[body] = result
    if not results["walker2d"]["rollout_dones"]:
        raise RuntimeError("the walker rollout ended no episode")
    return results


def phase_k2_walker_hopper(device):
    from promp_tpu_torch.envs import make_env
    from promp_tpu_torch.ops.substep_kernel import (
        substep_chain, substep_chain_plain)

    out = []
    for env_name in ("Walker2DRandVelEnv", "HopperEnv"):
        env = make_env(env_name)
        engine = env.engine
        n_steps = env.frame_skip * engine.n_substeps
        kernel = substep_chain(engine, n_steps)
        plain = substep_chain_plain(engine, n_steps)
        gen = torch.Generator(device=device).manual_seed(2)
        sets = [random_chain_inputs(engine, gen, device, mods=False)]
        checks, errs = _hold("K2", engine, kernel, plain, sets)
        ins = sets[0][1:]
        out.append(dict(model=engine.model.name, n_steps=n_steps,
                        checks=checks, max_abs_err=errs,
                        ms=median_ms(lambda: kernel(*ins))))
    emit(dict(phase="k2_walker_hopper", results=out,
              tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL)))
    return out


def phase_k2_ant_humanoid(device):
    """K2 against its plain version on the ant and the humanoid, as
    ``phase_k2``: rollout, random and ragged states at the K2 bars; its
    time, the plain version's, the bound, and the share of the card's SMs
    that the launch's blocks cover."""
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import (
        SubstepSource, substep_chain, substep_chain_plain)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for body, env_name in K2_ENVS_3D.items():
        env = normalize(make_env(env_name))
        engine = env.env.engine
        n_steps = env.env.frame_skip * engine.n_substeps
        kernel = substep_chain(engine, n_steps)
        plain = substep_chain_plain(engine, n_steps)
        sets = k2_inputs(env, device)
        checks, errs = _hold("K2", engine, kernel, plain, sets)
        ragged, ragged_errs = _hold_ragged("K2", engine, n_steps, (), device)
        checks, errs = checks + ragged, _merge(errs, ragged_errs)
        q, qd, tau = sets[0][1:]
        source = SubstepSource(engine)
        blocks = -(-q.shape[0] // 32)
        result = dict(phase="k2_ant_humanoid", model=body, env=env_name,
                      n_steps=n_steps, checks=checks, parts=source.parts,
                      block_bytes=source.block_bytes, blocks=blocks, sms=sms,
                      sm_share=min(blocks, sms) / sms,
                      tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL))
        result["ms"] = median_ms(lambda: kernel(q, qd, tau))
        result["plain_ms"] = median_ms(lambda: plain(q, qd, tau),
                                       runs=PLAIN_RUNS_ADDED)
        result.update(_chain_bound(source, n_steps, q.shape[0],
                                   engine.model.nv), max_abs_err=errs)
        emit(result)
        results[body] = result
    return results


def phase_trainer_3d(device, body):
    """3 meta-iterations on ``normalize(make_env(K2_ENVS_3D[body]))``: K2's
    launches 2 x 100 an iteration and none of K3's; on the humanoid,
    episodes end inside the window."""
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    env = normalize(make_env(K2_ENVS_3D[body]))
    extra = ("Time-MAMLSteps",) + tuple(
        f"Step_{k}-Env-{key}" for k in (0, 1)
        for key in env.diagnostics_keys)
    run = _train(env, device, "scan",
                 {"k2": (substep_chain, "launches"),
                  "k3": (substep_chain, "mods_launches")}, extra_keys=extra)
    launches, dones = run["launches"], run["dones"]
    emit(dict(phase=f"trainer_{body}", env=K2_ENVS_3D[body],
              iterations=run["iterations"], seconds=run["seconds"],
              k2_launches=launches["k2"], k3_launches=launches["k3"],
              dones=dones))
    if launches["k2"] != 2 * HORIZON * N_ITR or launches["k3"]:
        raise RuntimeError(f"K2 launched {launches['k2']} and K3 "
                           f"{launches['k3']} times in {N_ITR} {body} "
                           f"iterations, expected {2 * HORIZON * N_ITR} "
                           "and 0")
    if body == "humanoid" and not dones:
        raise RuntimeError("no humanoid episode ended inside a round: the "
                           "auto-reset branch did not run")
    return launches["k2"]


class _NeverDone:
    """An env wrapper whose episodes never end: the rollout skips its
    auto-reset branch."""

    never_done = True

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)


def _dispatched_ops(fn):
    """The number of aten operations ``fn()`` dispatches (a kernel called
    through ctypes, as K1-K3 are, dispatches none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_step_ops(device):
    """aten operations a scan-engine env step dispatches at the main path's
    shape (a 2-step rollout minus a 1-step one): the cheetah's, the ant's,
    the humanoid's, the walker's with and without its auto-reset branch,
    and one pack of the walker's multipliers (inside each walker step)."""
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import pack_mods

    def per_step(env):
        return _step_ops(env, device)

    cheetah = normalize(make_env("HalfCheetahRandVelEnv"))
    walker = normalize(make_env("Walker2DRandParamsEnv"))
    bodies_3d = {body: per_step(normalize(make_env(name)))
                 for body, name in K2_ENVS_3D.items()}
    tasks = walker.sample_tasks(torch.Generator(device=device).manual_seed(4),
                                N_TASKS, device)
    task_b = {k: v[:, None].expand((N_TASKS, N_ENVS) + v.shape[1:])
              for k, v in tasks.items()}
    result = dict(
        phase="step_ops", cheetah=per_step(cheetah), **bodies_3d,
        walker=per_step(walker), walker_never_done=per_step(
            _NeverDone(walker)),
        walker_pack_mods=_dispatched_ops(lambda: pack_mods(
            walker.env.model, K3_KEYS, task_b, (N_TASKS, N_ENVS))))
    result["walker_auto_reset"] = (result["walker"]
                                   - result["walker_never_done"])
    emit(result)
    return result


def phase_trainer_walker(device):
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    run = _train(normalize(make_env("Walker2DRandParamsEnv")), device, "scan",
                 {"k2": (substep_chain, "launches"),
                  "k3": (substep_chain, "mods_launches")})
    launches, dones = run["launches"], run["dones"]
    emit(dict(phase="trainer_walker_randparams", iterations=run["iterations"],
              seconds=run["seconds"], k2_launches=launches["k2"],
              k3_launches=launches["k3"], dones=dones))
    if launches["k3"] != 2 * HORIZON * N_ITR or launches["k2"]:
        raise RuntimeError(f"K3 launched {launches['k3']} and K2 "
                           f"{launches['k2']} times in {N_ITR} walker "
                           f"iterations, expected {2 * HORIZON * N_ITR} "
                           "and 0")
    if not dones:
        raise RuntimeError("no walker episode ended inside a round: the "
                           "auto-reset branch did not run")
    return launches["k3"]


def phase_trainer_cheetah(device):
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    run = _train(
        normalize(make_env("HalfCheetahRandVelEnv")), device, "scan",
        {"k2": (substep_chain, "launches"),
         "k3": (substep_chain, "mods_launches")}, extra_keys=tuple(
            f"Step_{k}-{key}" for k in (0, 1) for key in
            ("AvgForwardVel", "AvgFinalForwardVel", "AvgCtrlCost")))
    launches = run["launches"]
    emit(dict(phase="trainer_cheetah", iterations=run["iterations"],
              seconds=run["seconds"], k2_launches=launches["k2"],
              k3_launches=launches["k3"]))
    if launches["k3"]:
        raise RuntimeError(f"K3 launched {launches['k3']} times on the "
                           "cheetah, which has no physics mods")
    launches = launches["k2"]
    if launches != 2 * HORIZON * N_ITR:
        raise RuntimeError(f"K2 launched {launches} times in {N_ITR} "
                           f"iterations, expected {2 * HORIZON * N_ITR}")
    return launches


def _k2_counters():
    from promp_tpu_torch.ops.substep_kernel import substep_chain
    return {"k2": (substep_chain, "launches"),
            "k3": (substep_chain, "mods_launches")}


def _expect_launches(phase, launches, want):
    """Raises unless ``launches`` ({name: count}) is ``want``."""
    if launches != want:
        raise RuntimeError(f"{phase}: kernel launches {launches}, expected "
                           f"{want}")


def phase_trainer_trpo(device, exploration):
    """3 TRPO-MAML (E-MAML with ``exploration``) meta-iterations at
    run_scripts/maml_run_mujoco.py's (e-maml_run_mujoco.py's) settings on
    normalize(HalfCheetahRandDirecEnv()): K2 600, K3 0; in every iteration
    whose step was taken, MeanKL <= step_size and LossAfter < LossBefore;
    BacktrackIters in [0, 14]."""
    from promp_tpu_torch.algos.trpo_maml import TRPOMAML
    from promp_tpu_torch.envs import make_env, normalize

    step_size = 0.01
    phase = "trainer_emaml_cheetah" if exploration else "trainer_trpo_cheetah"
    run = _train(
        normalize(make_env("HalfCheetahRandDirecEnv")), device, "scan",
        _k2_counters(), loss_keys=TRPO_KEYS, extra_keys=("Time-MAMLSteps",),
        make_algo=lambda policy: TRPOMAML(
            policy=policy, inner_lr=0.1, num_inner_grad_steps=1,
            inner_type="log_likelihood", step_size=step_size,
            exploration=exploration))
    its = run["iterations"]
    emit(dict(phase=phase, iterations=its, seconds=run["seconds"],
              k2_launches=run["launches"]["k2"],
              k3_launches=run["launches"]["k3"],
              steps=[{k: it[k] for k in ("Time-OuterStep", "BacktrackIters",
                                         "MeanKL", "dLoss", "StepRejected")}
                     for it in its]))
    _expect_launches(phase, run["launches"],
                     {"k2": 2 * HORIZON * N_ITR, "k3": 0})
    for it in its:
        if not 0 <= it["BacktrackIters"] <= 14:
            raise RuntimeError(f"{phase}: BacktrackIters out of range: {its}")
        if not it["StepRejected"] and not (
                it["MeanKL"] <= step_size
                and it["LossAfter"] < it["LossBefore"]):
            raise RuntimeError(f"{phase}: a step outside the trust region "
                               f"or not better was taken: {its}")
    return run["launches"]["k2"]


def phase_trainer_pointmass(device, dice):
    """3 meta-iterations on normalize(MetaPointEnvCorner()) with K1:
    VPG-MAML at run.py's defaults, or DICE-MAML with the DICE processor
    (time baseline); K1 6, no skipped Adam update."""
    from promp_tpu_torch.algos.dice_maml import DICEMAML
    from promp_tpu_torch.algos.vpg_maml import VPGMAML
    from promp_tpu_torch.envs import MetaPointEnvCorner, normalize
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout
    from promp_tpu_torch.sampling.dice_processor import DiceSampleProcessor

    algo = DICEMAML if dice else VPGMAML
    phase = "trainer_dice_pointmass" if dice else "trainer_vpg_pointmass"
    run = _train(
        normalize(MetaPointEnvCorner()), device, "kernel",
        {"k1": (pointmass_rollout, "launches")},
        make_algo=lambda policy: algo(policy=policy, inner_lr=0.1,
                                      num_inner_grad_steps=1,
                                      learning_rate=1e-3),
        processor=DiceSampleProcessor(max_path_length=HORIZON)
        if dice else None)
    emit(dict(phase=phase, iterations=run["iterations"],
              seconds=run["seconds"], k1_launches=run["launches"]["k1"],
              mask_means=run["mask_means"]))
    _expect_launches(phase, run["launches"], {"k1": 2 * N_ITR})
    if dice and run["mask_means"] != [1.0] * (2 * N_ITR):
        raise RuntimeError(f"{phase}: K1 never ends an episode, so the "
                           f"mask must be all ones: {run['mask_means']}")
    return run["launches"]["k1"]


def phase_trainer_vpg_dice_walker(device):
    """3 VPG-DICE-MAML meta-iterations on normalize(Walker2DRandParamsEnv())
    with the DICE processor's return baseline, inner_lr 1e-3: K3 600, K2 0;
    walkers fall, so the DICE mask's mean is below 1."""
    from promp_tpu_torch.algos.dice_maml import VPG_DICEMAML
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.sampling.dice_processor import DiceSampleProcessor

    phase = "trainer_vpg_dice_walker"
    run = _train(
        normalize(make_env("Walker2DRandParamsEnv")), device, "scan",
        _k2_counters(),
        make_algo=lambda policy: VPG_DICEMAML(
            policy=policy, inner_lr=1e-3, num_inner_grad_steps=1,
            learning_rate=1e-3),
        processor=DiceSampleProcessor(
            max_path_length=HORIZON,
            return_baseline="LinearFeatureBaseline"))
    mask_mean = sum(run["mask_means"]) / len(run["mask_means"])
    emit(dict(phase=phase, iterations=run["iterations"],
              seconds=run["seconds"], k2_launches=run["launches"]["k2"],
              k3_launches=run["launches"]["k3"], dones=run["dones"],
              mask_mean=mask_mean, mask_means=run["mask_means"]))
    _expect_launches(phase, run["launches"],
                     {"k2": 0, "k3": 2 * HORIZON * N_ITR})
    if not mask_mean < 1.0:
        raise RuntimeError(f"{phase}: the DICE mask is all ones, but "
                           "walkers fall")
    return run["launches"]["k3"]


def trace_summary(path, top=10):
    """From a Chrome trace of torch.profiler: the ``top`` device kernels by
    summed time, the kernel launches, and their summed time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(kernel_launches=len(kernels),
                kernel_ms=sum(e["dur"] for e in kernels) / 1e3,
                top=[dict(name=name[:120], ms=ms, launches=n)
                     for name, (ms, n) in ranked])


def phase_trainer_modes(device):
    """The Trainer's modes on the main path's cheetah (ProMP, bench.py's
    settings, normalize(HalfCheetahRandVelEnv())): (a) a phase-split and a
    fused Trainer from one seed, 2 iterations each, reach the same
    parameters (max |diff| at most 1e-6); (b) timing_every=2 over 3
    iterations logs iteration 0's Time-* values again in iteration 1; (c)
    profile_dir traces iteration 1: the file exists, and its 10 device
    kernels with the most time and its kernel launches are printed. K2
    launches 200 an iteration in each."""
    from promp_tpu_torch.envs import make_env, normalize

    env = normalize(make_env("HalfCheetahRandVelEnv"))
    phase = "trainer_modes"
    launches = {}

    def train(label, n_itr, **kw):
        run = _train(env, device, "scan", _k2_counters(), n_itr=n_itr, **kw)
        _expect_launches(f"{phase} {label}", run["launches"],
                         {"k2": 2 * HORIZON * n_itr, "k3": 0})
        launches[label] = run["launches"]["k2"]
        return run

    split = train("split", 2)
    fused = train("fused", 2, fused=True, time_keys=("ItrTime",))
    max_diff = max(float((fused["state"]["params"][k] - v).abs().max())
                   for k, v in split["state"]["params"].items())
    timed = train("timing_every", 3, timing_every=2)
    its = timed["iterations"]
    carried = all(its[1][k] == its[0][k] for k in TIME_KEYS[1:])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        traced = train("profile", 2, profile_dir=tdir, profile_itr=1)
        path = traced["trainer"].profile_trace
        if not path or not os.path.exists(path):
            raise RuntimeError(f"{phase}: no profiler trace in {tdir}")
        trace = trace_summary(path)
        trace.update(file=os.path.basename(path),
                     bytes=os.path.getsize(path),
                     itr_ms=traced["iterations"][1]["ItrTime"] * 1e3)
    emit(dict(phase=phase, fused_max_abs_diff=max_diff,
              split_itr_s=[it["ItrTime"] for it in split["iterations"]],
              fused_itr_s=[it["ItrTime"] for it in fused["iterations"]],
              timing_every_measured_itr_s=[its[0]["ItrTime"],
                                           its[2]["ItrTime"]],
              timing_every_unmeasured_itr_s=[its[1]["ItrTime"]],
              time_keys_carried=carried, trace=trace, k2_launches=launches))
    if max_diff > 1e-6:
        raise RuntimeError(f"{phase}: fused and phase-split parameters "
                           f"differ by {max_diff}")
    if not carried:
        raise RuntimeError(f"{phase}: iteration 1 did not carry iteration "
                           f"0's Time-* values: {its}")
    if trace["kernel_launches"] == 0:
        raise RuntimeError(f"{phase}: the trace holds no device kernel")
    return sum(launches.values())


# ---------------------------------------------------------------- slice 8
# ----------------------------------------------- slice 9: float64, generic
# the float64 compat phase: the main path's width on the card, and the
# width at which the card's run is held against the CPU's (float64 to
# COMPAT_TOL on the parameters after COMPAT_ITR meta-iterations)
COMPAT_ITR = 2
COMPAT_CHECK = (10, 10, HORIZON)
COMPAT_TOL = 1e-6
COMPAT_BIAS = 3.0    # output bias: trajectories leave the zero-reward zone
# the generic engine against K2: the bodies, and the Sawyer envs. The two
# float32 steps may differ past the K2 bars where a penalty contact sits
# within rounding of its threshold (fn = 0: the implicit damping h c J^T J,
# O(1) against M, switches on or off): one of them then crosses it and
# the other does not. Such an env passes only if the float64 generic step
# lies within the bars of one of the two, and at most GENERIC_FLIP_SHARE
# of a set's envs may (on an H100: 0 of 4,800 cheetah env-steps, 9 of
# 4,800 ant env-steps, at most 6 in one set of 800; PERF.md)
GENERIC_BODIES = {"half_cheetah": "HalfCheetahRandVelEnv",
                  "ant": "AntRandGoalEnv"}
GENERIC_FLIP_SHARE = 0.02
SAWYER_ENVS = ("SawyerPushEnv", "SawyerPushSimpleEnv", "SawyerDoorEnv",
               "SawyerPickAndPlaceEnv")
GENERIC_ITR = 2       # swimmer iterations


def compat_promp(device, n_tasks, n_envs, horizon, n_itr=COMPAT_ITR, seed=1):
    """``n_itr`` ProMP meta-iterations in float64 at the main path's
    settings through the port's seed-exact sampler on ``device``, from
    float64 parameters made on the CPU from ``seed`` (the output bias at
    COMPAT_BIAS). Returns (final params on the CPU, per-iteration
    metrics, seconds)."""
    import numpy as np
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.compat_sampler import (
        CompatPointMassSampler, batch_paths)

    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=HIDDEN)
    gen = torch.Generator().manual_seed(seed)
    params = policy.init(gen, "cpu", dtype=torch.float64)
    params["mean_network/output/bias"].fill_(COMPAT_BIAS)
    params = {k: v.to(device) for k, v in params.items()}
    algo, proc = _promp(policy), _processor()
    ts = {"params": params, "step_sizes": algo.init_step_sizes(params)}
    opt = algo.init_opt_state(ts)
    hparams = dict(inner_kl_coeff=np.full((1,), algo.init_inner_kl_penalty,
                                          np.float64),
                   clip_eps=np.float64(algo.clip_eps))
    sampler = CompatPointMassSampler(policy, n_tasks, n_envs, horizon,
                                     seed=seed, dtype=torch.float64,
                                     device=device)
    iterations = []
    t0 = time.time()
    for _ in range(n_itr):
        tasks = sampler.sample_tasks()
        task_params = policy.replicate(ts["params"], n_tasks)
        rounds, it = [], {}
        for step in (0, 1):
            paths = sampler.obtain_samples(task_params, tasks,
                                           floor_std=step == 0)
            samples = proc.process(batch_paths(paths, device))
            stats = samples.pop("stats")
            rounds.append(samples)
            if step == 0:
                task_params = algo.adapt(task_params, ts["step_sizes"],
                                         samples)
            it[f"Step_{step}-AverageReturn"] = float(stats["AverageReturn"])
        ts, opt, metrics = algo.optimize_policy(ts, opt, rounds, hparams)
        it.update({k: float(metrics[k]) for k in PROMP_KEYS})
        iterations.append(it)
    seconds = time.time() - t0
    out = {k: v.detach().cpu() for k, v in ts["params"].items()}
    for k, v in out.items():
        if v.dtype != torch.float64 or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"float64_compat: parameter {k} is "
                               f"{v.dtype} or not finite")
    return out, iterations, seconds


def phase_float64_compat(device):
    """ProMP through the seed-exact sampler in float64: COMPAT_ITR
    meta-iterations at the main path's width on the card (finite, K1 not
    launched), and at COMPAT_CHECK on the card against the same run on the
    CPU, parameters within COMPAT_TOL."""
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout

    pointmass_rollout.launches = 0
    _, full, full_s = compat_promp(device, N_TASKS, N_ENVS, HORIZON)
    k1 = pointmass_rollout.launches
    card, _, card_s = compat_promp(device, *COMPAT_CHECK)
    cpu, _, cpu_s = compat_promp("cpu", *COMPAT_CHECK)
    err = max(float((card[k] - cpu[k]).abs().max()) for k in cpu)
    emit(dict(phase="float64_compat", width=[N_TASKS, N_ENVS, HORIZON],
              iterations=full, seconds=full_s, k1_launches=k1,
              check_width=list(COMPAT_CHECK), check_seconds=dict(
                  card=card_s, cpu=cpu_s),
              max_abs_err_params_card_vs_cpu=err, tolerance=COMPAT_TOL))
    for it in full:
        if not all(torch.isfinite(torch.tensor(v)) for v in it.values()):
            raise RuntimeError(f"float64_compat: not finite: {full}")
    if full[-1]["SkippedUpdates"] != 0:
        raise RuntimeError(f"float64_compat: Adam skipped updates: {full}")
    if k1:
        raise RuntimeError(f"float64_compat: K1 launched {k1} times")
    if not err <= COMPAT_TOL:
        raise RuntimeError(f"float64_compat: the card's parameters lie "
                           f"{err} from the CPU's (bar {COMPAT_TOL})")


def _env_excess(got, want, tol):
    """Each env's largest |got - want| / (atol + rtol * |want|)."""
    return ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
            ).amax(-1)


def _pair_excess(q, qd, q_ref, qd_ref):
    return torch.maximum(_env_excess(q, q_ref.to(q.dtype), K2_Q_TOL),
                         _env_excess(qd, qd_ref.to(qd.dtype), K2_QD_TOL))


def phase_generic_vs_k2(device):
    """One env step of the generic engine against K2 on the card, on the
    cheetah and the ant: the rollout and random states of k2_inputs at
    800 envs, at the K2 bars (K2's output the reference), the float64
    generic step the referee where a contact threshold splits the two
    (GENERIC_FLIP_SHARE); times of both."""
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.envs.mujoco.engine import Engine
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    results = {}
    for body, env_name in GENERIC_BODIES.items():
        env = normalize(make_env(env_name))
        engine = env.env.engine
        n_steps = env.env.frame_skip * engine.n_substeps
        kernel = substep_chain(engine, n_steps)

        def generic(q, qd, tau):
            return engine.generic_chain(q, qd, tau, n_steps)

        checks = []
        count0 = Engine.generic_substeps
        sets = k2_inputs(env, device)
        for label, *ins in sets:
            qk, qdk = kernel(*ins)
            qg, qdg = generic(*ins)
            q64, qd64 = generic(*(x.double() for x in ins))
            torch.cuda.synchronize()
            split = _pair_excess(qg, qdg, qk, qdk) > 1
            # the float64 step within the bars of one of the two
            sided = ((_pair_excess(qg.double(), qdg.double(), q64, qd64)
                      <= 1)
                     | (_pair_excess(qk.double(), qdk.double(), q64, qd64)
                        <= 1))
            checks.append(dict(
                inputs=label, envs=ins[0].shape[0],
                max_abs_err_q=float((qg - qk).abs().max()),
                max_abs_err_qd=float((qdg - qdk).abs().max()),
                excess_q=_excess(qg, qk, K2_Q_TOL),
                excess_qd=_excess(qdg, qdk, K2_QD_TOL),
                threshold_splits=int(split.sum()),
                unexplained=int((split & ~sided).sum()),
                finite=all(bool(torch.isfinite(x).all())
                           for x in (qg, qdg))))
        substeps = Engine.generic_substeps - count0
        q, qd, tau = sets[0][1:]
        result = dict(phase="generic_vs_k2", model=body, n_steps=n_steps,
                      checks=checks, generic_substeps=substeps,
                      threshold_splits=sum(c["threshold_splits"]
                                           for c in checks),
                      tolerances=dict(q=K2_Q_TOL, qd=K2_QD_TOL),
                      k2_ms=median_ms(lambda: kernel(q, qd, tau)),
                      generic_ms=median_ms(lambda: generic(q, qd, tau),
                                           runs=PLAIN_RUNS_ADDED),
                      generic_ops=_dispatched_ops(
                          lambda: generic(q, qd, tau)))
        emit(result)
        for check in checks:
            if not check["finite"]:
                raise RuntimeError(f"generic engine not finite: {check}")
            if (check["unexplained"] or check["threshold_splits"]
                    > GENERIC_FLIP_SHARE * check["envs"]):
                raise RuntimeError(f"generic engine disagrees with K2 on "
                                   f"{body}: {check}")
        # a float32 and a float64 generic chain for every set
        if substeps != 2 * n_steps * len(sets):
            raise RuntimeError(f"{substeps} generic substeps, expected "
                               f"{2 * n_steps * len(sets)}")
        results[body] = result
    return results


def _generic_counters():
    """K2's and K3's launch counters and the generic substeps' count."""
    from promp_tpu_torch.envs.mujoco.engine import Engine
    return dict(_k2_counters(), generic=(Engine, "generic_substeps"))


def phase_trainer_swimmer(device):
    """GENERIC_ITR ProMP meta-iterations on normalize(SwimmerRandVelEnv())
    at the main path's width: every env step by the generic substep (2 x
    100 x frame_skip x n_substeps an iteration), K2 and K3 not launched;
    the aten operations of one env step."""
    from promp_tpu_torch.envs import make_env, normalize

    env = normalize(make_env("SwimmerRandVelEnv"))
    per_itr = 2 * HORIZON * env.env.frame_skip * env.env.engine.n_substeps
    extra = tuple(f"Step_{k}-{key}" for k in (0, 1) for key in (
        "Env-reward_fwd", "AverageForwardProgress"))
    run = _train(env, device, "scan", _generic_counters(), extra_keys=extra,
                 n_itr=GENERIC_ITR)
    ops = _step_ops(env, device)
    emit(dict(phase="trainer_swimmer", iterations=run["iterations"],
              seconds=run["seconds"], launches=run["launches"],
              step_ops=ops))
    _expect_launches("trainer_swimmer", run["launches"],
                     dict(k2=0, k3=0, generic=per_itr * GENERIC_ITR))
    return run["launches"]["generic"]


def phase_trainer_sawyer(device):
    """One ProMP meta-iteration on each Sawyer env at the main path's
    width, by the generic substep, K2 and K3 not launched; for
    pick-and-place the number of grasped steps (not a gate: random
    weights may grasp nothing)."""
    from promp_tpu_torch.envs import make_env, normalize

    results = {}
    for name in SAWYER_ENVS:
        env = normalize(make_env(name))
        per_itr = 2 * HORIZON * env.env.frame_skip * env.env.engine.n_substeps
        grasped = []

        def count_grasps(trainer):
            sample = trainer._rollout

            def counted(*args):
                out = sample(*args)
                if "pickRew" in out["env_infos"]:
                    grasped.append((out["env_infos"]["pickRew"] != 0).sum())
                return out
            trainer._rollout = counted

        run = _train(env, device, "scan", _generic_counters(), n_itr=1,
                     on_trainer=count_grasps)
        result = dict(phase="trainer_sawyer", env=name,
                      iterations=run["iterations"], seconds=run["seconds"],
                      launches=run["launches"])
        if grasped:
            result["grasped_steps"] = int(sum(int(g) for g in grasped))
        emit(result)
        _expect_launches(f"trainer_sawyer {name}", run["launches"],
                         dict(k2=0, k3=0, generic=per_itr))
        results[name] = result
    return results


def _step_ops(env, device):
    """aten operations one scan-engine env step of ``env`` dispatches at
    the main path's shape (a 2-step rollout minus a 1-step one)."""
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.rollout import rollout

    gen = torch.Generator(device=device).manual_seed(3)
    policy = GaussianMLPPolicy(obs_dim=env.obs_dim, action_dim=env.action_dim,
                               hidden_sizes=HIDDEN)
    params = policy.replicate(policy.init(gen, device), N_TASKS)
    tasks = env.sample_tasks(gen, N_TASKS, device)
    n = [_dispatched_ops(lambda: rollout(env, policy, params, tasks, gen,
                                         N_ENVS, horizon))
         for horizon in (1, 2)]
    return n[1] - n[0]


def phase_render_rollout(device):
    """render.rollout on the swimmer and the point mass on the card: one
    episode each, its shapes and finite values."""
    from promp_tpu_torch.envs import make_env
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling import render

    out = {}
    for name, horizon in (("SwimmerRandVelEnv", HORIZON),
                          ("MetaPointEnvCorner", HORIZON)):
        env = make_env(name)
        gen = torch.Generator(device=device).manual_seed(5)
        policy = GaussianMLPPolicy(obs_dim=env.obs_dim,
                                   action_dim=env.action_dim,
                                   hidden_sizes=HIDDEN)
        params = policy.init(gen, device)
        task = env.sample_tasks(gen, 1, device)[0]
        traj = render.rollout(env, policy, params, task, gen,
                              max_path_length=horizon)
        shapes = dict(observations=list(traj["observations"].shape),
                      actions=list(traj["actions"].shape),
                      rewards=list(traj["rewards"].shape))
        want = dict(observations=[horizon, env.obs_dim],
                    actions=[horizon, env.action_dim], rewards=[horizon])
        leaves = [traj["observations"], traj["actions"], traj["rewards"]]
        states = traj["states"]
        leaves += list(states.values()) if isinstance(states, dict) \
            else [states]
        finite = all(bool(torch.isfinite(x).all()) for x in leaves)
        out[name] = dict(shapes=shapes, finite=finite,
                         return_=float(traj["rewards"].sum()))
        if shapes != want or not finite:
            raise RuntimeError(f"render_rollout {name}: {out[name]}, "
                               f"expected shapes {want}")
    emit(dict(phase="render_rollout", envs=out))


SCRIPTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "promp_tpu_torch", "run_scripts")
MUJOCO_SCRIPTS = ("pro-mp_run_mujoco", "maml_run_mujoco",
                  "e-maml_run_mujoco")
POINT_VARIANTS = ("MetaPointEnv", "MetaPointEnvV2", "MetaPointEnvCornerGoals",
                  "MetaPointEnvMomentum", "MetaPointEnvWalls")
# each run_experiment's snapshot report: (phase, logger.snapshot_report)
SNAPSHOT_REPORTS = []


def default_config(script):
    """A port run script's DEFAULT_CONFIG, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script.replace("-", "_"), os.path.join(SCRIPTS_DIR, f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return dict(module.DEFAULT_CONFIG)


def _read_progress(dump):
    with open(os.path.join(dump, "progress.csv")) as f:
        return list(csv.DictReader(f))


def _check_run_dir(phase, dump, n_itr, snapshots, finite_keys):
    """Raises unless ``dump`` holds params.json, a progress.csv of
    ``n_itr`` rows whose ``finite_keys`` are finite, and exactly the
    snapshot files ``snapshots``; returns the rows."""
    if not os.path.exists(os.path.join(dump, "params.json")):
        raise RuntimeError(f"{phase}: no params.json in {dump}")
    rows = _read_progress(dump)
    if len(rows) != n_itr:
        raise RuntimeError(f"{phase}: {len(rows)} rows in progress.csv, "
                           f"expected {n_itr}")
    for row in rows:
        for k in finite_keys:
            if not torch.isfinite(torch.tensor(float(row[k]))):
                raise RuntimeError(f"{phase}: {k} is not finite: {row[k]}")
    got = sorted(f for f in os.listdir(dump) if f.endswith(".pkl"))
    if got != sorted(snapshots):
        raise RuntimeError(f"{phase}: snapshots {got}, expected "
                           f"{sorted(snapshots)}")
    return rows


def _loss_keys(config):
    keys = TRPO_KEYS if config.get("algo") == "TRPOMAML" else PROMP_KEYS
    return keys + tuple(f"Step_{k}-AverageReturn" for k in
                        range(config.get("num_inner_grad_steps", 1) + 1))


def _run_experiment(phase, config, dump, counters):
    """``run.run_experiment(config, dump)`` with every count in
    ``counters`` set to 0 just before; checks the run directory (one
    itr_<n>.pkl an iteration under snapshot_mode "all"); returns the
    rows, seconds, launches and the logger's snapshot report."""
    from promp_tpu_torch.run import run_experiment
    from promp_tpu_torch.utils import logger

    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.time()
    run_experiment(config, dump_path=dump)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {name: getattr(obj, attr)
                for name, (obj, attr) in counters.items()}
    current = logger.Logger.CURRENT
    current.close()
    logger.Logger.CURRENT = None
    report = dict(current.snapshot_report)
    SNAPSHOT_REPORTS.append((phase, report))
    n_itr = config["n_itr"]
    snapshots = ([f"itr_{i}.pkl" for i in range(n_itr)]
                 if config.get("snapshot_mode") == "all" else
                 [] if config.get("snapshot_mode") == "none" else
                 ["params.pkl"])
    rows = _check_run_dir(phase, dump, n_itr, snapshots, _loss_keys(config))
    return dict(rows=rows, seconds=seconds, launches=launches, report=report)


def _pick(rows, keys):
    return [{k: float(r[k]) for k in keys if k in r} for r in rows]


def phase_run_scripts(device, work):
    """The three mujoco scripts' DEFAULT_CONFIGs through run_experiment in
    this process (n_itr 2, snapshot_mode "all"): K2 200 an iteration, K3
    0; then pro-mp_run_point_mass.py as a subprocess on the card from a
    --config_file (n_itr 2). Returns {path: K2 launches}."""
    t_phase = time.time()
    paths, runs = {}, {}
    for script in MUJOCO_SCRIPTS:
        config = dict(default_config(script), n_itr=2, snapshot_mode="all",
                      log_formats=["log", "csv"])
        run = _run_experiment(f"run_scripts {script}", config,
                              os.path.join(work, script), _k2_counters())
        _expect_launches(f"run_scripts {script}", run["launches"],
                         {"k2": 2 * HORIZON * 2, "k3": 0})
        paths[f"run_scripts_{script}"] = run["launches"]["k2"]
        runs[script] = dict(
            env=config["env"], seconds=run["seconds"],
            launches=run["launches"], snapshots=run["report"],
            iterations=_pick(run["rows"], ("ItrTime",) + _loss_keys(config)))
    config = dict(default_config("pro-mp_run_point_mass"), n_itr=2,
                  snapshot_mode="all")
    cfg_path = os.path.join(work, "point_mass.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    dump = os.path.join(work, "pro-mp_run_point_mass")
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, "pro-mp_run_point_mass.py"),
         "--config_file", cfg_path, "--dump_path", dump],
        env=env, capture_output=True, text=True, timeout=300)
    sub_seconds = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"pro-mp_run_point_mass.py exited "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    rows = _check_run_dir("run_scripts pro-mp_run_point_mass", dump, 2,
                          ["itr_0.pkl", "itr_1.pkl"], _loss_keys(config))
    runs["pro-mp_run_point_mass (subprocess)"] = dict(
        env=config["env"], rc=proc.returncode, seconds=sub_seconds,
        iterations=_pick(rows, ("ItrTime",) + _loss_keys(config)))
    emit(dict(phase="run_scripts", runs=runs,
              seconds=time.time() - t_phase))
    return paths


def phase_config3(device, work):
    """BASELINE.json config 3 with two inner steps: ProMP
    (pro-mp_run_mujoco's config) on Walker2DRandParamsEnv for 2 iterations
    (K3 300 an iteration, K2 0: three sampling rounds of 100 steps), and
    E-MAML (e-maml_run_mujoco's config) on AntRandGoalEnv for 1 iteration
    (K2 300); Step_0..2 returns finite, every TRPO step taken or its
    rejection printed. Returns ({path: K3}, {path: K2 of the ant})."""
    from promp_tpu_torch.ops.substep_kernel import substep_chain

    t_phase = time.time()
    step_keys = tuple(f"Step_{k}-AverageReturn" for k in range(3))
    walker_cfg = dict(default_config("pro-mp_run_mujoco"),
                      env="Walker2DRandParamsEnv", num_inner_grad_steps=2,
                      n_itr=2, snapshot_mode="all",
                      log_formats=["log", "csv"])
    walker = _run_experiment("config3 walker", walker_cfg,
                             os.path.join(work, "config3_walker"),
                             _k2_counters())
    _expect_launches("config3 walker", walker["launches"],
                     {"k2": 0, "k3": 3 * HORIZON * 2})
    ant_cfg = dict(default_config("e-maml_run_mujoco"), env="AntRandGoalEnv",
                   num_inner_grad_steps=2, n_itr=1, snapshot_mode="all",
                   log_formats=["log", "csv"])
    ant = _run_experiment("config3 ant", ant_cfg,
                          os.path.join(work, "config3_ant"),
                          {"k2": (substep_chain, "launches"),
                           "k3": (substep_chain, "mods_launches")})
    _expect_launches("config3 ant", ant["launches"],
                     {"k2": 3 * HORIZON, "k3": 0})
    rejected = []
    for it in _pick(ant["rows"], TRPO_KEYS):
        if it["StepRejected"]:
            rejected.append(it)
        elif not (it["MeanKL"] <= ant_cfg["step_size"]
                  and it["LossAfter"] < it["LossBefore"]):
            raise RuntimeError(f"config3 ant: a step outside the trust "
                               f"region or not better was taken: {it}")
    emit(dict(
        phase="config3", seconds=time.time() - t_phase,
        walker=dict(env=walker_cfg["env"], algo="ProMP",
                    num_inner_grad_steps=2, seconds=walker["seconds"],
                    launches=walker["launches"],
                    iterations=_pick(walker["rows"], (
                        "ItrTime", "KLInner", "KLOuter") + step_keys)),
        ant=dict(env=ant_cfg["env"], algo="E-MAML (TRPOMAML, exploration)",
                 num_inner_grad_steps=2, seconds=ant["seconds"],
                 launches=ant["launches"],
                 iterations=_pick(ant["rows"], (
                     "ItrTime", "MeanKL", "StepRejected", "BacktrackIters")
                     + step_keys),
                 rejected_steps=rejected)))
    return ({"config3_walker": walker["launches"]["k3"]},
            {"config3_ant": ant["launches"]["k2"]})


def phase_resume(device, work):
    """ProMP on HalfCheetahRandVelEnv at pro-mp_run_mujoco's config: 3
    iterations uninterrupted, against 2 through run_experiment, then a
    fresh build resumed by checkpoints.resume_trainer from the run's
    params.pkl and trained to n_itr 3. The final parameters, step sizes,
    Adam state and generator state must be equal to the bit. K2 200 an
    iteration (1,200 in all)."""
    from promp_tpu_torch.optimizers.adam import tree_leaves
    from promp_tpu_torch.run import build
    from promp_tpu_torch.utils import checkpoints, logger

    t_phase = time.time()
    counters = _k2_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    config = dict(default_config("pro-mp_run_mujoco"), n_itr=3,
                  snapshot_mode="last", log_formats=["csv"])

    def fresh(tag):
        logger.configure(dir=os.path.join(work, tag), format_strs=["csv"],
                         snapshot_mode="none")
        return build(config)

    whole = fresh("resume_whole")
    whole.train()
    run_dir = os.path.join(work, "resume_run")
    _run_experiment("resume first 2", dict(config, n_itr=2), run_dir, {})
    resumed = fresh("resume_resumed")
    start = checkpoints.resume_trainer(resumed, run_dir)
    if start != 2:
        raise RuntimeError(f"resume: resume_trainer started at {start}")
    resumed.train()
    torch.cuda.synchronize()
    logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None
    launches = {name: getattr(obj, attr)
                for name, (obj, attr) in counters.items()}
    a = tree_leaves((whole.train_state, whole.opt_state))
    b = tree_leaves((resumed.train_state, resumed.opt_state))
    equal = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    max_diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
    rng_equal = torch.equal(whole._gen.get_state(), resumed._gen.get_state())
    emit(dict(phase="resume", env=config["env"], leaves=len(a),
              bit_equal=equal, max_abs_diff=max_diff, rng_equal=rng_equal,
              adam_count=int(resumed.opt_state.count),
              generator_device=resumed._gen.device.type, launches=launches,
              seconds=time.time() - t_phase))
    _expect_launches("resume", launches, {"k2": 2 * HORIZON * 6, "k3": 0})
    if not (equal and rng_equal):
        raise RuntimeError(f"resume: the resumed run differs from the "
                           f"uninterrupted one (max |diff| {max_diff}, "
                           f"generator equal {rng_equal})")
    return launches["k2"]


def phase_native(work):
    """The logger's snapshots in the phases above went through the
    g++-built AsyncCheckpointWriter with no error; one AsyncFileSink round
    trip."""
    from promp_tpu_torch.ops import nvcc_build
    from promp_tpu_torch.utils.native import AsyncFileSink

    t_phase = time.time()
    path = os.path.join(work, "sink.txt")
    sink = AsyncFileSink(path)
    for i in range(500):
        sink.write(f"line{i}\n")
    sink.flush()
    dropped = sink.dropped_rows()
    sink.close()
    with open(path) as f:
        lines = f.read().splitlines()
    libraries = [os.path.basename(nvcc_build.build_host(n, f"{n}.cpp"))
                 for n in ("ckptwriter", "logsink")]
    submitted = sum(r["submitted"] for _, r in SNAPSHOT_REPORTS)
    errors = sum(r["errors"] for _, r in SNAPSHOT_REPORTS)
    native = all(r["native"] for _, r in SNAPSHOT_REPORTS if r["submitted"])
    emit(dict(phase="native", libraries=libraries, native=native,
              snapshots_written=submitted, errors=errors,
              runs=len(SNAPSHOT_REPORTS), sink_lines=len(lines),
              sink_dropped=dropped, seconds=time.time() - t_phase))
    if not native or errors or not submitted:
        raise RuntimeError(f"native: snapshot reports {SNAPSHOT_REPORTS}")
    if lines != [f"line{i}" for i in range(500)] or dropped:
        raise RuntimeError(f"native: the sink wrote {len(lines)} lines, "
                           f"dropped {dropped}")


def phase_point_variants(device, work):
    """One ProMP iteration through run.run_experiment (run.build) on each
    point variant at the point-mass script's full width (the scan
    engine); finite losses."""
    t_phase = time.time()
    base = dict(default_config("pro-mp_run_point_mass"), n_itr=1,
                snapshot_mode="none", log_formats=["csv"])
    results = {}
    for name in POINT_VARIANTS:
        run = _run_experiment(f"point_variants {name}", dict(base, env=name),
                              os.path.join(work, f"variant_{name}"), {})
        results[name] = dict(seconds=run["seconds"], **_pick(
            run["rows"], ("ItrTime",) + _loss_keys(base))[0])
    emit(dict(phase="point_variants", variants=results,
              seconds=time.time() - t_phase))


def phase_sweep(device, work):
    """run_sweep in serial mode over two seeds of the point mass (n_itr 1),
    then the docker and slurm launch files (generated, not run)."""
    from promp_tpu_torch.experiment_utils.run_sweep import _slug, run_sweep
    from promp_tpu_torch.run import run_experiment
    from promp_tpu_torch.utils import logger

    t_phase = time.time()
    data = os.path.join(work, "sweep")
    base = dict(default_config("pro-mp_run_point_mass"), n_itr=1,
                log_formats=["csv"])
    run_sweep(run_experiment, {"seed": [1, 2]}, "smoke", base_config=base,
              data_dir=data)
    logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None
    seeds, params = {}, {}
    for seed in (1, 2):
        dump = os.path.join(data, "smoke", _slug({"seed": seed}))
        rows = _check_run_dir(f"sweep seed {seed}", dump, 1, ["params.pkl"],
                              _loss_keys(base))
        seeds[seed] = _pick(rows, ("ItrTime", "Step_1-AverageReturn"))[0]
        with open(os.path.join(dump, "params.pkl"), "rb") as f:
            params[seed] = pickle.load(f)["train_state"]["params"]
    entry = os.path.relpath(os.path.join(SCRIPTS_DIR,
                                         "pro-mp_run_point_mass.py"))
    artifacts = {}
    for mode in ("docker", "slurm"):
        script = run_sweep(None, {"seed": [1, 2]}, f"smoke_{mode}",
                           base_config=base, mode=mode, data_dir=data,
                           python_entry=entry)
        artifacts[mode] = sorted(os.listdir(os.path.dirname(script)))
    if "Dockerfile" not in artifacts["docker"] or \
            "submit_all.sh" not in artifacts["slurm"]:
        raise RuntimeError(f"sweep: launch files missing: {artifacts}")
    if all((params[1][k] == params[2][k]).all() for k in params[1]):
        raise RuntimeError("sweep: the two seeds' runs have equal "
                           "parameters")
    emit(dict(phase="sweep", seeds=seeds, artifacts=artifacts,
              seconds=time.time() - t_phase))


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
    from promp_tpu_torch.envs import make_env
    engines = {body: Engine(get_model(body)) for body in K3_BODIES}
    sources = [("K2 half_cheetah", engines["half_cheetah"], ())]
    sources += [(f"K3 {body}", engines[body], K3_KEYS) for body in K3_BODIES]
    sources += [(f"K2 {body}", engines[body], ())
                for body in ("walker2d", "hopper")]
    sources += [(f"K2 {body}", make_env(name).engine, ())
                for body, name in K2_ENVS_3D.items()]
    sources = [(label, substep_kernel.SubstepSource(engine, keys))
               for label, engine, keys in sources]
    k1_widths = tuple(K1_WIDTHS)
    jobs = [(f"K1 {h0}x{h1}", rollout_kernel.build_job(h0, h1))
            for h0, h1 in k1_widths] + [
        (label, substep_kernel.build_job(src)) for label, src in sources]
    t0 = time.time()
    builds = nvcc_build.build_all([job for _, job in jobs])
    libraries = [dict(kernel=label, library=os.path.basename(b.path),
                      seconds=b.seconds, ptxas=ptxas_lines(b.log),
                      sass_instructions=sass_count(b.path))
                 for (label, _), b in zip(jobs, builds)]
    for lib, b, (h0, h1) in zip(libraries, builds, k1_widths):
        geo = rollout_kernel.launch_geometry(N_TASKS, N_ENVS, h0, h1)
        shared = block_shared_bytes(b.path, "pointmass_rollout_shared_bytes")
        if shared != geo.shared_bytes:
            raise RuntimeError(f"K1 {h0}x{h1}: the source lays out {shared} "
                               f"B a block, launch_geometry {geo}")
        if geo.w2_in_registers != K1_WIDTHS[(h0, h1)]:
            raise RuntimeError(f"K1 {h0}x{h1}: W2 is not where K1_WIDTHS "
                               f"puts it: {geo}")
        lib.update(block_shared_bytes=shared, geometry=geo._asdict())
    k = len(k1_widths)
    for lib, b, (_, src) in zip(libraries[k:], builds[k:], sources):
        shared = block_shared_bytes(b.path)
        if shared != src.block_bytes:
            raise RuntimeError(f"{lib['kernel']}: the source lays out "
                               f"{shared} B a block, SubstepSource "
                               f"{src.block_bytes}")
        lib.update(schedule=src.stats, parts=src.parts,
                   block_shared_bytes=shared)
    emit(dict(phase="build", seconds=time.time() - t0, libraries=libraries))

    k1 = phase_k1(device)
    k1_launches = phase_trainer(device)
    k1_paths = {"trainer": k1_launches,
                "trainer_vpg_pointmass": phase_trainer_pointmass(device,
                                                                 False),
                "trainer_dice_pointmass": phase_trainer_pointmass(device,
                                                                  True)}
    k2 = phase_k2(device)
    k2_launches = phase_trainer_cheetah(device)
    k2_paths = {"trainer_cheetah": k2_launches,
                "trainer_trpo_cheetah": phase_trainer_trpo(device, False),
                "trainer_emaml_cheetah": phase_trainer_trpo(device, True),
                "trainer_modes": phase_trainer_modes(device)}
    k3 = phase_k3(device)
    phase_k2_walker_hopper(device)
    k3_launches = phase_trainer_walker(device)
    k3_paths = {"trainer_walker_randparams": k3_launches,
                "trainer_vpg_dice_walker": phase_trainer_vpg_dice_walker(
                    device)}
    k2_3d = phase_k2_ant_humanoid(device)
    k2_3d_launches = {body: phase_trainer_3d(device, body)
                      for body in K2_ENVS_3D}
    phase_step_ops(device)
    phase_float64_compat(device)
    phase_generic_vs_k2(device)
    phase_trainer_swimmer(device)
    phase_trainer_sawyer(device)
    phase_render_rollout(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runs_") as work:
        k2_paths.update(phase_run_scripts(device, work))
        k3_config3, k2_config3_ant = phase_config3(device, work)
        k3_paths.update(k3_config3)
        k2_paths["resume"] = phase_resume(device, work)
        phase_point_variants(device, work)
        phase_sweep(device, work)
        phase_native(work)

    k3w = k3["walker2d"]
    emit({"kernels": [
        dict(name="K1_pointmass_rollout", route="cuda",
             source="promp_tpu_torch/csrc/rollout_kernel.cu",
             replaces="promp_tpu/ops/pallas_rollout.py:31",
             launches=k1_launches, launches_by_path=k1_paths,
             max_abs_err=max(k1["max_abs_err"].values()),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], design_floor_ms=k1["design_floor_ms"],
             kernel_ms=k1["kernel_ms"], library_ms=None),
        dict(name="K2_substep_chain", route="cuda",
             source="promp_tpu_torch/csrc/substep_chain.cu",
             replaces="promp_tpu/ops/pallas_substep.py:143",
             launches=k2_launches, launches_by_path=k2_paths,
             max_abs_err=max(k2["max_abs_err"].values()),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="K3_substep_chain_mods", route="cuda",
             source="promp_tpu_torch/csrc/substep_chain.cu",
             replaces="promp_tpu/ops/pallas_substep.py:252",
             launches=k3_launches, launches_by_path=k3_paths,
             max_abs_err=max(max(r["max_abs_err"].values())
                             for r in k3.values()),
             ms=k3w["ms"], plain_ms=k3w["plain_ms"],
             bound_ms=k3w["bound_ms"], bound_by=k3w["bound_by"],
             library_ms=None)] + [
        dict(name=f"K2_substep_chain_{body}", route="cuda",
             source="promp_tpu_torch/csrc/substep_chain.cu",
             replaces="promp_tpu/ops/pallas_substep.py:143",
             launches=k2_3d_launches[body],
             launches_by_path=dict({f"trainer_{body}": k2_3d_launches[body]},
                                   **(k2_config3_ant if body == "ant"
                                      else {})),
             max_abs_err=max(r["max_abs_err"].values()),
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], parts=r["parts"], library_ms=None)
        for body, r in k2_3d.items()]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
