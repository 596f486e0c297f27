"""Smoke run of the PyTorch/CUDA port (promp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit;
  2. build: K1 (csrc/rollout_kernel.cu), K2 (csrc/substep_chain.cu, filled
     in for half_cheetah, walker2d and hopper) and K3 (the same template
     with the rand-params mods, for the same three bodies) compiled with
     nvcc, one process each, all started together; each one's time and
     ptxas report (registers, spills), and for K2 and K3 the warp-split
     schedule's figures (warps, stages a substep, the busiest part's ops,
     shared slots and the block's shared memory) and, where the toolkit
     has cuobjdump, the kernel's SASS instruction count;
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
 10. step_ops: the aten operations one env step of the scan engine
     dispatches on the cheetah and on the walker, with and without the
     walker's auto-reset branch, and one pack of the walker's multipliers.
Then the {"kernels": [...]} line, the card's name and power limit as
nvidia-smi prints them, and the final {"ok": true, ...} line. Any failure
raises, and the script exits non-zero without the final line. It needs a
CUDA device and imports neither JAX nor the JAX package.
"""
import csv
import ctypes
import json
import os
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
# K2 against its plain version, one env step from the same inputs: the JAX
# package's own K2 bars (tests/test_pallas_substep.py:82-85), as
# |kernel - plain| <= atol + rtol * |plain|
K2_Q_TOL, K2_QD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-3)
K2_STEPS = (0, 25, 50, 75, 99)       # rollout steps whose states are held
# K3 holds to the same bars; the rand-params multipliers in the JAX order
K3_KEYS = ("body_inertia", "body_mass", "dof_damping", "friction")
K3_BODIES = ("walker2d", "hopper", "half_cheetah")
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


def block_shared_bytes(path):
    """The dynamic shared memory a block of the K2/K3 library at ``path``
    takes, as its template lays it out."""
    from promp_tpu_torch.ops import nvcc_build

    fn = nvcc_build.load(path).substep_chain_shared_bytes
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


def _train(env, device, backend, counters, extra_keys=()):
    """Runs N_ITR meta-iterations with every launch count in ``counters``
    ({name: (kernel wrapper, attribute)}) set to 0 just before; returns
    (per-iteration logged values, seconds, {name: launches}, the number of
    episodes that ended inside a round). Raises unless every iteration is
    finite and skips no Adam update."""
    from promp_tpu_torch.utils import logger

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as log_dir:
        trainer = _promp_trainer(env, device, backend, log_dir)
        dones = []
        sample = trainer._rollout

        def counted(*args):
            out = sample(*args)
            dones.append(out["dones"].sum())   # read after the run
            return out

        trainer._rollout = counted
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
    return iterations, seconds, launches, n_dones


def phase_trainer(device):
    from promp_tpu_torch.envs import MetaPointEnvCorner, normalize
    from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout

    iterations, seconds, launches, _ = _train(
        normalize(MetaPointEnvCorner()), device, "kernel",
        {"k1": (pointmass_rollout, "launches")})
    launches = launches["k1"]
    emit(dict(phase="trainer", iterations=iterations, seconds=seconds,
              k1_launches=launches))
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
    shape (a 2-step rollout minus a 1-step one): the cheetah's, the
    walker's with and without its auto-reset branch, and one pack of the
    walker's multipliers (inside each walker step)."""
    from promp_tpu_torch.envs import make_env, normalize
    from promp_tpu_torch.ops.substep_kernel import pack_mods
    from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
    from promp_tpu_torch.sampling.rollout import rollout

    def per_step(env):
        gen = torch.Generator(device=device).manual_seed(3)
        policy = GaussianMLPPolicy(obs_dim=env.obs_dim,
                                   action_dim=env.action_dim,
                                   hidden_sizes=HIDDEN)
        params = policy.replicate(policy.init(gen, device), N_TASKS)
        tasks = env.sample_tasks(gen, N_TASKS, device)
        n = [_dispatched_ops(lambda: rollout(env, policy, params, tasks, gen,
                                             N_ENVS, horizon))
             for horizon in (1, 2)]
        return n[1] - n[0]

    cheetah = normalize(make_env("HalfCheetahRandVelEnv"))
    walker = normalize(make_env("Walker2DRandParamsEnv"))
    tasks = walker.sample_tasks(torch.Generator(device=device).manual_seed(4),
                                N_TASKS, device)
    task_b = {k: v[:, None].expand((N_TASKS, N_ENVS) + v.shape[1:])
              for k, v in tasks.items()}
    result = dict(
        phase="step_ops", cheetah=per_step(cheetah),
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

    iterations, seconds, launches, dones = _train(
        normalize(make_env("Walker2DRandParamsEnv")), device, "scan",
        {"k2": (substep_chain, "launches"),
         "k3": (substep_chain, "mods_launches")})
    emit(dict(phase="trainer_walker_randparams", iterations=iterations,
              seconds=seconds, k2_launches=launches["k2"],
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

    iterations, seconds, launches, _ = _train(
        normalize(make_env("HalfCheetahRandVelEnv")), device, "scan",
        {"k2": (substep_chain, "launches"),
         "k3": (substep_chain, "mods_launches")}, extra_keys=tuple(
            f"Step_{k}-{key}" for k in (0, 1) for key in
            ("AvgForwardVel", "AvgFinalForwardVel", "AvgCtrlCost")))
    emit(dict(phase="trainer_cheetah", iterations=iterations,
              seconds=seconds, k2_launches=launches["k2"],
              k3_launches=launches["k3"]))
    if launches["k3"]:
        raise RuntimeError(f"K3 launched {launches['k3']} times on the "
                           "cheetah, which has no physics mods")
    launches = launches["k2"]
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
    engines = {body: Engine(get_model(body)) for body in K3_BODIES}
    sources = [("K2 half_cheetah", engines["half_cheetah"], ())]
    sources += [(f"K3 {body}", engines[body], K3_KEYS) for body in K3_BODIES]
    sources += [(f"K2 {body}", engines[body], ())
                for body in ("walker2d", "hopper")]
    sources = [(label, substep_kernel.SubstepSource(engine, keys))
               for label, engine, keys in sources]
    jobs = [("K1", rollout_kernel.build_job())] + [
        (label, substep_kernel.build_job(src)) for label, src in sources]
    t0 = time.time()
    builds = nvcc_build.build_all([job for _, job in jobs])
    libraries = [dict(kernel=label, library=os.path.basename(b.path),
                      seconds=b.seconds, ptxas=ptxas_lines(b.log))
                 for (label, _), b in zip(jobs, builds)]
    for lib, b, (_, src) in zip(libraries[1:], builds[1:], sources):
        lib.update(schedule=src.stats,
                   block_shared_bytes=block_shared_bytes(b.path),
                   sass_instructions=sass_count(b.path))
    emit(dict(phase="build", seconds=time.time() - t0, libraries=libraries))

    k1 = phase_k1(device)
    k1_launches = phase_trainer(device)
    k2 = phase_k2(device)
    k2_launches = phase_trainer_cheetah(device)
    k3 = phase_k3(device)
    phase_k2_walker_hopper(device)
    k3_launches = phase_trainer_walker(device)
    phase_step_ops(device)

    k3w = k3["walker2d"]
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
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="K3_substep_chain_mods", route="cuda",
             source="promp_tpu_torch/csrc/substep_chain.cu",
             replaces="promp_tpu/ops/pallas_substep.py:252",
             launches=k3_launches,
             max_abs_err=max(max(r["max_abs_err"].values())
                             for r in k3.values()),
             ms=k3w["ms"], plain_ms=k3w["plain_ms"],
             bound_ms=k3w["bound_ms"], bound_by=k3w["bound_by"],
             library_ms=None)]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
