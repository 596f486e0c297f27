"""Meta-training loop (port of promp_tpu/trainer.py).

Per iteration: sample tasks; for each of the (num_inner_grad_steps + 1)
rounds, sample rollouts, process them and (but after the last) adapt the
per-task parameters; then the algorithm's outer step.

Three modes, as in the JAX package:
  * phase-split and measured (``timing_every=1``, the default): each phase
    ends in a device barrier, so the Time-* keys are wall-clock times of
    that phase, and the round's policy forwards are re-timed for the
    PolicyExecTime / EnvExecTime split;
  * phase-split, every ``timing_every``-th iteration measured: the others
    run with no barrier and no re-timing, take one synchronisation at the
    end (the metrics' copy to the host) and log the last measured Time-*
    values again;
  * ``fused``: every iteration runs like an unmeasured one and logs no
    Time-* keys.
All three draw from the Trainer's generator in the same order, so they
reach the same ``train_state`` from one seed. ``profile_dir`` wraps
iteration ``profile_itr`` in ``torch.profiler.profile`` (CPU activity,
and CUDA activity on the card) and writes its Chrome trace there.

``rollout_backend`` chooses the sampler: ``"scan"`` is the general engine
(sampling/rollout.py); ``"kernel"`` is K1 (ops/rollout_kernel.py), which
covers exactly sparse MetaPointEnvCorner under normalize(10) with a
2-hidden-layer tanh MLP. Asking for ``"kernel"`` elsewhere raises.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from promp_tpu_torch.envs.normalized import NormalizedEnv
from promp_tpu_torch.envs.point.corner import MetaPointEnvCorner
from promp_tpu_torch.ops.rollout_kernel import pointmass_rollout
from promp_tpu_torch.optimizers.adam import tree_map
from promp_tpu_torch.sampling.rollout import rollout
from promp_tpu_torch.utils import logger
from promp_tpu_torch.utils.misc import resolve_device

LOG_STD_KEY = "log_std_network/log_std_var"


def _to_host(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def synchronize(device):
    """Host barrier for the phase timings: waits for the card's queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Trainer:
    algo: Any
    env: Any
    policy: Any
    sample_processor: Any
    meta_batch_size: int = 40
    rollouts_per_meta_task: int = 20
    max_path_length: int = 100
    n_itr: int = 1001
    seed: int = 1
    start_itr: int = 0
    rollout_backend: str = "scan"   # "scan" | "kernel"
    device: Any = "cuda"
    timing_every: int = 1
    fused: bool = False
    profile_dir: Optional[str] = None
    profile_itr: int = 2

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # full-precision float32 everywhere, TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.rollout_backend not in ("scan", "kernel"):
            raise ValueError(f"rollout_backend must be 'scan' or 'kernel', "
                             f"not {self.rollout_backend!r}")
        if self.rollout_backend == "kernel":
            reason = self._kernel_unsupported()
            if reason:
                raise ValueError(f"rollout_backend='kernel' does not cover "
                                 f"this env/policy: {reason}; use 'scan'")
        self.num_inner_grad_steps = self.algo.num_inner_grad_steps
        self._build()

    def _kernel_unsupported(self):
        """Why K1 cannot run this env/policy, or '' when it can."""
        env, policy = self.env, self.policy
        inner = getattr(env, "env", env)
        checks = [
            (isinstance(env, NormalizedEnv), "env is not wrapped in normalize"),
            (isinstance(inner, MetaPointEnvCorner),
             "env is not MetaPointEnvCorner"),
            (getattr(inner, "reward_type", None) == "sparse",
             f"reward_type is {getattr(inner, 'reward_type', None)!r}, "
             "not 'sparse'"),
            (getattr(env, "normalization_scale", None) == 10.0,
             "normalization_scale is not 10"),
            (not getattr(env, "normalize_obs", False), "normalize_obs is on"),
            (not getattr(env, "normalize_reward", False),
             "normalize_reward is on"),
            (len(policy.hidden_sizes) == 2,
             "policy does not have two hidden layers"),
            (policy.hidden_nonlinearity == "tanh",
             "hidden nonlinearity is not tanh"),
            (policy.output_nonlinearity is None,
             "policy has an output nonlinearity"),
        ]
        return "; ".join(msg for ok, msg in checks if not ok)

    # ------------------------------------------------------------------ build
    def _build(self):
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        params = self.policy.init(self._gen, self.device)
        step_sizes = self.algo.init_step_sizes(params)
        self.train_state = {"params": params, "step_sizes": step_sizes}
        self.opt_state = self.algo.init_opt_state(self.train_state)
        self.hparams = self.algo.init_hparams()
        self.total_timesteps_sampled = 0
        self._policy_fwd = torch.func.vmap(self.policy.apply,
                                           in_dims=(0, 0, None))
        self._phase_times = {}
        self.profile_trace = None  # the path of the last trace written

    # -------------------------------------------------------------- sampling
    def _rollout(self, task_params, tasks, floor, reset_draw=None,
                 noise=None, reset_draws=None):
        """One sampling round. ``reset_draw``/``noise`` are an optional
        pre-drawn draw of the initial resets (as the env's ``reset`` takes
        it, batch (tasks, envs)) and action noise: (T, tasks, envs, act) for
        "scan", (tasks, T, envs, act) for "kernel". ``reset_draws``, for
        "scan", are the optional pre-drawn draws of the in-loop auto-resets
        (sampling/rollout.py)."""
        if self.rollout_backend == "scan":
            return rollout(self.env, self.policy, task_params, tasks,
                           self._gen, self.rollouts_per_meta_task,
                           self.max_path_length, floor_std=floor,
                           reset_draw=reset_draw, noise=noise,
                           reset_draws=reset_draws)
        n_tasks, n_envs = self.meta_batch_size, self.rollouts_per_meta_task
        horizon = self.max_path_length
        task_b = tasks[:, None].expand((n_tasks, n_envs) + tasks.shape[1:])
        _, obs0 = self.env.reset(task_b, self._gen, reset_draw)
        if noise is None:
            noise = torch.randn((n_tasks, horizon, n_envs,
                                 self.env.action_dim), generator=self._gen,
                                device=self.device)
        # the kernel reads log_std raw: apply the pre-update std floor here
        task_params = dict(task_params)
        if floor:
            task_params[LOG_STD_KEY] = torch.clamp(
                task_params[LOG_STD_KEY], min=self.policy.min_log_std)
        task_params = {k: v.contiguous() for k, v in task_params.items()}
        out = pointmass_rollout(task_params, tasks.contiguous(),
                                obs0.contiguous(), noise.contiguous())
        # the kernel's env never terminates: fill the engine's contract
        out["dones"] = torch.zeros((n_tasks, n_envs, horizon),
                                   dtype=torch.bool, device=self.device)
        out["timesteps"] = torch.arange(
            horizon, dtype=torch.int32, device=self.device).expand(
                n_tasks, n_envs, horizon)
        out["env_infos"] = {}
        return out

    def _process(self, traj):
        samples = self.sample_processor.process(traj)
        diag = getattr(self.env, "diagnostics", None)
        if diag is not None:
            samples["stats"].update(diag(samples))
        return samples

    # ------------------------------------------------------------------ train
    def train(self):
        """The meta-training loop; returns the final train_state."""
        steps_per_round = (self.meta_batch_size * self.rollouts_per_meta_task
                           * self.max_path_length)
        n_rounds = self.num_inner_grad_steps + 1
        for itr in range(self.start_itr, self.n_itr):
            itr_start = time.time()
            logger.log(f"\n ---------------- Iteration {itr} ----------------")
            profiler = self._profiler(itr)
            with (profiler if profiler is not None
                  else contextlib.nullcontext()):
                if self.fused:
                    metrics, _ = self._iteration()
                else:
                    metrics = self._run_phases(measure=(
                        self.timing_every <= 1
                        or itr % self.timing_every == 0))
            if profiler is not None:
                self._write_trace(profiler, itr)
            self.total_timesteps_sampled += steps_per_round * n_rounds
            self.hparams = self.algo.update_hparams(self.hparams, metrics)
            self._log_metrics(itr, metrics, itr_start)
            logger.save_itr_params(itr, self.get_itr_snapshot(itr))
            logger.dumpkvs()
        logger.sync_snapshots()
        logger.log("Training finished")
        return self.train_state

    def _profiler(self, itr):
        """A ``torch.profiler.profile`` for iteration ``itr`` when it is the
        one to trace, else None."""
        if self.profile_dir is None or itr != self.profile_itr:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _write_trace(self, profiler, itr):
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_itr{itr}.json")
        profiler.export_chrome_trace(path)
        self.profile_trace = path
        logger.log(f"profiler trace written to {path}")

    def _run_phases(self, tasks=None, draws=None, measure=True):
        """One phase-split iteration; returns host-side metrics with the
        Time-* keys of this iteration when ``measure``, else those of the
        last measured one (none before the first).

        ``tasks`` (a tensor or a dict of tensors) and ``draws`` (a list
        with one (reset draw, noise) pair or (reset draw, noise, auto-reset
        draws) triple per round, see ``_rollout``) may be given pre-drawn;
        otherwise they come from the trainer's generator.
        """
        metrics, times = self._iteration(tasks, draws, measure)
        if measure:
            self._phase_times = times
        metrics.update(self._phase_times)
        return metrics

    def _iteration(self, tasks=None, draws=None, measure=False):
        """The rounds and the outer step; returns (host-side metrics, the
        phase times). ``measure`` takes a device barrier after each phase
        and re-times the policy's forwards; without it the phases run back
        to back, the times are not meaningful, and the one synchronisation
        is the metrics' copy to the host."""
        dev = self.device
        barrier = (lambda: synchronize(dev)) if measure else (lambda: None)
        if tasks is None:
            tasks = self.env.sample_tasks(self._gen, self.meta_batch_size, dev)
        task_params = self.policy.replicate(self.train_state["params"],
                                            self.meta_batch_size)
        all_data, round_stats = [], []
        t_sampling = t_proc = t_inner = t_policy = 0.0
        for step in range(self.num_inner_grad_steps + 1):
            floor = step == 0
            round_draws = tuple(draws[step]) if draws is not None else ()
            round_draws += (None,) * (3 - len(round_draws))
            barrier()
            ts = time.time()
            traj = self._rollout(task_params, tasks, floor, *round_draws)
            barrier()
            t_sampling += time.time() - ts
            tp = time.time()
            samples = self._process(traj)
            barrier()
            t_proc += time.time() - tp
            if measure:
                # policy/env split of sampling: re-time the policy's
                # forwards over the round's observations; the rest is env
                # time
                tpol = time.time()
                self._policy_fwd(task_params, traj["observations"], floor)
                barrier()
                t_policy += time.time() - tpol
            round_stats.append(samples.pop("stats"))
            all_data.append(samples)
            if step < self.num_inner_grad_steps:
                ta = time.time()
                task_params = self.algo.adapt(
                    task_params, self.train_state["step_sizes"], samples)
                barrier()
                t_inner += time.time() - ta
        to = time.time()
        self.train_state, self.opt_state, metrics = self.algo.optimize_policy(
            self.train_state, self.opt_state, all_data, self.hparams)
        metrics, round_stats = _to_host((metrics, tuple(round_stats)))
        t_outer = time.time() - to
        for step, stats in enumerate(round_stats):
            for k, v in stats.items():
                metrics[f"Step_{step}-{k}"] = v
        return metrics, {
            "Time-Sampling": t_sampling,
            "Time-SampleProc": t_proc,
            "Time-InnerStep": t_inner,
            "Time-OuterStep": t_outer,
            "Time-MAMLSteps": t_inner + t_outer,
            "PolicyExecTime": min(t_policy, t_sampling),
            "EnvExecTime": max(t_sampling - t_policy, 0.0),
        }

    def _log_metrics(self, itr, metrics, itr_start):
        logger.logkv("Itr", itr)
        logger.logkv("n_timesteps", self.total_timesteps_sampled)
        for k, v in metrics.items():
            if k == "inner_kls":
                continue
            v = np.asarray(v)
            logger.logkv(k, float(v) if v.ndim == 0 else v)
        logger.logkv("ItrTime", time.time() - itr_start)

    # -------------------------------------------------------------- snapshots
    def get_itr_snapshot(self, itr):
        """Pickle-able snapshot with numpy leaves."""
        return dict(
            itr=itr,
            train_state=_to_host(self.train_state),
            opt_state=_to_host(self.opt_state),
            hparams=dict(self.hparams),
            # the generator's state: a CPU byte tensor for a generator on
            # either device (seed and offset of the card's Philox)
            rng=self._gen.get_state().numpy(),
            rng_device=self._gen.device.type,
            config=dict(
                meta_batch_size=self.meta_batch_size,
                rollouts_per_meta_task=self.rollouts_per_meta_task,
                max_path_length=self.max_path_length,
                seed=self.seed,
            ),
        )

    def restore(self, snapshot):
        """Resume from ``get_itr_snapshot``'s output, taken on a Trainer
        on the same kind of device (a generator's state is
        device-specific)."""
        rng_device = snapshot.get("rng_device", self._gen.device.type)
        if rng_device != self._gen.device.type:
            raise ValueError(f"the snapshot's generator ran on "
                             f"{rng_device!r}, this Trainer's on "
                             f"{self._gen.device.type!r}")
        to_dev = lambda a: torch.as_tensor(a, device=self.device)
        self.train_state = tree_map(to_dev, snapshot["train_state"])
        self.opt_state = tree_map(to_dev, snapshot["opt_state"])
        self.hparams = dict(snapshot["hparams"])
        self._gen.set_state(torch.as_tensor(snapshot["rng"],
                                            dtype=torch.uint8))
        self.start_itr = snapshot["itr"] + 1
