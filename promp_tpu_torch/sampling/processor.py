"""Sample processing: returns, baseline, GAE, normalization (port of
promp_tpu/sampling/processor.py).

Per task: discounted returns, a ridge baseline fitted on them, GAE
advantages and optional per-task normalization; plus the E-MAML
``adj_avg_rewards`` z-scored over the whole meta-batch. All on
(tasks, envs, T) buffers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from promp_tpu_torch.ops import baselines as bl
from promp_tpu_torch.ops.discounting import (
    discount_cumsum,
    gae_advantages,
    normalize_advantages,
    shift_advantages_to_positive,
)
from promp_tpu_torch.sampling.rollout import segment_returns, segment_starts


@dataclass(frozen=True)
class SampleProcessor:
    discount: float = 0.99
    gae_lambda: float = 1.0
    normalize_adv: bool = False
    positive_adv: bool = False
    baseline: str = "LinearFeatureBaseline"  # | LinearTimeBaseline | ZeroBaseline
    reg_coeff: float = 1e-5

    def _baseline_predictions(self, observations, timesteps, targets):
        """Fit and predict the baseline for every task: (tasks, P, T)."""
        if self.baseline == "ZeroBaseline":
            return torch.zeros_like(targets)
        if self.baseline == "LinearTimeBaseline":
            feats = bl.time_features(timesteps, observations.dtype)
        else:
            feats = bl.feature_features(observations, timesteps)
        flat = feats.reshape(feats.shape[0], -1, feats.shape[-1])
        coeffs = bl.fit_linear_baseline(
            flat, targets.reshape(targets.shape[0], -1),
            reg_coeff=self.reg_coeff)
        return bl.predict_linear_baseline(flat, coeffs).reshape(targets.shape)

    def process(self, traj):
        """traj: rollout output. Returns the samples dict with a ``stats``
        entry; leading shape (tasks, envs, T)."""
        rewards = traj["rewards"]
        dones = traj["dones"].to(rewards.dtype)
        timesteps = traj["timesteps"]

        returns = discount_cumsum(rewards, self.discount, reset=dones)
        baselines = self._baseline_predictions(traj["observations"],
                                               timesteps, returns)
        advantages = gae_advantages(rewards, baselines, self.discount,
                                    self.gae_lambda, reset=dones)
        if self.normalize_adv:
            advantages = torch.func.vmap(normalize_advantages)(advantages)
        if self.positive_adv:
            advantages = torch.func.vmap(shift_advantages_to_positive)(
                advantages)

        overall_std = torch.std(rewards, correction=0)
        adj_avg_rewards = (rewards - torch.mean(rewards)) / (overall_std + 1e-8)

        samples_data = dict(
            observations=traj["observations"],
            actions=traj["actions"],
            rewards=rewards,
            dones=traj["dones"],
            timesteps=timesteps,
            returns=returns,
            advantages=advantages,
            adj_avg_rewards=adj_avg_rewards,
            agent_infos=traj["agent_infos"],
            env_infos=traj["env_infos"],
        )
        samples_data["stats"] = self._stats(traj, returns)
        return samples_data

    def _stats(self, traj, returns):
        """Path statistics from segment masks, as 0-dim tensors."""
        seg_sums, seg_ends = segment_returns(
            traj["rewards"], traj["timesteps"], traj["dones"])
        starts = segment_starts(traj["timesteps"], returns.dtype)
        at_end = seg_ends > 0
        n_ends = torch.clamp(torch.sum(seg_ends), min=1.0)
        undisc = torch.sum(seg_sums) / n_ends
        max_ret = torch.max(torch.where(
            at_end, seg_sums, torch.full_like(seg_sums, -float("inf"))))
        min_ret = torch.min(torch.where(
            at_end, seg_sums, torch.full_like(seg_sums, float("inf"))))
        sum_sq = torch.sum(torch.where(at_end, seg_sums ** 2,
                                       torch.zeros_like(seg_sums)))
        std_ret = torch.sqrt(torch.clamp(sum_sq / n_ends - undisc ** 2,
                                         min=0.0))
        disc = (torch.sum(returns * starts)
                / torch.clamp(torch.sum(starts), min=1.0))
        return dict(
            AverageReturn=undisc,
            AverageDiscountedReturn=disc,
            NumTrajs=torch.sum(starts),
            StdReturn=std_ret,
            MaxReturn=max_ret,
            MinReturn=min_ret,
            AveragePolicyStd=torch.mean(
                torch.exp(traj["agent_infos"]["log_std"])),
        )

