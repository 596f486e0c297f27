"""Time-major DICE sample processing with a path mask (port of
promp_tpu/sampling/dice_processor.py).

Each (task, env) stream of the rollout is one path, valid through its first
done (inclusive) or the horizon. Per task:
  1. per-step discounted rewards r_t * gamma^t on the mask;
  2. the time (or feature) baseline fitted on them over the valid steps,
     adjusted rewards = discounted - baseline, zero off the mask;
  3. optional normalization over the padded arrays, zeros included, and
     an optional shift to positive values;
  4. with ``return_baseline``, GAE advantages from that baseline fitted on
     the masked returns, normalized the same way.
Observations, actions, agent_infos and env_infos are multiplied by the
mask; ``adj_avg_rewards`` z-scores the masked rewards over the whole
meta-batch (population std).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.func import vmap

from promp_tpu_torch.ops import baselines as bl
from promp_tpu_torch.ops.discounting import (
    discount_cumsum,
    gae_advantages,
    normalize_advantages,
    shift_advantages_to_positive,
)
from promp_tpu_torch.optimizers.adam import tree_map


def prefix_mask(dones, dtype=torch.float32):
    """1.0 through the first done along the last axis (inclusive), 0.0
    after, in ``dtype``."""
    d = dones.to(dtype)
    prior = torch.cat([torch.zeros_like(d[..., :1]),
                       torch.cumsum(d, dim=-1)[..., :-1]], dim=-1)
    return (prior < 0.5).to(dtype)


@dataclass(frozen=True)
class DiceSampleProcessor:
    max_path_length: int = 100
    discount: float = 0.99
    gae_lambda: float = 1.0
    normalize_adv: bool = True
    positive_adv: bool = False
    baseline: str = "LinearTimeBaseline"
    return_baseline: Optional[str] = None  # e.g. "LinearFeatureBaseline"
    reg_coeff: float = 1e-5

    def _fit_predict(self, kind, observations, timesteps, targets, mask):
        """Fit the ``kind`` baseline per task on the rows where ``mask`` is
        1 and predict it everywhere: (tasks, P, T)."""
        if kind == "ZeroBaseline":
            return torch.zeros_like(targets)
        if kind == "LinearTimeBaseline":
            feats = bl.time_features(timesteps, targets.dtype)
        else:
            feats = bl.feature_features(observations, timesteps)
        n_tasks = targets.shape[0]
        flat = feats.reshape(n_tasks, -1, feats.shape[-1])
        coeffs = bl.fit_linear_baseline(
            flat, targets.reshape(n_tasks, -1),
            mask=mask.reshape(n_tasks, -1), reg_coeff=self.reg_coeff)
        return bl.predict_linear_baseline(flat, coeffs).reshape(targets.shape)

    def _normalize(self, x):
        if self.normalize_adv:
            x = vmap(normalize_advantages)(x)
        if self.positive_adv:
            x = vmap(shift_advantages_to_positive)(x)
        return x

    def process(self, traj):
        """traj -> DICE samples with (tasks, P, T) time-major leaves and a
        ``stats`` entry."""
        rewards = traj["rewards"]
        dones = traj["dones"]
        timesteps = traj["timesteps"]
        observations = traj["observations"]
        mask = prefix_mask(dones, rewards.dtype)
        mask_b = mask[..., None]

        discounted = rewards * self.discount ** timesteps.to(rewards.dtype) \
            * mask
        baselines = self._fit_predict(self.baseline, observations, timesteps,
                                      discounted, mask)
        adjusted = self._normalize((discounted - baselines) * mask)

        samples_data = dict(
            mask=mask,
            observations=observations * mask_b,
            actions=traj["actions"] * mask_b,
            rewards=rewards * mask,
            dones=dones,
            timesteps=timesteps,
            adjusted_rewards=adjusted,
            agent_infos=tree_map(lambda x: x * mask_b, traj["agent_infos"]),
            env_infos=tree_map(lambda x: x * mask, traj["env_infos"]),
        )
        if self.return_baseline is not None:
            reset = dones.to(rewards.dtype)
            returns = discount_cumsum(rewards, self.discount, reset=reset)
            rb = self._fit_predict(self.return_baseline, observations,
                                   timesteps, returns * mask, mask)
            adv = gae_advantages(rewards, rb, self.discount, self.gae_lambda,
                                 reset=reset) * mask
            samples_data["advantages"] = self._normalize(adv)
            samples_data["returns"] = returns * mask

        masked_rewards = samples_data["rewards"]
        samples_data["adj_avg_rewards"] = (
            (masked_rewards - torch.mean(masked_rewards))
            / (torch.std(masked_rewards, correction=0) + 1e-8))

        path_returns = torch.sum(masked_rewards, dim=-1)  # (tasks, P)
        samples_data["stats"] = dict(
            AverageReturn=torch.mean(path_returns),
            AverageDiscountedReturn=torch.mean(torch.sum(discounted, dim=-1)),
            NumTrajs=torch.tensor(float(path_returns.numel()),
                                  dtype=rewards.dtype, device=rewards.device),
            StdReturn=torch.std(path_returns, correction=0),
            MaxReturn=torch.max(path_returns),
            MinReturn=torch.min(path_returns),
            AveragePolicyStd=torch.mean(
                torch.exp(traj["agent_infos"]["log_std"])),
        )
        return samples_data


DiceMetaSampleProcessor = DiceSampleProcessor
