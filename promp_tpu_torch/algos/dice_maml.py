"""DICE-MAML and VPG-DICE-MAML: the infinitely differentiable Monte Carlo
estimator (port of promp_tpu/algos/dice_maml.py).

  * the magic box exp(tau - stop_grad(tau)), tau = cumsum_t(log pi): value
    1, gradient that of tau at every order (``Tensor.detach`` under
    ``torch.func.grad`` stops the gradient at every nesting level, as
    ``lax.stop_gradient`` does)
  * DICEMAML: -E[magic_box * adjusted_rewards * mask] on time-major
    (paths, T) buffers for both the inner and the outer step
  * VPG_DICEMAML: the DICE inner step and the plain -E[log pi * A * mask]
    outer step (the processor's ``return_baseline`` advantages)
  * the outer KL a mean over the mask; Adam on the full batch

The DICE inner gradient multiplies the raw adjusted discounted rewards, so
its size follows the env's reward scale: on the locomotion envs an
inner_lr near 1e-3 takes the place of ProMP's 0.1.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import vmap

from promp_tpu_torch.algos.vpg_maml import VPGMAML, stack_kls
from promp_tpu_torch.ops import distributions as dg


def magic_box(logprobs, dim=-1):
    """Value 1 everywhere; the gradient flows through the cumulative
    log-probs along ``dim``."""
    tau = torch.cumsum(logprobs, dim=dim)
    return torch.exp(tau - tau.detach())


@dataclass(frozen=True)
class DICEMAML(VPGMAML):

    def _optimization_view(self, samples_data):
        """The DICE buffers; ``advantages`` only where the processor made
        them."""
        keys = ("observations", "actions", "adjusted_rewards", "mask",
                "agent_infos", "advantages")
        return {k: samples_data[k] for k in keys if k in samples_data}

    def inner_objective(self, params, data, floor_std):
        """-E[magic_box(cumsum log pi) * adjusted_rewards * mask]."""
        dist = self.policy.apply(params, data["observations"],
                                 floor_std=floor_std)
        logli = dg.log_likelihood(data["actions"], dist)  # (P, T)
        return -torch.mean(magic_box(logli) * data["adjusted_rewards"]
                           * data["mask"])

    def outer_task_objective(self, params_task, data_task):
        return self.inner_objective(params_task, data_task, floor_std=False)

    def meta_objective(self, params, step_sizes, all_data, hparams):
        task_params, inner_kls = self.unrolled_adaptation(
            params, step_sizes, all_data)
        data = self._optimization_view(all_data[-1])

        def task_objective(p, d):
            surr = self.outer_task_objective(p, d)
            dist = self.policy.apply(p, d["observations"], floor_std=False)
            kl = dg.kl(d["agent_infos"], dist)
            outer_kl = torch.sum(kl * d["mask"]) / torch.clamp(
                torch.sum(d["mask"]), min=1.0)
            return surr, outer_kl

        surr_objs, outer_kls = vmap(task_objective)(task_params, data)
        return torch.mean(surr_objs), dict(inner_kls=stack_kls(inner_kls),
                                           outer_kl=torch.mean(outer_kls))


@dataclass(frozen=True)
class VPG_DICEMAML(DICEMAML):  # noqa: N801 (the JAX package's name)

    def outer_task_objective(self, params_task, data_task):
        dist = self.policy.apply(params_task, data_task["observations"],
                                 floor_std=False)
        logli = dg.log_likelihood(data_task["actions"], dist)
        return -torch.mean(logli * data_task["advantages"]
                           * data_task["mask"])
