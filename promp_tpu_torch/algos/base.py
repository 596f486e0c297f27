"""Shared MAML machinery (port of promp_tpu/algos/base.py).

The inner step theta' = theta - alpha (.) grad L_inner(theta) is a pure
function of one task's parameters and data, mapped over the task axis with
``torch.func.vmap``. The meta-objective differentiates through the unrolled
adaptation with ``torch.func.grad``, second-order terms included.
Per-parameter inner step sizes are a dict shaped like the policy params.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import grad, vmap

from promp_tpu_torch.ops import distributions as dg
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy


@dataclass(frozen=True)
class MAMLAlgo:
    policy: GaussianMLPPolicy
    inner_lr: float = 0.1
    num_inner_grad_steps: int = 1
    trainable_inner_step_size: bool = False

    def init_step_sizes(self, params):
        """Per-parameter inner step sizes, all ``inner_lr``."""
        return {k: torch.full_like(params[k], self.inner_lr)
                for k in self.policy.trainable_keys(params)}

    # the Trainer's interface; algorithms override what they use
    def init_opt_state(self, train_state):
        return ()

    def init_hparams(self):
        return {}

    def update_hparams(self, hparams, metrics):
        return hparams

    def mask_grads(self, grads):
        """Zero the gradients of non-trainable leaves (step sizes unless
        ``trainable_inner_step_size``; log_std unless ``learn_std``)."""
        if not self.trainable_inner_step_size:
            grads = dict(grads, step_sizes={
                k: torch.zeros_like(v) for k, v in grads["step_sizes"].items()})
        if not self.policy.learn_std:
            pg = dict(grads["params"])
            pg["log_std_network/log_std_var"] = torch.zeros_like(
                pg["log_std_network/log_std_var"])
            grads = dict(grads, params=pg)
        return grads

    # ----------------------------------------------------------- objectives
    def inner_objective(self, params, data, floor_std):
        """Likelihood-ratio surrogate -E[LR * A] on one task's buffers
        (observations (P, T, obs), actions, advantages, agent_infos)."""
        dist = self.policy.apply(params, data["observations"],
                                 floor_std=floor_std)
        lr = dg.likelihood_ratio(data["actions"], data["agent_infos"], dist)
        return -torch.mean(lr * data["advantages"])

    def log_likelihood_objective(self, params, data, floor_std):
        """The -E[log pi * A] inner variant."""
        dist = self.policy.apply(params, data["observations"],
                                 floor_std=floor_std)
        logli = dg.log_likelihood(data["actions"], dist)
        return -torch.mean(logli * data["advantages"])

    # ------------------------------------------------------------ adaptation
    def adapt_step(self, params, step_sizes, data, floor_std=False):
        """One gradient step on the inner objective for ONE task; keys
        without a step size pass through unchanged."""
        grads = grad(self.inner_objective)(params, data, floor_std)
        return {k: params[k] - step_sizes[k] * grads[k] if k in step_sizes
                else params[k] for k in params}

    def adapt(self, task_params, step_sizes, samples_data):
        """Adapted per-task params for the next sampling round (raw
        log_std, floor_std=False)."""
        data = self._optimization_view(samples_data)
        return vmap(lambda p, d: self.adapt_step(p, step_sizes, d,
                                                 floor_std=False))(
            task_params, data)

    def unrolled_adaptation(self, params, step_sizes, all_data):
        """Re-derive the adapted parameters from ``params`` (no task axis)
        so that a gradient flows through the inner steps. Step 0 uses the
        floored forward, later steps the raw one.

        Returns (per-task adapted params, list of per-step inner KLs).
        """
        n_tasks = all_data[0]["observations"].shape[0]
        task_params = self.policy.replicate(params, n_tasks)
        inner_kls = []
        for step in range(self.num_inner_grad_steps):
            data = self._optimization_view(all_data[step])
            floor = step == 0

            def kl_of_task(p, d, floor=floor):
                dist = self.policy.apply(p, d["observations"],
                                         floor_std=floor)
                return torch.mean(dg.kl(d["agent_infos"], dist))

            inner_kls.append(torch.mean(vmap(kl_of_task)(task_params, data)))
            task_params = vmap(
                lambda p, d, floor=floor: self.adapt_step(
                    p, step_sizes, d, floor_std=floor))(task_params, data)
        return task_params, inner_kls

    def _optimization_view(self, samples_data):
        """The buffers the objectives read."""
        return dict(
            observations=samples_data["observations"],
            actions=samples_data["actions"],
            advantages=samples_data["advantages"],
            agent_infos=samples_data["agent_infos"],
        )

    # ---------------------------------------------------------- diagnostics
    def post_update_dists(self, task_params, data, floor_std=False):
        """The per-task policies' distributions on ``data``'s observations."""
        return vmap(lambda p, d: self.policy.apply(
            p, d["observations"], floor_std=floor_std))(task_params, data)
