"""ProMP: Proximal Meta-Policy Search (port of promp_tpu/algos/promp.py).

  * inner objective: likelihood-ratio surrogate -E[LR * A]
  * outer objective: PPO-clipped surrogate on the post-update
    distributions, averaged over tasks, plus the inner-KL penalty
    mean(eta_s * inner_kl_s)
  * Adam for ``num_ppo_steps`` epochs on the full meta-batch, optionally
    gated by ``outer_kl_limit``
  * the adaptive KL coefficient (x2 / /2 against ``target_inner_step``)
    and clip-eps annealing, on the host between iterations
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from promp_tpu_torch.algos.base import MAMLAlgo
from promp_tpu_torch.ops import distributions as dg
from promp_tpu_torch.optimizers.adam import Adam, tree_map


@dataclass(frozen=True)
class ProMP(MAMLAlgo):
    learning_rate: float = 1e-3
    num_ppo_steps: int = 5
    clip_eps: float = 0.2
    target_inner_step: float = 0.01
    init_inner_kl_penalty: float = 1e-2
    adaptive_inner_kl_penalty: bool = True
    anneal_factor: float = 1.0
    # when > 0, PPO epochs stop updating once the mean KL(sampling policy ||
    # current policy) exceeds the limit
    outer_kl_limit: float = 0.0

    def make_optimizer(self):
        return Adam(learning_rate=self.learning_rate)

    def init_opt_state(self, train_state):
        return self.make_optimizer().init(train_state)

    def init_hparams(self):
        """Host-side hyperparameters, fed to the outer step as values."""
        return dict(
            inner_kl_coeff=np.full((self.num_inner_grad_steps,),
                                   self.init_inner_kl_penalty, np.float32),
            clip_eps=np.float32(self.clip_eps),
        )

    def update_hparams(self, hparams, metrics):
        """Adaptive KL coefficient and clip-eps annealing."""
        hparams = dict(hparams)
        if self.adaptive_inner_kl_penalty:
            hparams["inner_kl_coeff"] = self.adapt_kl_coeff(
                hparams["inner_kl_coeff"], np.asarray(metrics["inner_kls"]),
                self.target_inner_step)
        if self.anneal_factor != 1.0:
            hparams["clip_eps"] = np.float32(
                hparams["clip_eps"] * self.anneal_factor)
        return hparams

    # -------------------------------------------------------- meta objective
    def meta_objective(self, params, step_sizes, all_data, inner_kl_coeff,
                       clip_eps):
        """Clipped surrogate + inner-KL penalty.

        Returns (loss, aux) with aux = {inner_kls (steps,), outer_kl}.
        """
        task_params, inner_kls = self.unrolled_adaptation(
            params, step_sizes, all_data)
        data = self._optimization_view(all_data[-1])

        def task_objective(p, d):
            dist = self.policy.apply(p, d["observations"], floor_std=False)
            lr = dg.likelihood_ratio(d["actions"], d["agent_infos"], dist)
            outer_kl = torch.mean(dg.kl(d["agent_infos"], dist))
            adv = d["advantages"]
            clipped = torch.minimum(
                lr * adv, torch.clamp(lr, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
            return -torch.mean(clipped), outer_kl

        surr_objs, outer_kls = vmap(task_objective)(task_params, data)
        inner_kls = torch.stack(inner_kls)
        loss = torch.mean(surr_objs) + torch.mean(inner_kl_coeff * inner_kls)
        return loss, dict(inner_kls=inner_kls, outer_kl=torch.mean(outer_kls))

    # ------------------------------------------------------------ outer step
    def optimize_policy(self, train_state, opt_state, all_data, hparams):
        """``num_ppo_steps`` Adam epochs on the meta-objective.

        ``train_state`` is {"params": ..., "step_sizes": ...}. Returns
        (train_state, opt_state, metrics) with 0-dim tensor metrics.
        """
        device = train_state["params"]["mean_network/output/bias"].device
        # the coefficients in the parameters' dtype (float64 in the
        # float64 mode)
        inner_kl_coeff = torch.as_tensor(
            hparams["inner_kl_coeff"],
            dtype=train_state["params"]["mean_network/output/bias"].dtype,
            device=device)
        clip_eps = float(hparams["clip_eps"])
        optimizer = self.make_optimizer()

        def loss_fn(ts):
            return self.meta_objective(ts["params"], ts["step_sizes"],
                                       all_data, inner_kl_coeff, clip_eps)

        grad_fn = grad_and_value(loss_fn, has_aux=True)
        halted = torch.zeros((), dtype=torch.bool, device=device)
        losses = []
        for _ in range(self.num_ppo_steps):
            grads, (loss, aux) = grad_fn(train_state)
            grads = self.mask_grads(grads)
            new_ts, new_os = optimizer.update(grads, opt_state, train_state)
            if self.outer_kl_limit > 0.0:
                # once the KL of the parameters going in exceeds the limit,
                # this and every later epoch keep the old state
                halted = halted | (aux["outer_kl"] > self.outer_kl_limit)
                new_ts, new_os = tree_map(
                    lambda n, o: torch.where(halted, o, n),
                    (new_ts, new_os), (train_state, opt_state))
            train_state, opt_state = new_ts, new_os
            losses.append(loss)

        loss_after, aux = loss_fn(train_state)
        metrics = dict(LossBefore=losses[0], LossAfter=loss_after,
                       KLInner=torch.mean(aux["inner_kls"]),
                       KLOuter=aux["outer_kl"],
                       inner_kls=aux["inner_kls"],
                       SkippedUpdates=opt_state.skipped)
        return train_state, opt_state, metrics

    # -------------------------------------------------- adaptive KL penalty
    @staticmethod
    def adapt_kl_coeff(kl_coeff, kl_values, kl_target):
        """x2 above 1.5*target, /2 below target/1.5."""
        kl_values = np.asarray(kl_values)
        kl_coeff = np.asarray(kl_coeff).copy()
        kl_coeff[kl_values < kl_target / 1.5] /= 2.0
        kl_coeff[kl_values > kl_target * 1.5] *= 2.0
        return kl_coeff
