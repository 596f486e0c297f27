"""TRPO-MAML and E-MAML: a trust-region outer step on the meta-objective
(port of promp_tpu/algos/trpo_maml.py).

  * inner objective: likelihood-ratio or log-likelihood surrogate
  * outer objective: the surrogate -E[LR * A] on the post-update
    distributions, averaged over tasks, plus the E-MAML exploration term
    with ``exploration=True``
  * constraint: the mean outer KL <= ``step_size``, by conjugate gradients
    and a backtracking line search (optimizers/trpo.py)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import vmap

from promp_tpu_torch.algos.vpg_maml import VPGMAML, stack_kls
from promp_tpu_torch.ops import distributions as dg
from promp_tpu_torch.optimizers.trpo import ConjugateGradientOptimizer


@dataclass(frozen=True)
class TRPOMAML(VPGMAML):
    step_size: float = 0.01
    cg_iters: int = 10
    reg_coeff: float = 0.0
    backtrack_ratio: float = 0.8
    max_backtracks: int = 15

    def make_optimizer(self):
        return ConjugateGradientOptimizer(
            cg_iters=self.cg_iters, reg_coeff=self.reg_coeff,
            backtrack_ratio=self.backtrack_ratio,
            max_backtracks=self.max_backtracks)

    def init_opt_state(self, train_state):
        return ()

    def surrogate_and_kl(self, params, step_sizes, all_data):
        """(meta surrogate loss, mean outer KL, inner KLs (steps,))."""
        task_params, inner_kls = self.unrolled_adaptation(
            params, step_sizes, all_data)
        data = self._optimization_view(all_data[-1])

        def task_objective(p, d):
            dist = self.policy.apply(p, d["observations"], floor_std=False)
            lr = dg.likelihood_ratio(d["actions"], d["agent_infos"], dist)
            outer_kl = torch.mean(dg.kl(d["agent_infos"], dist))
            return -torch.mean(lr * d["advantages"]), outer_kl

        surr_objs, outer_kls = vmap(task_objective)(task_params, data)
        if self.exploration:
            surr_objs = surr_objs + self._exploration_term(params, all_data)
        return (torch.mean(surr_objs), torch.mean(outer_kls),
                stack_kls(inner_kls))

    def optimize_policy(self, train_state, opt_state, all_data, hparams):
        """The TRPO outer step. Only the policy parameters move; the step
        sizes stay fixed."""
        step_sizes = train_state["step_sizes"]

        def loss_and_kl(params):
            loss, kl, _ = self.surrogate_and_kl(params, step_sizes, all_data)
            return loss, kl

        params = train_state["params"]
        kl_before = loss_and_kl(params)[1]
        new_params, info = self.make_optimizer().optimize(
            loss_and_kl, params, self.step_size)
        _, _, inner_kls = self.surrogate_and_kl(new_params, step_sizes,
                                                all_data)
        metrics = dict(
            LossBefore=info["loss_before"], LossAfter=info["loss"],
            MeanKLBefore=kl_before, MeanKL=info["kl"],
            dLoss=info["loss_before"] - info["loss"],
            KLInner=torch.mean(inner_kls), inner_kls=inner_kls,
            BacktrackIters=info["backtrack_iters"],
            StepRejected=~info["step_taken"],
        )
        return dict(train_state, params=new_params), opt_state, metrics
