"""VPG-MAML: a first-order-optimizer outer step on the REINFORCE
meta-objective (port of promp_tpu/algos/vpg_maml.py).

  * inner objective: likelihood-ratio or log-likelihood surrogate
  * outer objective: -E[log pi(a) * A] on the post-update distributions,
    averaged over tasks
  * optional E-MAML exploration term, per task
    -mean(adj_avg_rewards of the last round) * mean(log pi_theta(a_0)) on
    the pre-update round's actions under the floored pre-update forward,
    so that its gradient credits the pre-update policy
  * Adam for ``max_epochs`` full-batch epochs
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import grad_and_value, vmap

from promp_tpu_torch.algos.base import MAMLAlgo
from promp_tpu_torch.ops import distributions as dg
from promp_tpu_torch.optimizers.adam import Adam

INNER_TYPES = ("likelihood_ratio", "log_likelihood")


def stack_kls(kls):
    """The per-step inner KLs as one (steps,) tensor (empty with no inner
    step)."""
    return torch.stack(kls) if kls else torch.zeros((0,))


@dataclass(frozen=True)
class VPGMAML(MAMLAlgo):
    learning_rate: float = 1e-3
    inner_type: str = "likelihood_ratio"
    exploration: bool = False
    max_epochs: int = 1

    def __post_init__(self):
        if self.inner_type not in INNER_TYPES:
            raise ValueError(f"inner_type must be one of {INNER_TYPES}, "
                             f"not {self.inner_type!r}")

    def inner_objective(self, params, data, floor_std):
        if self.inner_type == "log_likelihood":
            return self.log_likelihood_objective(params, data, floor_std)
        return super().inner_objective(params, data, floor_std)

    def make_optimizer(self):
        return Adam(learning_rate=self.learning_rate)

    def init_opt_state(self, train_state):
        return self.make_optimizer().init(train_state)

    def meta_objective(self, params, step_sizes, all_data, hparams):
        """Returns (loss, aux) with aux = {inner_kls (steps,), outer_kl}."""
        task_params, inner_kls = self.unrolled_adaptation(
            params, step_sizes, all_data)
        data = self._optimization_view(all_data[-1])

        def task_objective(p, d):
            dist = self.policy.apply(p, d["observations"], floor_std=False)
            logli = dg.log_likelihood(d["actions"], dist)
            outer_kl = torch.mean(dg.kl(d["agent_infos"], dist))
            return -torch.mean(logli * d["advantages"]), outer_kl

        surr_objs, outer_kls = vmap(task_objective)(task_params, data)
        if self.exploration:
            surr_objs = surr_objs + self._exploration_term(params, all_data)
        return torch.mean(surr_objs), dict(inner_kls=stack_kls(inner_kls),
                                           outer_kl=torch.mean(outer_kls))

    def _exploration_term(self, params, all_data):
        """Per task, -mean(adj_avg_rewards of the last round) *
        mean(log pi_theta(a_0)), with the step-0 distributions from the
        current pre-update parameters (floored forward)."""
        data0 = all_data[0]
        adj = all_data[-1]["adj_avg_rewards"]  # (tasks, P, T)

        def per_task(obs0, act0, adj_n):
            dist0 = self.policy.apply(params, obs0, floor_std=True)
            logli0 = dg.log_likelihood(act0, dist0)
            return -torch.mean(adj_n) * torch.mean(logli0)

        return vmap(per_task)(data0["observations"], data0["actions"], adj)

    def optimize_policy(self, train_state, opt_state, all_data, hparams):
        """``max_epochs`` Adam epochs on the meta-objective; LossBefore is
        the first epoch's loss. Returns (train_state, opt_state, metrics)
        with 0-dim tensor metrics."""
        optimizer = self.make_optimizer()

        def loss_fn(ts):
            return self.meta_objective(ts["params"], ts["step_sizes"],
                                       all_data, hparams)

        grad_fn = grad_and_value(loss_fn, has_aux=True)
        losses = []
        for _ in range(self.max_epochs):
            grads, (loss, _) = grad_fn(train_state)
            train_state, opt_state = optimizer.update(
                self.mask_grads(grads), opt_state, train_state)
            losses.append(loss)
        loss_after, aux = loss_fn(train_state)
        metrics = dict(LossBefore=losses[0], LossAfter=loss_after,
                       KLInner=torch.mean(aux["inner_kls"]),
                       KLOuter=aux["outer_kl"],
                       inner_kls=aux["inner_kls"],
                       SkippedUpdates=opt_state.skipped)
        return train_state, opt_state, metrics
