"""Conjugate-gradient trust-region optimizer (port of
promp_tpu/optimizers/trpo.py).

The decision logic is the JAX package's: CG on the constraint's
Hessian-vector products (``cg_iters`` iterations, stopping early once
r.r < ``residual_tol``), an initial step sqrt(2 delta / (d.Hd + 1e-8)),
backtracking ratios ``backtrack_ratio ** n`` for n < ``max_backtracks``,
acceptance at loss < loss_before and kl <= delta, and the step rejected
when the last candidate is NaN, not better or outside the region, or the
initial step is NaN, unless ``accept_violation``.

Hessian-vector products are exact by default: forward-over-reverse,
``torch.func.jvp`` of ``torch.func.grad`` of the constraint, which for
TRPO-MAML runs through the unrolled ``vmap(grad)`` inner step.
``hvp_approach="finite_difference"`` takes the central difference of the
constraint's gradient instead. The two loops run on the host: CG reads
r.r at each iteration, and the line search evaluates one candidate at a
time, reading its loss and KL, until one is accepted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.func import grad, grad_and_value, jvp

from promp_tpu_torch.policies.gaussian_mlp import (flatten_params,
                                                   unflatten_params)

HVP_APPROACHES = ("exact", "finite_difference")


def conjugate_gradients(f_Ax, b, cg_iters=10, residual_tol=1e-10):
    """Solves A x = b by CG, from x = 0; stops after ``cg_iters``
    iterations or once r.r < ``residual_tol`` (a NaN r.r stops it too)."""
    x = torch.zeros_like(b)
    r, p = b, b
    rdotr = torch.dot(b, b)
    for _ in range(cg_iters):
        if not bool(rdotr >= residual_tol):
            break
        z = f_Ax(p)
        v = rdotr / torch.dot(p, z)
        x = x + v * p
        r = r - v * z
        newrdotr = torch.dot(r, r)
        p = r + (newrdotr / rdotr) * p
        rdotr = newrdotr
    return x


@dataclass(frozen=True)
class FiniteDifferenceHvp:
    """Hessian-vector products by differences of the constraint's gradient
    at the parameters moved by +-eps x (or +eps x and 0)."""

    base_eps: float = 1e-5
    symmetric: bool = True

    def build_eval(self, constraint_fn, params, spec, reg_coeff):
        flat0, _ = flatten_params(params)
        grad_fn = grad(constraint_fn)

        def flat_grad(flat):
            return flatten_params(grad_fn(unflatten_params(flat, spec)))[0]

        def hvp(x):
            eps = self.base_eps
            plus = flat_grad(flat0 + eps * x)
            if self.symmetric:
                minus = flat_grad(flat0 - eps * x)
                return (plus - minus) / (2 * eps) + reg_coeff * x
            return (plus - flat_grad(flat0)) / eps + reg_coeff * x

        return hvp


@dataclass(frozen=True)
class ConjugateGradientOptimizer:
    cg_iters: int = 10
    reg_coeff: float = 0.0
    backtrack_ratio: float = 0.8
    max_backtracks: int = 15
    accept_violation: bool = False
    hvp_reg: float = 1e-5  # damping added to H for CG's stability
    hvp_approach: str = "exact"
    fd_base_eps: float = 1e-5

    def __post_init__(self):
        if self.hvp_approach not in HVP_APPROACHES:
            raise ValueError(f"hvp_approach must be one of {HVP_APPROACHES}, "
                             f"not {self.hvp_approach!r}")

    def _hvp(self, constraint_fn, params, spec):
        reg = self.reg_coeff + self.hvp_reg
        if self.hvp_approach == "finite_difference":
            return FiniteDifferenceHvp(base_eps=self.fd_base_eps).build_eval(
                constraint_fn, params, spec, reg)
        grad_fn = grad(constraint_fn)

        def hvp(x):
            vec = unflatten_params(x, spec)
            # the tangent in the primal's key order, as jvp requires
            _, hv = jvp(grad_fn, (params,), ({k: vec[k] for k in params},))
            return flatten_params(hv)[0] + reg * x

        return hvp

    def optimize(self, loss_and_constraint_fn, params, max_constraint_val):
        """One TRPO step.

        ``loss_and_constraint_fn`` maps a params dict to the scalars (loss,
        constraint); the gradient, the HVPs and each line-search candidate
        evaluate it once (the JAX package's ``loss_fn`` and
        ``constraint_fn`` are its two halves). Returns (new_params, info)
        with info's backtrack_iters, violated, loss_before, loss, kl and
        step_taken as 0-dim tensors.
        """
        loss_fn = lambda p: loss_and_constraint_fn(p)[0]  # noqa: E731
        constraint_fn = lambda p: loss_and_constraint_fn(p)[1]  # noqa: E731
        grads, loss_before = grad_and_value(loss_fn)(params)
        g, spec = flatten_params(grads)
        hvp = self._hvp(constraint_fn, params, spec)
        descent = conjugate_gradients(hvp, g, self.cg_iters)
        dHd = torch.dot(descent, hvp(descent))
        initial_step_size = torch.sqrt(
            2.0 * max_constraint_val / (dHd + 1e-8))
        initial_step = initial_step_size * descent
        prev_flat, _ = flatten_params(params)

        # compared as float32, as the JAX package's device-side tests do
        delta = torch.tensor(max_constraint_val, dtype=g.dtype).item()
        loss_before_h = float(loss_before)
        n = 0
        while True:
            ratio = self.backtrack_ratio ** n
            cand_flat = prev_flat - ratio * initial_step
            loss, kl = loss_and_constraint_fn(unflatten_params(cand_flat,
                                                               spec))
            n += 1
            loss_h, kl_h = float(loss), float(kl)
            accepted = loss_h < loss_before_h and kl_h <= delta
            if accepted or n >= self.max_backtracks:
                break

        violated = (math.isnan(loss_h) or math.isnan(kl_h)
                    or loss_h >= loss_before_h or kl_h >= delta)
        nan_init = bool(torch.isnan(initial_step_size))
        take_step = not nan_init and (not violated or self.accept_violation)
        new_flat = cand_flat if take_step else prev_flat
        as_tensor = lambda v: torch.tensor(v, device=g.device)  # noqa: E731
        info = dict(backtrack_iters=as_tensor(n - 1),
                    violated=as_tensor(violated), loss_before=loss_before,
                    loss=loss, kl=kl, step_taken=as_tensor(take_step))
        return unflatten_params(new_flat, spec), info
