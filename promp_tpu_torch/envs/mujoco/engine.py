"""Articulated rigid-body engine (port of promp_tpu/envs/mujoco/engine.py,
the ``Engine.step`` route of ``spatial_ok`` bodies).

``Engine.step`` advances a batch of env states by ``frame_skip`` MJCF
frames: it clips the control to the actuators' ranges, applies the gears
at the actuated dofs, and runs the chain of ``frame_skip * n_substeps``
implicit-Euler substeps as one call of K2, or of K3 when rand-params
physics mods are given (ops/substep_kernel.py): the CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor. A body that the spatial
substep does not cover (fluid, contact pairs, ground-skip spheres:
swimmer, sawyer) and a mod key that K3 does not take raise; the port has
no other route for them yet, and never falls back.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from promp_tpu_torch.envs.mujoco.model import ChainModel
from promp_tpu_torch.envs.mujoco.spatial import spatial_ok
from promp_tpu_torch.ops import substep_kernel


@dataclass(frozen=True)
class Engine:
    model: ChainModel
    n_substeps: int = 1
    contact_stiffness: float = 1.0e4
    contact_damping: float = 1.0e2
    contact_tangential_damping: float = 2.0e2
    limit_stiffness: float = 4.0e3
    limit_damping: float = 20.0
    # hard cap on joint velocities: keeps extreme-torque excursions finite
    # so a diverging env cannot poison a whole batch with NaNs
    max_qvel: float = 3.0e2
    # relative Tikhonov regularization of the implicit solve: a tiny
    # virtual armature ~1e-5 * mean diag(M) that keeps the float32 Cholesky
    # finite where the free-root Euler decomposition makes M singular
    solve_reg: float = 1.0e-5

    def _chain(self, n_steps, mod_keys=()):
        """K2's wrapper for ``n_steps`` substeps, or K3's for ``mod_keys``,
        built once an engine for each ``(n_steps, mod_keys)`` (the frozen
        dataclass caches it in its ``__dict__``)."""
        cache = self.__dict__.setdefault("_chain_cache", {})
        key = (n_steps, tuple(mod_keys))
        if key not in cache:
            cache[key] = substep_kernel.substep_chain(self, *key)
        return cache[key]

    def _actuator_consts(self, dtype, device):
        """(lo, hi, gear, act_dof) tensors on ``device``, made once a device
        and dtype (no host-to-device copy a step)."""
        cache = self.__dict__.setdefault("_actuator_cache", {})
        key = (dtype, device)
        if key not in cache:
            m = self.model
            kw = dict(dtype=dtype, device=device)
            cache[key] = (torch.as_tensor(m.act_ctrlrange[:, 0], **kw),
                          torch.as_tensor(m.act_ctrlrange[:, 1], **kw),
                          torch.as_tensor(m.act_gear, **kw),
                          torch.as_tensor(m.act_dof, device=device))
        return cache[key]

    def actuation(self, ctrl):
        """(..., nu) controls -> (..., nv) actuation torques: the control
        clipped to ``act_ctrlrange``, times the gear, added at ``act_dof``."""
        lo, hi, gear, act_dof = self._actuator_consts(ctrl.dtype, ctrl.device)
        tau = torch.zeros(ctrl.shape[:-1] + (self.model.nv,), dtype=ctrl.dtype,
                          device=ctrl.device)
        return tau.index_add_(-1, act_dof, gear * torch.clamp(ctrl, lo, hi))

    def step(self, q, qd, ctrl, frame_skip, mods=None):
        """Advance ``frame_skip`` MJCF frames (the env-visible dt). ``q``,
        ``qd``: (..., nv); ``ctrl``: (..., nu), any common batch shape.
        ``mods``: rand-params multipliers, a dict of tensors with that batch
        shape (or one that broadcasts to it) in front of each key's own axes
        (envs/mujoco/rand_params.py); packed anew each call."""
        m = self.model
        if not spatial_ok(m):
            raise NotImplementedError(
                f"Engine.step on '{m.name}': the model is not spatial_ok "
                "(fluid, contact pairs or ground-skip spheres), and the "
                "generic engine is not ported yet")
        n_steps = frame_skip * self.n_substeps
        # the keys in JAX's order (engine.py: tuple(sorted(mods)))
        mod_keys = () if mods is None else tuple(sorted(mods))
        try:
            chain = self._chain(n_steps, mod_keys)
        except NotImplementedError as e:
            raise NotImplementedError(f"Engine.step on '{m.name}': {e}") \
                from e
        tau = self.actuation(ctrl)
        shape = q.shape
        flat = lambda x: x.reshape(-1, m.nv).contiguous()
        args = [flat(q), flat(qd), flat(tau)]
        if mod_keys:
            args.append(substep_kernel.pack_mods(m, mod_keys, mods,
                                                 shape[:-1]))
        try:
            q2, qd2 = chain(*args)
        except RuntimeError as e:
            raise RuntimeError(f"Engine.step on '{m.name}': {e}") from e
        return q2.reshape(shape), qd2.reshape(shape)
