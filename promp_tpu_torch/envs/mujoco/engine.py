"""Articulated rigid-body engine (port of promp_tpu/envs/mujoco/engine.py,
the ``Engine.step`` route of ``spatial_ok`` bodies).

``Engine.step`` advances a batch of env states by ``frame_skip`` MJCF
frames: it clips the control to the actuators' ranges, applies the gears
at the actuated dofs, and runs the chain of ``frame_skip * n_substeps``
implicit-Euler substeps as one call of K2 (ops/substep_kernel.py): the
CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.
A body that the spatial substep does not cover (fluid, contact pairs,
ground-skip spheres: swimmer, sawyer) and rand-params physics mods raise;
the port has no other route for them yet, and never falls back.
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

    def _chain(self, n_steps):
        """K2's wrapper for ``n_steps`` substeps, built once an engine (the
        frozen dataclass caches it in its ``__dict__``)."""
        cache = self.__dict__.setdefault("_chain_cache", {})
        if n_steps not in cache:
            cache[n_steps] = substep_kernel.substep_chain(self, n_steps)
        return cache[n_steps]

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
        ``qd``: (..., nv); ``ctrl``: (..., nu), any common batch shape."""
        m = self.model
        if mods is not None:
            raise NotImplementedError(
                f"Engine.step on '{m.name}': rand-params physics mods "
                f"{sorted(mods)} are not ported yet (the K2 chain with mods, "
                "K3)")
        if not spatial_ok(m):
            raise NotImplementedError(
                f"Engine.step on '{m.name}': the model is not spatial_ok "
                "(fluid, contact pairs or ground-skip spheres), and the "
                "generic engine is not ported yet")
        tau = self.actuation(ctrl)
        shape = q.shape
        flat = lambda x: x.reshape(-1, m.nv).contiguous()
        chain = self._chain(frame_skip * self.n_substeps)
        try:
            q2, qd2 = chain(flat(q), flat(qd), flat(tau))
        except RuntimeError as e:
            raise RuntimeError(f"Engine.step on '{m.name}': {e}") from e
        return q2.reshape(shape), qd2.reshape(shape)
