"""Articulated rigid-body engine (port of promp_tpu/envs/mujoco/engine.py:
the ``Engine.step`` route of ``spatial_ok`` bodies, and the kinematics,
body Jacobians, body velocities and ground-contact forces that the ant and
humanoid observations read).

``Engine.step`` advances a batch of env states by ``frame_skip`` MJCF
frames: it clips the control to the actuators' ranges, applies the gears
at the actuated dofs, and runs the chain of ``frame_skip * n_substeps``
implicit-Euler substeps as one call of K2, or of K3 when rand-params
physics mods are given (ops/substep_kernel.py): the CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor. A body that the spatial
substep does not cover (fluid, contact pairs, ground-skip spheres:
swimmer, sawyer) and a mod key that K3 does not take raise; the port has
no other route for them yet, and never falls back.

``fk``, ``body_velocities``, ``_contact_terms``, ``contact_torque`` and
``contact_wrench`` are plain batched PyTorch over any leading batch shape
(plain JAX in the reference, so no kernel): the loop over bodies and their
joints is static, as in JAX, and each takes the forward kinematics ``kin``
where the caller already has them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from promp_tpu_torch.envs.mujoco.model import HINGE, SLIDE, ChainModel
from promp_tpu_torch.envs.mujoco.rotations import (
    cross, quat_from_axis_angle, quat_mul, quat_rotate)
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

    # ------------------------------------------------------------ kinematics
    def consts(self, dtype, device):
        """The model arrays that the kinematics read, as tensors on
        ``device``, made once a device and dtype."""
        cache = self.__dict__.setdefault("_kin_cache", {})
        key = (dtype, device)
        if key not in cache:
            m = self.model
            t = lambda a: torch.as_tensor(np.array(a, np.float32),
                                          dtype=dtype, device=device)
            anc = m.ancestor_mask()
            cache[key] = dict(
                body_pos=t(m.body_pos), body_quat=t(m.body_quat),
                body_ipos=t(m.body_ipos), body_iquat=t(m.body_iquat),
                body_mass=t(m.body_mass), body_inertia=t(m.body_inertia),
                jnt_axis=t(m.jnt_axis), jnt_pos=t(m.jnt_pos),
                is_hinge=t([1.0 if k == HINGE else 0.0
                            for k in m.jnt_type]),
                ancestor=t(anc),
                con_ancestor=t(anc[list(m.con_body)].reshape(-1, m.nv)),
                con_body=torch.as_tensor(m.con_body, dtype=torch.long,
                                         device=device),
                con_pos=t(m.con_pos), con_radius=t(m.con_radius),
                con_skip=t(m.con_skip_ground) if len(m.con_skip_ground)
                else None,
                unit_quat=t([1.0, 0.0, 0.0, 0.0]))
        return cache[key]

    def fk(self, q):
        """Forward kinematics of (..., nv) coordinates: a dict of the body
        world frames and the dofs' world axes and anchors, ``body_pos``
        (..., nb, 3), ``body_quat`` (..., nb, 4), ``com`` (..., nb, 3),
        ``dof_axis`` (..., nv, 3) and ``dof_anchor`` (..., nv, 3)."""
        m = self.model
        c = self.consts(q.dtype, q.device)
        batch = q.shape[:-1]
        dofs_of_body = [[] for _ in range(m.nb)]
        for j, b in enumerate(m.jnt_body):
            dofs_of_body[b].append(j)
        body_pos, body_quat = [], []
        dof_axis, dof_anchor = [None] * m.nv, [None] * m.nv
        for b in range(m.nb):
            parent = m.body_parent[b]
            if parent < 0:
                p = torch.zeros(3, dtype=q.dtype, device=q.device)
                r = c["unit_quat"]
            else:
                p, r = body_pos[parent], body_quat[parent]
            # fixed offset from the parent
            p = p + quat_rotate(r, c["body_pos"][b])
            r = quat_mul(r, c["body_quat"][b])
            # the body's joints, applied in order
            for j in dofs_of_body[b]:
                axis_local = c["jnt_axis"][j]
                axis_w = quat_rotate(r, axis_local)
                anchor_w = p + quat_rotate(r, c["jnt_pos"][j])
                dof_axis[j], dof_anchor[j] = axis_w, anchor_w
                angle = q[..., j] - float(m.jnt_ref[j])
                if m.jnt_type[j] == SLIDE:
                    # MuJoCo displaces by (qpos - ref)
                    p = p + axis_w * angle[..., None]
                else:
                    # rotate the frame about the axis through the anchor:
                    # the origin relative to the anchor, expressed in the
                    # pre-rotation frame, re-expressed through the new one
                    r_new = quat_mul(r, quat_from_axis_angle(axis_local,
                                                             angle))
                    rel_local = quat_rotate(
                        torch.cat([r[..., :1], -r[..., 1:]], dim=-1),
                        p - anchor_w)
                    p = anchor_w + quat_rotate(r_new, rel_local)
                    r = r_new
            body_pos.append(p)
            body_quat.append(r)

        def stack(xs, width):
            return torch.stack([x.expand(batch + (width,)) for x in xs], -2)

        body_pos, body_quat = stack(body_pos, 3), stack(body_quat, 4)
        com = body_pos + quat_rotate(body_quat, c["body_ipos"])
        return dict(body_pos=body_pos, body_quat=body_quat, com=com,
                    dof_axis=stack(dof_axis, 3),
                    dof_anchor=stack(dof_anchor, 3))

    # ------------------------------------------------------------ jacobians
    def _point_jacobian(self, kin, points, ancestor):
        """Translational Jacobian of world points attached to bodies:
        ``points`` (..., np, 3), ``ancestor`` the (np, nv) mask of the dofs
        that move each point's body. Returns (..., np, 3, nv)."""
        c = self.consts(points.dtype, points.device)
        axis = kin["dof_axis"][..., None, :, :]          # (..., 1, nv, 3)
        rel = points[..., :, None, :] - kin["dof_anchor"][..., None, :, :]
        # hinge columns: w x (p - a); slide columns: w
        hinge = c["is_hinge"][:, None]
        cols = hinge * cross(axis, rel) + (1 - hinge) * axis
        cols = cols * ancestor[:, :, None]
        return cols.transpose(-1, -2)

    def _body_jacobians(self, kin):
        """(Jp, Jr) of the body COMs, (..., nb, 3, nv) each."""
        c = self.consts(kin["com"].dtype, kin["com"].device)
        Jp = self._point_jacobian(kin, kin["com"], c["ancestor"])
        Jr_cols = (kin["dof_axis"][..., None, :, :]
                   * c["is_hinge"][:, None] * c["ancestor"][:, :, None])
        return Jp, Jr_cols.transpose(-1, -2)

    def body_velocities(self, q, qd, kin=None):
        """Per-body COM velocities (v, w), (..., nb, 3) each: the analog of
        MuJoCo's cvel (humanoid observations)."""
        if kin is None:
            kin = self.fk(q)
        Jp, Jr = self._body_jacobians(kin)
        qd = qd[..., None, :, None]
        return (Jp @ qd)[..., 0], (Jr @ qd)[..., 0]

    # ----------------------------------------------------- physics overrides
    def _phys(self, mods, name, default):
        """A physics array (a tensor from ``consts``, or a float) times the
        task's multipliers ``mods[name]`` where given (the rand-params
        envs); the multipliers bring their batch shape in front."""
        if mods and name in mods:
            return default * mods[name]
        return default

    # -------------------------------------------------------------- contact
    def _contact_points(self, kin):
        """World centres of the contact spheres, (..., nc, 3)."""
        c = self.consts(kin["com"].dtype, kin["com"].device)
        body_idx = c["con_body"]
        return (kin["body_pos"][..., body_idx, :]
                + quat_rotate(kin["body_quat"][..., body_idx, :],
                              c["con_pos"]))

    def _contact_terms(self, q, qd, mods=None, kin=None):
        """Ground-contact forces and the implicit-solve coefficients:
        ``(tau, force, J, cn_eff, ct_eff, kn_eff)``, with ``tau`` (..., nv)
        the generalized contact force, ``force`` (..., nc, 3) each
        sphere's (tangential x, y, normal) force, ``J`` (..., nc, 3, nv)
        the contact points' Jacobian and the per-contact normal damping,
        tangential damping and normal stiffness active at this state
        (..., nc). (JAX ``Engine._contact_terms``.)"""
        m = self.model
        c = self.consts(q.dtype, q.device)
        if kin is None:
            kin = self.fk(q)
        points = self._contact_points(kin)
        J = self._point_jacobian(kin, points, c["con_ancestor"])
        vel = (J @ qd[..., None, :, None])[..., 0]              # (..., nc, 3)
        phi = points[..., 2] - c["con_radius"]                  # penetration
        in_contact = (phi < 0.0).to(q.dtype)
        if c["con_skip"] is not None:
            in_contact = in_contact * (1.0 - c["con_skip"])
        fn = (self.contact_stiffness * (-phi)
              - self.contact_damping * vel[..., 2])
        fn = torch.clamp_min(fn, 0.0) * in_contact
        vt = vel[..., :2]
        vt_norm = torch.sqrt(torch.sum(vt ** 2, dim=-1) + 1e-8)
        friction = self._phys(mods, "friction", float(m.friction))
        if torch.is_tensor(friction) and friction.dim():
            friction = friction[..., None]
        # cone-aware tangential coefficient: c_t inside the cone,
        # mu fn / |vt| once saturated
        ct_eff = torch.minimum(
            torch.full_like(fn, self.contact_tangential_damping),
            friction * fn / vt_norm) * in_contact
        ft = -ct_eff[..., None] * vt
        force = torch.cat([ft, fn[..., None]], dim=-1)
        tau = torch.einsum("...civ,...ci->...v", J, force)
        active_n = in_contact * (fn > 0.0).to(q.dtype)
        cn_eff = self.contact_damping * active_n
        kn_eff = self.contact_stiffness * active_n
        return tau, force, J, cn_eff, ct_eff, kn_eff

    def contact_torque(self, q, qd, mods=None, kin=None):
        """(tau (..., nv), force (..., nc, 3)) of the ground contacts."""
        if len(self.model.con_body) == 0:
            return (torch.zeros_like(q),
                    q.new_zeros(q.shape[:-1] + (0, 3)))
        return self._contact_terms(q, qd, mods, kin)[:2]

    def contact_wrench(self, q, qd, mods=None, kin=None):
        """The contact forces summed per body, (..., nb, 6) rows of
        [torque about the body's COM, force]: the analog of MuJoCo's
        cfrc_ext (ant and humanoid observations)."""
        m = self.model
        wrench = q.new_zeros(q.shape[:-1] + (m.nb, 6))
        if len(m.con_body) == 0:
            return wrench
        if kin is None:
            kin = self.fk(q)
        body_idx = self.consts(q.dtype, q.device)["con_body"]
        points = self._contact_points(kin)
        _, force = self.contact_torque(q, qd, mods, kin)
        torque = cross(points - kin["com"][..., body_idx, :], force)
        return wrench.index_add_(-2, body_idx,
                                 torch.cat([torque, force], dim=-1))
