"""Articulated rigid-body engine (port of promp_tpu/envs/mujoco/engine.py).

``Engine.step`` advances a batch of env states by ``frame_skip`` MJCF
frames: it clips the control to the actuators' ranges, applies the gears
at the actuated dofs, and runs ``frame_skip * n_substeps`` implicit-Euler
substeps by one of two routes, as the JAX ``Engine.step`` picks them:

  * a ``spatial_ok`` body, with no mods or with mod keys among the four
    that K3 takes: one call of K2, or of K3 when rand-params physics mods
    are given (ops/substep_kernel.py), the CUDA kernel on a CUDA tensor,
    its plain PyTorch version on a CPU tensor;
  * any other body (fluid: the swimmer; sphere-sphere pairs and
    ground-skip spheres: the Sawyer scenes) or mod key: the generic
    substep, a loop of ``substep`` calls in plain batched PyTorch on the
    tensors' own device (plain JAX in the reference, so no kernel). It
    reads only the mod keys ``body_mass``, ``body_inertia``,
    ``dof_damping`` and ``friction``, as JAX's ``_phys`` does.

No route falls back to another or to the CPU. The generic substep runs its
matrix products at full float32: on a CUDA tensor it turns TF32 off for
its duration (the JAX package pins ``Precision.HIGHEST`` there).

``fk``, the Jacobians, the mass matrix, the bias forces (``rnea_bias``),
the contact, pair, fluid and limit terms are plain batched PyTorch over
any leading batch shape: the loop over bodies and their joints is static,
as in JAX, and each takes the forward kinematics ``kin`` where the caller
already has them. The dtype of the state decides the arithmetic's: float64
states step in float64 on the generic route (K2 and K3 take float32 only).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from promp_tpu_torch.envs.mujoco.model import HINGE, SLIDE, ChainModel
from promp_tpu_torch.envs.mujoco.rotations import (
    cross, quat_from_axis_angle, quat_mul, quat_rotate, quat_to_mat)
from promp_tpu_torch.envs.mujoco.spatial import MOD_BASE_NDIM, spatial_ok
from promp_tpu_torch.ops import substep_kernel
from promp_tpu_torch.ops.smallsolve import (chol_solve_cols,
                                            chol_solve_unrolled)


@contextlib.contextmanager
def full_float32(device):
    """Full-precision float32 matrix products on ``device`` for the body
    of the ``with``: TF32 off on a CUDA device, restored after."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


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
        (envs/mujoco/rand_params.py); packed anew each call. A
        ``spatial_ok`` body whose mod keys are among K3's four takes K2 or
        K3, anything else the generic substep (``generic_step``)."""
        m = self.model
        n_steps = frame_skip * self.n_substeps
        # the keys in JAX's order (engine.py: tuple(sorted(mods)))
        mod_keys = () if mods is None else tuple(sorted(mods))
        if not spatial_ok(m) or not set(mod_keys) <= set(MOD_BASE_NDIM):
            return self.generic_step(q, qd, ctrl, frame_skip, mods)
        chain = self._chain(n_steps, mod_keys)
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
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
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
        # cone-aware tangential coefficient: c_t inside the cone,
        # mu fn / |vt| once saturated
        ct_eff = torch.minimum(
            torch.full_like(fn, self.contact_tangential_damping),
            self._friction(mods) * fn / vt_norm) * in_contact
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

    # ------------------------------------------------------- generic engine
    generic_substeps = 0   # generic substeps run, over every engine

    def _generic_consts(self, dtype, device):
        """The model arrays of the generic substep as tensors on
        ``device``, made once a device and dtype."""
        cache = self.__dict__.setdefault("_generic_cache", {})
        key = (dtype, device)
        if key not in cache:
            m = self.model
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                          dtype=dtype, device=device)
            c = self.consts(dtype, device)
            jr = np.asarray(m.jnt_range, np.float64)
            anc = m.ancestor_mask()
            con_body = np.asarray(m.con_body, np.int64)
            ia, ib = np.asarray(m.pair_a, np.int64), np.asarray(m.pair_b,
                                                                np.int64)
            cache[key] = dict(
                R_i=quat_to_mat(c["body_iquat"]),
                armature=torch.diag(t(m.dof_armature)),
                damping=t(m.dof_damping), stiffness=t(m.jnt_stiffness),
                springref=t(m.jnt_springref),
                lim_lo=t(jr[:, 0]), lim_hi=t(jr[:, 1]),
                limited=t(np.abs(jr).sum(1) > 0),
                dof_anc=t(m.dof_ancestor_strict()),
                body_anc_t=t(anc.T),
                base_acc=t([0.0, 0.0, 0.0, 0.0, 0.0, m.gravity]),
                eye_nv=torch.eye(m.nv, dtype=dtype, device=device),
                eye3=torch.eye(3, dtype=dtype, device=device),
                h=torch.tensor(m.timestep / self.n_substeps, dtype=dtype,
                               device=device),
                pair_a=torch.as_tensor(ia, device=device),
                pair_b=torch.as_tensor(ib, device=device),
                pair_anc_a=t(anc[con_body[ia]].reshape(-1, m.nv)),
                pair_anc_b=t(anc[con_body[ib]].reshape(-1, m.nv)))
        return cache[key]

    def _inertia_world(self, kin, mods):
        """(mass (..., nb), the rotation of each body's inertial frame in
        the world R (..., nb, 3, 3), the world inertia about each COM
        R diag(I) R^T (..., nb, 3, 3))."""
        c = self.consts(kin["com"].dtype, kin["com"].device)
        g = self._generic_consts(kin["com"].dtype, kin["com"].device)
        mass = self._phys(mods, "body_mass", c["body_mass"])
        R = quat_to_mat(kin["body_quat"]) @ g["R_i"]
        inertia = self._phys(mods, "body_inertia", c["body_inertia"])
        I_world = R @ (inertia[..., None] * R.transpose(-1, -2))
        return mass, R, inertia, I_world

    def _mass_from_kin(self, kin, mods=None):
        """The joint-space mass matrix (..., nv, nv) from the kinematics:
        sum_b m_b Jp_b^T Jp_b + Jr_b^T I_b Jr_b, plus the armature."""
        g = self._generic_consts(kin["com"].dtype, kin["com"].device)
        Jp, Jr = self._body_jacobians(kin)
        mass, _, _, I_world = self._inertia_world(kin, mods)
        M = (torch.einsum("...biv,...biw->...vw",
                          Jp * mass[..., :, None, None], Jp)
             + torch.einsum("...biv,...biw->...vw", Jr, I_world @ Jr))
        return M + g["armature"]

    def mass_matrix(self, q, mods=None):
        return self._mass_from_kin(self.fk(q), mods)

    def gravity_torque(self, q, mods=None):
        """The generalized gravity force -dV/dq, V = -sum_b m_b g com_b,z,
        by autograd through ``fk`` (as JAX takes its gradient)."""
        c = self.consts(q.dtype, q.device)
        mass = self._phys(mods, "body_mass", c["body_mass"])
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            potential = -torch.sum(mass * self.model.gravity
                                   * self.fk(qq)["com"][..., 2])
            return -torch.autograd.grad(potential, qq)[0]

    def _bias_torque(self, q, qd, mods=None):
        """Coriolis and centrifugal forces -(Mdot qd) + 1/2 d/dq (qd^T M
        qd), by autodiff of the mass matrix: the independent oracle of
        ``rnea_bias`` (rnea_bias == -(_bias_torque + gravity_torque)).
        Reverse mode only: Mdot qd = d(M qd)/dq qd is the vjp, along qd,
        of the (linear) vjp of q -> M(q) qd."""
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            M = self.mass_matrix(qq, mods)
            Mqd = (M @ qd[..., None])[..., 0]
            u = torch.zeros_like(Mqd, requires_grad=True)
            (vjp,) = torch.autograd.grad(Mqd, qq, u, create_graph=True)
            (Mdot_qd,) = torch.autograd.grad(vjp, u, qd, retain_graph=True)
            quad = torch.autograd.grad(
                torch.sum(0.5 * torch.sum(Mqd * qd, dim=-1)), qq)[0]
        return -Mdot_qd + quad

    def rnea_bias(self, q, qd, mods=None, kin=None):
        """Bias forces C(q, qd) qd + g(q), MuJoCo's qfrc_bias, by a
        recursive-Newton-Euler velocity pass (qdd = 0, gravity folded in as
        a base acceleration), in world-aligned Pluecker coordinates
        re-centred at the root body. M qdd = tau_applied - bias."""
        c = self.consts(q.dtype, q.device)
        g = self._generic_consts(q.dtype, q.device)
        if kin is None:
            kin = self.fk(q)
        origin = kin["body_pos"][..., :1, :]
        anchor = kin["dof_anchor"] - origin            # (..., nv, 3)
        com = kin["com"] - origin                      # (..., nb, 3)
        axis = kin["dof_axis"]
        hinge = c["is_hinge"][:, None]

        # motion subspace S_j = (w, v_O): hinge (a, p x a), slide (0, a)
        Sw = axis * hinge
        Sv = torch.where(hinge > 0.0, cross(anchor, axis), axis)
        S = torch.cat([Sw, Sv], dim=-1)                # (..., nv, 6)
        Sqd = S * qd[..., None]

        def cross_motion(V, U):
            w1, v1 = V[..., :3], V[..., 3:]
            w2, v2 = U[..., :3], U[..., 3:]
            return torch.cat([cross(w1, w2),
                              cross(w1, v2) + cross(v1, w2)], dim=-1)

        def cross_force(V, F):
            w, v = V[..., :3], V[..., 3:]
            n, f = F[..., :3], F[..., 3:]
            return torch.cat([cross(w, n) + cross(v, f), cross(w, f)],
                             dim=-1)

        # Sdot_j = V_parent(j) x_m S_j (S is fixed in its parent frame)
        Vminus = g["dof_anc"] @ Sqd                    # (..., nv, 6)
        Sdot_qd = cross_motion(Vminus, S) * qd[..., None]
        body_anc = c["ancestor"]
        Vb = body_anc @ Sqd                            # (..., nb, 6)
        # gravity trick: base acceleration -a_g = (0, (0, 0, -gravity))
        Ab = body_anc @ Sdot_qd - g["base_acc"]

        mass, _, _, I_c = self._inertia_world(kin, mods)

        def inertia_apply(V):
            w, v = V[..., :3], V[..., 3:]
            f = mass[..., None] * (v + cross(w, com))
            n = (I_c @ w[..., None])[..., 0] + cross(com, f)
            return torch.cat([n, f], dim=-1)

        Fb = inertia_apply(Ab) + cross_force(Vb, inertia_apply(Vb))
        # tau_j = S_j . sum over the bodies of j's subtree of F_b
        return torch.sum(S * (g["body_anc_t"] @ Fb), dim=-1)

    def fluid_torque(self, q, qd, mods=None, kin=None):
        """MuJoCo's inertia-box fluid model (the swimmer's medium): per
        body an equivalent box from the diagonal inertia, velocities in the
        body's inertial frame at the COM, viscous drag (F = -3 pi d mu v,
        T = -pi d^3 mu w, d the box's mean side) and quadratic density drag
        per local axis; massless bodies are skipped."""
        m = self.model
        if m.density == 0.0 and m.viscosity == 0.0:
            return torch.zeros_like(q)
        c = self.consts(q.dtype, q.device)
        if kin is None:
            kin = self.fk(q)
        Jp, Jr = self._body_jacobians(kin)
        qdv = qd[..., None, :, None]
        v = (Jp @ qdv)[..., 0]                         # (..., nb, 3)
        w = (Jr @ qdv)[..., 0]
        mass, R, inertia, _ = self._inertia_world(kin, mods)
        # velocities in the local (inertial) frame: R^T v
        Rt = R.transpose(-1, -2)
        lv = (Rt @ v[..., None])[..., 0]
        lw = (Rt @ w[..., None])[..., 0]
        valid = (mass > 1e-12).to(q.dtype)[..., None]
        safe_mass = torch.clamp_min(mass, 1e-12)[..., None]
        diff = torch.sum(inertia, -1, keepdim=True) - 2.0 * inertia
        box = torch.sqrt(torch.clamp_min(diff, 1e-15) / safe_mass * 6.0)
        lfrc_lin = torch.zeros_like(lv)
        lfrc_ang = torch.zeros_like(lw)
        if m.viscosity > 0.0:
            diam = torch.mean(box, -1, keepdim=True)
            lfrc_ang = lfrc_ang - np.pi * diam ** 3 * m.viscosity * lw
            lfrc_lin = lfrc_lin - 3.0 * np.pi * diam * m.viscosity * lv
        if m.density > 0.0:
            box1 = torch.roll(box, -1, dims=-1)         # box[(i+1)%3]
            box2 = torch.roll(box, -2, dims=-1)         # box[(i+2)%3]
            lfrc_lin = lfrc_lin - (0.5 * m.density * box1 * box2
                                   * torch.abs(lv) * lv)
            lfrc_ang = lfrc_ang - (m.density * box * (box1 ** 4 + box2 ** 4)
                                   / 64.0 * torch.abs(lw) * lw)
        force = (R @ lfrc_lin[..., None])[..., 0] * valid
        torque = (R @ lfrc_ang[..., None])[..., 0] * valid
        return (torch.einsum("...biv,...bi->...v", Jp, force)
                + torch.einsum("...biv,...bi->...v", Jr, torque))

    def _friction(self, mods):
        """The friction coefficient, times the task's multiplier where
        given, broadcastable against per-contact (..., nc) tensors."""
        friction = self._phys(mods, "friction", float(self.model.friction))
        if torch.is_tensor(friction) and friction.dim():
            friction = friction[..., None]
        return friction

    def _pair_terms(self, q, qd, mods=None, kin=None):
        """Sphere-sphere contact pairs (the manipulation scenes): the
        ground contact's penalty spring-damper and cone-clamped friction
        along the centre line of the two spheres. Returns (tau (..., nv),
        J_rel (..., npair, 3, nv) = J_a - J_b, C (..., npair, 3, 3), K
        (..., npair, 3, 3)), the implicit coefficients split as C = ct (I -
        nn^T) + cn nn^T and K = kn nn^T."""
        c = self.consts(q.dtype, q.device)
        g = self._generic_consts(q.dtype, q.device)
        if kin is None:
            kin = self.fk(q)
        ia, ib = g["pair_a"], g["pair_b"]
        points = self._contact_points(kin)
        pa, pb = points[..., ia, :], points[..., ib, :]
        J = (self._point_jacobian(kin, pa, g["pair_anc_a"])
             - self._point_jacobian(kin, pb, g["pair_anc_b"]))
        d = pa - pb
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
        n = d / dist[..., None]
        radius = c["con_radius"]
        phi = dist - (radius[ia] + radius[ib])
        in_contact = (phi < 0.0).to(q.dtype)
        vel = (J @ qd[..., None, :, None])[..., 0]     # (..., npair, 3)
        vn = torch.sum(vel * n, dim=-1)
        fn = (self.contact_stiffness * (-phi)
              - self.contact_damping * vn)
        fn = torch.clamp_min(fn, 0.0) * in_contact
        vt = vel - vn[..., None] * n
        vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-8)
        ct_eff = torch.minimum(
            torch.full_like(fn, self.contact_tangential_damping),
            self._friction(mods) * fn / vt_norm) * in_contact
        force = fn[..., None] * n - ct_eff[..., None] * vt   # on sphere a
        tau = torch.einsum("...civ,...ci->...v", J, force)
        active = in_contact * (fn > 0.0).to(q.dtype)
        nn = n[..., :, None] * n[..., None, :]
        C = (ct_eff[..., None, None] * (g["eye3"] - nn)
             + (self.contact_damping * active)[..., None, None] * nn)
        K = (self.contact_stiffness * active)[..., None, None] * nn
        return tau, J, C, K

    def _limit_terms(self, q, qd):
        """Joint-limit penalty torque and the per-dof implicit (c, k)
        active at this state (diagonal in dof space)."""
        g = self._generic_consts(q.dtype, q.device)
        below = torch.clamp_max(q - g["lim_lo"], 0.0)
        above = torch.clamp_min(q - g["lim_hi"], 0.0)
        viol = below + above
        active = (torch.abs(viol) > 0).to(q.dtype) * g["limited"]
        tau = (-self.limit_stiffness * viol * g["limited"]
               - self.limit_damping * qd * active)
        return tau, self.limit_damping * active, self.limit_stiffness * active

    def substep(self, q, qd, tau_act, h, mods=None):
        """One semi-implicit Euler substep of (..., nv) states: the
        kinematics once, shared by the mass matrix, the RNEA bias, fluid,
        ground contacts and pairs; joint damping, springs, active limits
        and the contact spring-dampers integrate implicitly through the
        (M + hC + h^2 K) solve, Tikhonov-regularized by ``solve_reg``
        times the mean of diag(M); the velocities are clipped to
        ``max_qvel``. ``h``: the substep, a 0-dim tensor of the state's
        dtype."""
        m = self.model
        g = self._generic_consts(q.dtype, q.device)
        damping = self._phys(mods, "dof_damping", g["damping"])
        stiffness, springref = g["stiffness"], g["springref"]

        kin = self.fk(q)
        M = self._mass_from_kin(kin, mods)
        tau_lim, c_lim, k_lim = self._limit_terms(q, qd)
        tau = (tau_act
               - self.rnea_bias(q, qd, mods, kin=kin)
               + self.fluid_torque(q, qd, mods, kin=kin)
               + tau_lim
               - stiffness * (q - springref)
               - damping * qd)
        # diagonal implicit terms: joint damping (MuJoCo's Euler), joint
        # springs, active limit spring-dampers
        diag_cd = (h * (damping + c_lim)
                   + h * h * (k_lim + stiffness))
        # the RHS mate of the h^2 K term of the implicit stiffness forces
        tau = tau - h * (k_lim + stiffness) * qd
        A_con = 0.0
        if len(m.con_body):
            tau_c, _, J, cn, ct, kn = self._contact_terms(q, qd, mods, kin)
            tau = tau + tau_c
            # implicit contact spring-dampers: h J^T C J + h^2 Jn^T K Jn
            coef = torch.stack([h * ct, h * ct, h * cn + h * h * kn], dim=-1)
            A_con = torch.einsum("...civ,...ciw->...vw",
                                 J * coef[..., None], J)
            Jz = J[..., 2, :]                            # (..., nc, nv)
            vz = (Jz @ qd[..., None])[..., 0]
            tau = tau - h * torch.einsum("...cv,...c->...v", Jz, kn * vz)
        if len(m.pair_a):
            tau_p, Jp_, Cp, Kp = self._pair_terms(q, qd, mods, kin)
            tau = tau + tau_p
            A_con = A_con + torch.einsum("...civ,...ciw->...vw", Jp_,
                                         (h * Cp + h * h * Kp) @ Jp_)
            KJqd = Kp @ (Jp_ @ qd[..., None, :, None])   # (..., np, 3, 1)
            tau = tau - h * torch.einsum("...civ,...ci->...v", Jp_,
                                         KJqd[..., 0])
        reg = self.solve_reg * (torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
                                / m.nv)
        # SPD up to the gimbal-lock singularity of Euler free roots, where
        # the scale-aware Tikhonov term keeps the Cholesky finite
        A = (M + torch.diag_embed(diag_cd) + A_con
             + reg[..., None, None] * g["eye_nv"])
        if m.nv <= 16:
            qdd = chol_solve_unrolled(A, tau)
        else:
            qdd = chol_solve_cols(A, tau)
        qd_new = torch.clamp(qd + h * qdd, -self.max_qvel, self.max_qvel)
        return q + h * qd_new, qd_new

    def generic_chain(self, q, qd, tau, n_steps, mods=None):
        """``n_steps`` calls of ``substep`` from (..., nv) states under
        the actuation ``tau``, on the tensors' device and in their dtype,
        counted in ``Engine.generic_substeps``: the generic route's
        counterpart of one K2/K3 call."""
        h = self._generic_consts(q.dtype, q.device)["h"]
        with full_float32(q.device):
            for _ in range(n_steps):
                q, qd = self.substep(q, qd, tau, h, mods)
        Engine.generic_substeps += n_steps
        return q, qd

    def generic_step(self, q, qd, ctrl, frame_skip, mods=None):
        """``step`` by the generic route, for any body and mod keys."""
        return self.generic_chain(q, qd, self.actuation(ctrl),
                                  frame_skip * self.n_substeps, mods)
