"""Humanoid meta-envs, a 3-D biped with its free root decomposed to 6 dofs
(port of promp_tpu/envs/mujoco/humanoid.py).

The observation blocks follow MuJoCo's layout: qpos[2:], qvel, cinert,
cvel, qfrc_actuator, cfrc_ext, with the engine's analogs of the COM-based
quantities: cinert -> per body [I_world upper triangle (6), m com (3),
m (1)], cvel -> per body [w, v], cfrc_ext -> the contact wrench; each
with a zero world row first. The rewards use the mass centre's
displacement. The physics runs through ``Engine.step`` (K2 on the card).
Envs follow the port's batched protocol (envs/base.py); the state carries
``last_tau``, the last actuation torque, through resets.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from promp_tpu_torch.envs.base import register_env
from promp_tpu_torch.envs.mujoco.ant import qpos_mj, with_world_row
from promp_tpu_torch.envs.mujoco.locomotion import LocomotionEnv, _finite
from promp_tpu_torch.envs.mujoco.rotations import quat_to_mat


@dataclass(frozen=True)
class HumanoidBase(LocomotionEnv):
    """Reset noise U(-0.01, 0.01) on both; frame_skip 5, 2 substeps a
    frame; done when the torso's z leaves [1, 2]."""

    model_name: str = "humanoid"
    frame_skip: int = 5
    n_substeps: int = 2
    qpos_noise: float = 0.01
    qvel_noise: float = 0.01
    qvel_noise_kind: str = "uniform"
    diagnostics_keys = ("reward_linvel", "reward_quadctrl")

    def _mass_center_xy(self, state, task, kin=None):
        """The bodies' mass centre's x, y (the task's ``body_mass``
        multipliers applied where it has them), (..., 2)."""
        if kin is None:
            kin = self.engine.fk(state["q"])
        c = self.engine.consts(kin["com"].dtype, kin["com"].device)
        mass = self.engine._phys(self._mods(task), "body_mass",
                                 c["body_mass"])
        com = (torch.sum(mass[..., None] * kin["com"], dim=-2)
               / torch.sum(mass, dim=-1, keepdim=True))
        return com[..., :2]

    def _obs_dim(self):
        nb1 = self.model.nb + 1  # + the world row
        return ((self.model.nv - 1) + self.model.nv + 10 * nb1 + 6 * nb1
                + self.model.nv + 6 * nb1)

    def _obs(self, state, task, kin=None, wrench=None):
        eng = self.engine
        q, qd = state["q"], state["qd"]
        if kin is None:
            kin = eng.fk(q)
        if wrench is None:
            wrench = eng.contact_wrench(q, qd, self._mods(task), kin)
        c = eng.consts(q.dtype, q.device)
        mass = c["body_mass"]
        # cinert analog: [I_world upper triangle (6), m com (3), m (1)]
        R = quat_to_mat(kin["body_quat"]) @ quat_to_mat(c["body_iquat"])
        I_w = R @ (c["body_inertia"][:, :, None] * R.transpose(-1, -2))
        triu = torch.stack([I_w[..., 0, 0], I_w[..., 1, 1], I_w[..., 2, 2],
                            I_w[..., 0, 1], I_w[..., 0, 2], I_w[..., 1, 2]],
                           dim=-1)
        batch_mass = mass[:, None].expand(kin["com"].shape[:-1] + (1,))
        cinert = torch.cat([triu, mass[:, None] * kin["com"], batch_mass],
                           dim=-1)
        v, w = eng.body_velocities(q, qd, kin)
        cvel = torch.cat([w, v], dim=-1)
        qfrc_actuator = state.get("last_tau")
        if qfrc_actuator is None:
            qfrc_actuator = torch.zeros_like(qd)
        return torch.cat([
            qpos_mj(q)[..., 2:], qd,
            with_world_row(cinert).flatten(-2),
            with_world_row(cvel).flatten(-2), qfrc_actuator,
            with_world_row(wrench).flatten(-2)], dim=-1)

    def _reset_state(self, task, generator, draw):
        state = super()._reset_state(task, generator, draw)
        return dict(state, last_tau=torch.zeros_like(state["qd"]))

    def _step_common(self, state, action, task, lin_vel_cost, kin):
        """(state, obs, reward, done, info) at the new ``state``, whose
        forward kinematics are ``kin``."""
        eng = self.engine
        lo, hi, _, _ = eng._actuator_consts(action.dtype, action.device)
        ctrl = torch.clamp(action, lo, hi)
        state = dict(state, last_tau=eng.actuation(action))
        alive_bonus = 5.0
        quad_ctrl_cost = 0.1 * torch.sum(torch.square(ctrl), dim=-1)
        wrench = eng.contact_wrench(state["q"], state["qd"],
                                    self._mods(task), kin)
        quad_impact_cost = torch.clamp_max(
            0.5e-6 * torch.sum(torch.square(wrench), dim=(-2, -1)), 10.0)
        reward = (lin_vel_cost - quad_ctrl_cost - quad_impact_cost
                  + alive_bonus)
        z = state["q"][..., 2]
        done = torch.logical_not(_finite(state) & (z >= 1.0) & (z <= 2.0))
        info = dict(reward_linvel=lin_vel_cost,
                    reward_quadctrl=-quad_ctrl_cost,
                    reward_alive=torch.full_like(reward, alive_bonus),
                    reward_impact=-quad_impact_cost)
        return (state, self._obs(state, task, kin, wrench), reward, done,
                info)

    def _advance_com(self, state, action, task):
        """(new state, its forward kinematics, the mass centre's xy
        displacement over the step)."""
        before = self._mass_center_xy(state, task)
        new = self._advance(state, action, task)
        kin = self.engine.fk(new["q"])
        return new, kin, self._mass_center_xy(new, task, kin) - before


@register_env("HumanoidRandDirecEnv")
@dataclass(frozen=True)
class HumanoidRandDirecEnv(HumanoidBase):
    """Task in {-1, +1}; reward = 0.25 dir d(com_x) / timestep - costs +
    5 alive. The displacement is divided by the model's timestep, not the
    env's dt, as in the JAX package."""

    def sample_tasks(self, generator, n_tasks, device):
        heads = torch.rand((n_tasks,), generator=generator, device=device)
        return torch.where(heads < 0.5, 1.0, -1.0)

    def step(self, state, action, task):
        state, kin, d = self._advance_com(state, action, task)
        lin_vel_cost = 0.25 * task * d[..., 0] / self.model.timestep
        return self._step_common(state, action, task, lin_vel_cost, kin)


@register_env("HumanoidRandDirec2DEnv")
@dataclass(frozen=True)
class HumanoidRandDirec2DEnv(HumanoidBase):
    """Unit-vector tasks; the reward projects the mass centre's
    displacement onto the direction (over the model's timestep)."""

    task_event_ndim = 1

    def sample_tasks(self, generator, n_tasks, device):
        d = torch.randn((n_tasks, 2), generator=generator, device=device)
        return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    def step(self, state, action, task):
        state, kin, d = self._advance_com(state, action, task)
        lin_vel_cost = (0.25 * torch.sum(task * d, dim=-1)
                        / self.model.timestep)
        return self._step_common(state, action, task, lin_vel_cost, kin)
