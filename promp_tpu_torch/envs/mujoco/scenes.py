"""Programmatic manipulation scenes for the Sawyer meta-envs (port of
promp_tpu/envs/mujoco/scenes.py, built on the port's own ``ChainModel``).

The reference's sawyer envs (reference: meta_policy_search/envs/
sawyer_envs/*.py) wrap the external ``multiworld`` package's MuJoCo scenes,
where a mocap-welded arm tracks commanded end-effector positions and
objects interact through MuJoCo contacts. ``multiworld`` is not installable
in this stack, so these scenes re-create the *mechanics that matter* on the
in-house engine (envs/mujoco/engine.py, its generic route):

  * the end-effector is a 3-slide servo body (high damping + force
    actuation = a velocity servo, the mocap-tracking analog),
  * objects are real dynamic bodies (slides / hinge) with gravity, table
    contact (ground plane z=0) and sphere-sphere contact against the EE,
  * pushing, door-opening and carrying therefore happen through contact
    forces in the integrator, not kinematic teleports.

Models are built directly as ChainModel (no MJCF needed — the scenes are a
handful of primitive bodies).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from promp_tpu_torch.envs.mujoco.model import HINGE, SLIDE, ChainModel

_AXES = np.eye(3)


def _base(nb_fields):
    """Common scalars for all manipulation scenes."""
    return dict(
        friction=0.5, timestep=0.005, gravity=-9.81, free_dof_start=-1,
        density=0.0, viscosity=0.0, geom_axis=np.zeros((nb_fields, 3)),
        geom_halflen=np.zeros(nb_fields), geom_radius=np.zeros(nb_fields),
    )


def _ident_quat(n):
    q = np.zeros((n, 4))
    q[:, 0] = 1.0
    return q


# end-effector servo constants: terminal speed = gear/damping = 1 m/s,
# response time = (armature)/damping = 5 ms, gravity droop = mg/damping
# ~ 1 cm/s for the 0.1 kg tip
EE_MASS = 0.1
EE_DAMPING = 100.0
EE_GEAR = 100.0
EE_ARMATURE = 0.5
EE_RADIUS = 0.03


def _ee_arrays(ws_low, ws_high):
    """Joint/actuator arrays for the 3-slide end-effector (dofs 0-2)."""
    jnt_range = np.stack([np.asarray(ws_low), np.asarray(ws_high)], axis=1)
    return dict(
        jnt_body=(0, 0, 0), jnt_type=(SLIDE,) * 3, jnt_axis=_AXES.copy(),
        jnt_pos=np.zeros((3, 3)), jnt_range=jnt_range, jnt_ref=np.zeros(3),
        jnt_stiffness=np.zeros(3), jnt_springref=np.zeros(3),
        dof_damping=np.full(3, EE_DAMPING),
        dof_armature=np.full(3, EE_ARMATURE),
        act_dof=(0, 1, 2), act_gear=np.full(3, EE_GEAR),
        act_ctrlrange=np.stack([-np.ones(3), np.ones(3)], axis=1),
    )


def sawyer_push_model() -> ChainModel:
    """EE servo + free puck on the table; the puck is pushed through the
    EE-puck contact pair and slides on the ground plane with friction."""
    ee = _ee_arrays([-0.35, 0.35, 0.035], [0.35, 0.85, 0.35])
    puck_range = np.zeros((3, 2))
    return ChainModel(
        body_parent=(-1, -1),
        body_pos=np.zeros((2, 3)), body_quat=_ident_quat(2),
        body_mass=np.array([EE_MASS, 0.2]),
        body_inertia=np.array([[1e-4] * 3, [2e-4] * 3]),
        body_ipos=np.zeros((2, 3)), body_iquat=_ident_quat(2),
        jnt_body=ee["jnt_body"] + (1, 1, 1),
        jnt_type=ee["jnt_type"] + (SLIDE,) * 3,
        jnt_axis=np.concatenate([ee["jnt_axis"], _AXES]),
        jnt_pos=np.zeros((6, 3)),
        jnt_range=np.concatenate([ee["jnt_range"], puck_range]),
        jnt_ref=np.zeros(6), jnt_stiffness=np.zeros(6),
        jnt_springref=np.zeros(6),
        dof_damping=np.concatenate([ee["dof_damping"], np.full(3, 0.1)]),
        dof_armature=np.concatenate([ee["dof_armature"], np.zeros(3)]),
        act_dof=ee["act_dof"], act_gear=ee["act_gear"],
        act_ctrlrange=ee["act_ctrlrange"],
        con_body=(0, 1),
        con_pos=np.zeros((2, 3)),
        con_radius=np.array([EE_RADIUS, 0.04]),
        pair_a=(0,), pair_b=(1,), con_skip_ground=(1, 0),
        init_qpos=np.array([0.0, 0.45, 0.1, 0.0, 0.6, 0.04]),
        init_qvel=np.zeros(6), name="sawyer_push",
        **_base(2),
    )


def sawyer_door_model(hinge_pos=(0.2, 0.7, 0.1),
                      door_len=0.25) -> ChainModel:
    """EE servo + a door panel on a z-hinge; the handle is a contact
    sphere at the free end, pushed open through the EE-handle pair."""
    ee = _ee_arrays([-0.35, 0.35, 0.035], [0.35, 0.85, 0.35])
    return ChainModel(
        body_parent=(-1, -1),
        body_pos=np.array([[0.0, 0.0, 0.0], list(hinge_pos)]),
        body_quat=_ident_quat(2),
        body_mass=np.array([EE_MASS, 1.0]),
        # panel inertia about the hinge end handled by com offset
        body_inertia=np.array([[1e-4] * 3, [1e-2, 1e-2, 6e-3]]),
        body_ipos=np.array([[0.0, 0.0, 0.0],
                            [-door_len / 2.0, 0.0, 0.0]]),
        body_iquat=_ident_quat(2),
        jnt_body=ee["jnt_body"] + (1,),
        jnt_type=ee["jnt_type"] + (HINGE,),
        jnt_axis=np.concatenate([ee["jnt_axis"], [[0.0, 0.0, 1.0]]]),
        jnt_pos=np.zeros((4, 3)),
        jnt_range=np.concatenate([ee["jnt_range"], [[0.0, 1.5]]]),
        jnt_ref=np.zeros(4), jnt_stiffness=np.zeros(4),
        jnt_springref=np.zeros(4),
        dof_damping=np.concatenate([ee["dof_damping"], [2.0]]),
        dof_armature=np.concatenate([ee["dof_armature"], [0.01]]),
        act_dof=ee["act_dof"], act_gear=ee["act_gear"],
        act_ctrlrange=ee["act_ctrlrange"],
        con_body=(0, 1),
        con_pos=np.array([[0.0, 0.0, 0.0], [-door_len, 0.0, 0.0]]),
        con_radius=np.array([EE_RADIUS, 0.03]),
        pair_a=(0,), pair_b=(1,), con_skip_ground=(1, 1),
        init_qpos=np.array([0.0, 0.45, 0.1, 0.0]),
        init_qvel=np.zeros(4), name="sawyer_door",
        **_base(2),
    )


def sawyer_pick_model() -> ChainModel:
    """Same structure as the push scene; the object can also be lifted
    (the grasp itself is a kinematic attach at the env level — the
    gripper's closing mechanics are out of scope, table/push physics and
    gravity on release are real)."""
    return dataclasses.replace(sawyer_push_model(), name="sawyer_pick")
