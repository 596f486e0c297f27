"""Sawyer-style goal-conditioned manipulation meta-envs (port of
promp_tpu/envs/sawyer.py).

The scenes (envs/mujoco/scenes.py) run on the engine's generic route: the
end-effector is a velocity-servo body (three slides), objects are dynamic
bodies with gravity and table contact, and pushing and door-opening happen
through sphere-sphere contact forces. The grasp in pick-and-place is the
one kinematic simplification: while grasped, the object is held at the
end-effector's tip; on release it falls through real physics.

Rewards are the JAX package's: a reach term ``-reachDist`` always on, and
a gated progress bonus (``progress_bonus``) once the hand is at the
object. Envs follow the port's batched protocol (envs/base.py): every
method works on any leading batch shape, and a task carries that batch
shape in front. A reset's ``draw`` is its uniform noise given pre-drawn
(the JAX reset's own draws): for push, push-simple and pick-and-place the
pair (end-effector noise (..., 3), object noise (..., 2)), for the door
the end-effector noise alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch

from promp_tpu_torch.envs.base import (Box, TaskEnv, register_env,
                                       state_dtype, task_leaf)
from promp_tpu_torch.envs.mujoco.engine import Engine
from promp_tpu_torch.envs.mujoco.scenes import (
    sawyer_door_model, sawyer_pick_model, sawyer_push_model)
from promp_tpu_torch.envs.point.corner import _norm

REACH_RADIUS = 0.08

# shaped-reward constants
C1, C2, C3 = 1000.0, 0.01, 0.001
# the EE and the object are spheres whose centres cannot come closer than
# the sum of their radii, so the reach gate is a margin above surface
# contact
TOUCH_MARGIN = 0.04


def progress_bonus(dist, max_dist):
    """``max(1000*(maxDist - dist) + c1*(exp(-d^2/c2) + exp(-d^2/c3)), 0)``:
    a dense linear pull toward the goal plus two sharpening exponentials
    near it."""
    raw = (1000.0 * (max_dist - dist)
           + C1 * (torch.exp(-dist ** 2 / C2) + torch.exp(-dist ** 2 / C3)))
    return torch.clamp_min(raw, 0.0)


def _uniform(generator, shape, low, high, device, dtype=torch.float32):
    """U(low, high) of ``shape``; ``low`` and ``high`` broadcast against
    its last axis."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    low = torch.as_tensor(low, dtype=dtype, device=device)
    high = torch.as_tensor(high, dtype=dtype, device=device)
    return low + u * (high - low)


def _never(x):
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


@dataclass(frozen=True)
class SawyerBase(TaskEnv):
    """Shared: the engine scene, EE/object accessors, stepping."""

    never_done: bool = True
    stochastic_step: bool = False
    frame_skip: int = 4
    diagnostics_keys = ("reachDist", "placeDist")

    action_space: Box = Box(-1.0, 1.0, (3,))

    def _model(self):
        raise NotImplementedError

    @cached_property
    def engine(self):
        return Engine(self._model(), n_substeps=1)

    @property
    def model(self):
        return self.engine.model

    @property
    def dt(self):
        return self.model.timestep * self.frame_skip

    def _advance(self, state, ctrl):
        q, qd = self.engine.step(state["q"], state["qd"], ctrl,
                                 self.frame_skip)
        return dict(state, q=q, qd=qd)

    @property
    def reach_gate(self):
        """Centre distance at which the EE counts as at the object: the
        scene's surface-contact distance plus TOUCH_MARGIN."""
        r = self.model.con_radius
        return float(r[0] + r[1]) + TOUCH_MARGIN

    def _ee(self, state):
        return state["q"][..., :3]

    def _init_q(self, ee_noise):
        """init_qpos over the EE noise's batch shape and in its dtype, the
        noise added to its first three coordinates."""
        q = torch.as_tensor(self.model.init_qpos, dtype=ee_noise.dtype,
                            device=ee_noise.device)
        q = q.expand(ee_noise.shape[:-1] + q.shape)
        return torch.cat([q[..., :3] + ee_noise, q[..., 3:]], dim=-1)

    def diagnostics(self, samples):
        out = {}
        for k in self.diagnostics_keys:
            if k in samples["env_infos"]:
                out[f"Average{k[0].upper()}{k[1:]}"] = torch.mean(
                    samples["env_infos"][k])
        return out


@register_env("SawyerPushEnv")
@dataclass(frozen=True)
class SawyerPushEnv(SawyerBase):
    """Push the puck to a sampled goal on the table.

    Task = goal (x, y) for the object; obs = [ee(3), obj(3)]. Reward:
    ``-reachDist + [reachDist < reach_gate] * progress_bonus(placeDist,
    maxPushDist)``, maxPushDist the object-to-goal distance at reset
    (carried in the env state). The puck moves only by EE-puck contact
    forces and slows by table friction."""

    observation_space: Box = Box(-float("inf"), float("inf"), (6,))
    task_event_ndim = 1

    def _model(self):
        return sawyer_push_model()

    def _obj(self, state):
        return state["q"][..., 3:6]

    def _obs(self, state):
        return torch.cat([self._ee(state), self._obj(state)], dim=-1)

    def sample_tasks(self, generator, n_tasks, device):
        return _uniform(generator, (n_tasks, 2), [-0.2, 0.5], [0.2, 0.75],
                        device)

    def _draw(self, task, generator, draw, batch):
        if draw is None:
            kw = dict(device=task_leaf(task).device,
                      dtype=state_dtype(task))
            draw = (_uniform(generator, batch + (3,), -0.02, 0.02, **kw),
                    _uniform(generator, batch + (2,), -0.08, 0.08, **kw))
        return draw

    def reset(self, task, generator, draw=None):
        batch = tuple(task.shape[:-1])
        ee_noise, obj_noise = self._draw(task, generator, draw, batch)
        q = self._init_q(ee_noise)
        q = torch.cat([q[..., :3], q[..., 3:5] + obj_noise, q[..., 5:]],
                      dim=-1)
        # task[..., :2] so that pick-and-place (3-D goals) reuses it
        state = dict(q=q, qd=torch.zeros_like(q),
                     max_push_dist=_norm(q[..., 3:5] - task[..., :2]))
        return state, self._obs(state)

    def _push_step(self, state, action, task):
        state = self._advance(state, torch.clamp(action[..., :3], -1.0, 1.0))
        reach_dist = _norm(self._ee(state) - self._obj(state))
        place_dist = _norm(self._obj(state)[..., :2] - task)
        return state, reach_dist, place_dist

    def step(self, state, action, task):
        state, reach_dist, place_dist = self._push_step(state, action, task)
        reach_rew = -reach_dist
        push_rew = torch.where(reach_dist < self.reach_gate,
                               progress_bonus(place_dist,
                                              state["max_push_dist"]),
                               torch.zeros_like(reach_dist))
        reward = reach_rew + push_rew
        info = dict(reachDist=reach_dist, placeDist=place_dist,
                    reachRew=reach_rew, pushRew=push_rew)
        return state, self._obs(state), reward, _never(reward), info


@register_env("SawyerPushSimpleEnv")
@dataclass(frozen=True)
class SawyerPushSimpleEnv(SawyerPushEnv):
    """A fixed object start, goals in [-0.2, 0.6] x [0.2, 0.8], and the
    positive place-progress reward ungated by reach."""

    def sample_tasks(self, generator, n_tasks, device):
        return _uniform(generator, (n_tasks, 2), [-0.2, 0.6], [0.2, 0.8],
                        device)

    def reset(self, task, generator, draw=None):
        state, _ = super().reset(task, generator, draw)
        # the fixed object start: the puck's reset noise undone
        q = state["q"]
        init = torch.as_tensor(self.model.init_qpos[3:5], dtype=q.dtype,
                               device=q.device)
        q = torch.cat([q[..., :3], init.expand(q.shape[:-1] + (2,)),
                       q[..., 5:]], dim=-1)
        state = dict(state, q=q, max_push_dist=_norm(q[..., 3:5] - task))
        return state, self._obs(state)

    def step(self, state, action, task):
        state, reach_dist, place_dist = self._push_step(state, action, task)
        reach_rew = -reach_dist
        push_rew = progress_bonus(place_dist, state["max_push_dist"])
        reward = reach_rew + push_rew
        info = dict(reachDist=reach_dist, placeDist=place_dist,
                    reachRew=reach_rew, pushRew=push_rew)
        return state, self._obs(state), reward, _never(reward), info


@register_env("SawyerDoorEnv")
@dataclass(frozen=True)
class SawyerDoorEnv(SawyerBase):
    """Open a door to a sampled target angle.

    Task = the target door angle; the door is a hinged panel the EE pushes
    open through the handle's contact sphere; obs = [ee(3), angle,
    handle(3)]."""

    observation_space: Box = Box(-float("inf"), float("inf"), (7,))
    hinge_pos: tuple = (0.2, 0.7, 0.1)
    door_len: float = 0.25
    diagnostics_keys = ("reachDist", "angleDelta")

    def _model(self):
        return sawyer_door_model(self.hinge_pos, self.door_len)

    def _handle(self, angle):
        hp = torch.as_tensor(self.hinge_pos, dtype=angle.dtype,
                             device=angle.device)
        return hp + self.door_len * torch.stack(
            [-torch.cos(angle), -torch.sin(angle), torch.zeros_like(angle)],
            dim=-1)

    def _obs(self, state):
        angle = state["q"][..., 3]
        return torch.cat([self._ee(state), angle[..., None],
                          self._handle(angle)], dim=-1)

    def sample_tasks(self, generator, n_tasks, device):
        return _uniform(generator, (n_tasks,), 0.0, 0.83, device)

    def reset(self, task, generator, draw=None):
        batch = tuple(task.shape)
        if draw is None:
            draw = _uniform(generator, batch + (3,), -0.02, 0.02,
                            task.device, state_dtype(task))
        q = self._init_q(draw)
        state = dict(q=q, qd=torch.zeros_like(q))
        return state, self._obs(state)

    def step(self, state, action, task):
        state = self._advance(state, torch.clamp(action[..., :3], -1.0, 1.0))
        angle = state["q"][..., 3]
        reach_dist = _norm(self._ee(state) - self._handle(angle))
        angle_delta = torch.abs(angle - task)
        reward = -(reach_dist + angle_delta)
        info = dict(reachDist=reach_dist, angleDelta=angle_delta)
        return state, self._obs(state), reward, _never(reward), info


@register_env("SawyerPickAndPlaceEnv")
@dataclass(frozen=True)
class SawyerPickAndPlaceEnv(SawyerPushEnv):
    """Pick the object and place it at a 3D goal. Task = goal (x, y, z);
    the action gains a gripper channel; while grasped (near, gripper
    closed) the object is carried at the EE tip, and on release it falls
    and lands through real contact."""

    action_space: Box = Box(-1.0, 1.0, (4,))
    # the object rests just below the EE sphere while held (spheres
    # touching, zero penalty force at the hold point)
    hold_offset: tuple = (0.0, 0.0, -0.07)
    diagnostics_keys = ("reachDist", "placingDist", "reachRew", "pickRew",
                        "placeRew")

    def _model(self):
        return sawyer_pick_model()

    def sample_tasks(self, generator, n_tasks, device):
        return _uniform(generator, (n_tasks, 3), [-0.15, 0.5, 0.05],
                        [0.15, 0.7, 0.25], device)

    def reset(self, task, generator, draw=None):
        state, obs = super().reset(task, generator, draw)
        q = state["q"]
        state = dict(state, grasp=torch.zeros(q.shape[:-1], dtype=q.dtype,
                                              device=q.device),
                     max_place_dist=_norm(q[..., 3:6] - task))
        return state, obs

    def step(self, state, action, task):
        state = self._advance(state, torch.clamp(action[..., :3], -1.0, 1.0))
        q, qd = state["q"], state["qd"]
        near = _norm(self._ee(state) - self._obj(state)) < REACH_RADIUS
        grasping = near & (action[..., 3] > 0.0)
        # kinematic attach: the object tracks the EE tip while grasped
        hold = self._ee(state) + torch.as_tensor(
            self.hold_offset, dtype=q.dtype, device=q.device)
        g = grasping[..., None]
        q = torch.where(g, torch.cat([q[..., :3], hold, q[..., 6:]], -1), q)
        qd = torch.where(g, torch.cat([qd[..., :3], qd[..., :3], qd[..., 6:]],
                                      -1), qd)
        state = dict(state, q=q, qd=qd, grasp=grasping.to(q.dtype))
        reach_dist = _norm(self._ee(state) - self._obj(state))
        place_dist = _norm(self._obj(state) - task)
        # staged shaping: reachRew, pickRew, placeRew
        reach_rew = -reach_dist
        obj_z = self._obj(state)[..., 2]
        zero = torch.zeros_like(reach_dist)
        pick_rew = torch.where(state["grasp"] > 0.0,
                               100.0 * torch.minimum(task[..., 2], obj_z),
                               zero)
        place_rew = torch.where(reach_dist < self.reach_gate,
                                progress_bonus(place_dist,
                                               state["max_place_dist"]),
                                zero)
        reward = reach_rew + pick_rew + place_rew
        info = dict(reachDist=reach_dist, placingDist=place_dist,
                    reachRew=reach_rew, pickRew=pick_rew,
                    placeRew=place_rew)
        return state, self._obs(state), reward, _never(reward), info
