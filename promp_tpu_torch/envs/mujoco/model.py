"""Articulated rigid-body model spec (port of promp_tpu/envs/mujoco/model.py).

A model is a kinematic tree of bodies, each joined to its parent by zero
or more 1-DoF joints (slide or hinge about an axis through an anchor);
free joints are decomposed into 3 world-aligned slides and 3 intrinsic
x-y-z Euler hinges. Capsule and sphere geoms are reduced to contact
spheres against the ground plane z = 0.

The specs are committed as ``.npz`` files under ``specs/`` (copies of the
JAX package's, extracted once from the gymnasium MJCF assets) and loaded
with numpy; there is no importer here, so a missing spec is an error.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")

SLIDE, HINGE = 0, 1


@dataclass(frozen=True)
class ChainModel:
    """Static model arrays (numpy). nb bodies (world excluded), nv DoFs,
    nu actuators, nc contact spheres."""

    # tree structure
    body_parent: Tuple[int, ...]          # (nb,) parent body index, -1=world
    body_pos: np.ndarray                  # (nb, 3) frame offset in parent
    body_quat: np.ndarray                 # (nb, 4)
    body_mass: np.ndarray                 # (nb,)
    body_inertia: np.ndarray              # (nb, 3) diagonal, inertial frame
    body_ipos: np.ndarray                 # (nb, 3) com offset in body frame
    body_iquat: np.ndarray                # (nb, 4) inertial frame rotation

    # joints: each dof belongs to a body; dofs of a body apply in order
    jnt_body: Tuple[int, ...]             # (nv,) body index
    jnt_type: Tuple[int, ...]             # (nv,) SLIDE | HINGE
    jnt_axis: np.ndarray                  # (nv, 3) axis in body frame
    jnt_pos: np.ndarray                   # (nv, 3) anchor in body frame
    jnt_range: np.ndarray                 # (nv, 2) limits; [0,0] = unlimited
    jnt_ref: np.ndarray                   # (nv,) kinematics displace by
                                          # (qpos - ref), mjcf 'ref'
    jnt_stiffness: np.ndarray             # (nv,)
    jnt_springref: np.ndarray             # (nv,)
    dof_damping: np.ndarray               # (nv,)
    dof_armature: np.ndarray              # (nv,)

    # actuators
    act_dof: Tuple[int, ...]              # (nu,) target dof index
    act_gear: np.ndarray                  # (nu,)
    act_ctrlrange: np.ndarray             # (nu, 2)

    # contact spheres (against the ground plane z=0, and pairwise where
    # listed in pair_a/pair_b)
    con_body: Tuple[int, ...]             # (nc,) body index
    con_pos: np.ndarray                   # (nc, 3) center in body frame
    con_radius: np.ndarray                # (nc,)
    friction: float                       # tangential friction coefficient

    # integration
    timestep: float                       # MJCF opt.timestep
    gravity: float                        # -9.81 etc (z component)
    init_qpos: np.ndarray                 # (nv,) engine coordinates
    init_qvel: np.ndarray                 # (nv,)

    # free-joint bookkeeping: index of the first of 6 decomposed dofs, or -1
    free_dof_start: int = -1
    # fluid model (swimmer): MuJoCo medium density/viscosity
    density: float = 0.0
    viscosity: float = 0.0
    # per-body capsule (axis in body frame, half-length, radius) for drag
    geom_axis: np.ndarray = field(default=None)     # (nb, 3)
    geom_halflen: np.ndarray = field(default=None)  # (nb,)
    geom_radius: np.ndarray = field(default=None)   # (nb,)
    # sphere-sphere contact pairs: indices into the con_* sphere table
    pair_a: Tuple[int, ...] = ()          # (npair,)
    pair_b: Tuple[int, ...] = ()          # (npair,)
    # spheres that do NOT collide with the ground plane (1 = skip)
    con_skip_ground: Tuple[int, ...] = ()  # (nc,) 0/1; () = all collide
    # the spec's name, for messages (not a field of the JAX package's spec)
    name: str = ""

    @property
    def nv(self):
        return len(self.jnt_type)

    @property
    def nb(self):
        return len(self.body_parent)

    @property
    def nu(self):
        return len(self.act_dof)

    def ancestor_mask(self):
        """(nb, nv) 1.0 where dof j moves body b: j's body is b or one of
        b's ancestors. Computed once a model (a read-only array)."""
        mask = self.__dict__.get("_ancestor_mask")
        if mask is None:
            mask = np.zeros((self.nb, self.nv), np.float32)
            for b in range(self.nb):
                chain = []
                cur = b
                while cur >= 0:
                    chain.append(cur)
                    cur = self.body_parent[cur]
                for j in range(self.nv):
                    if self.jnt_body[j] in chain:
                        mask[b, j] = 1.0
            mask.setflags(write=False)
            self.__dict__["_ancestor_mask"] = mask
        return mask

    def dof_ancestor_strict(self):
        """(nv, nv) 1.0 where dof k is a strict ancestor of dof j: k is
        applied before j on j's kinematic chain (the dofs of ancestor
        bodies, and the earlier dofs of j's own body, which apply in
        declaration order). The RNEA bias pass reads it: the motion
        subspace of joint j is carried by the frame these dofs build.
        Computed once a model (a read-only array)."""
        mask = self.__dict__.get("_dof_ancestor_strict")
        if mask is None:
            body_anc = self.ancestor_mask()
            mask = np.zeros((self.nv, self.nv), np.float32)
            for j in range(self.nv):
                b = self.jnt_body[j]
                parent = self.body_parent[b]
                for k in range(self.nv):
                    kb = self.jnt_body[k]
                    if kb == b:
                        if k < j:
                            mask[j, k] = 1.0
                    elif parent >= 0 and body_anc[parent, k]:
                        mask[j, k] = 1.0
            mask.setflags(write=False)
            self.__dict__["_dof_ancestor_strict"] = mask
        return mask


_ARRAY_FIELDS = [
    "body_pos", "body_quat", "body_mass", "body_inertia", "body_ipos",
    "body_iquat", "jnt_axis", "jnt_pos", "jnt_range", "jnt_ref",
    "jnt_stiffness",
    "jnt_springref", "dof_damping", "dof_armature", "act_gear",
    "act_ctrlrange", "con_pos", "con_radius", "init_qpos", "init_qvel",
    "geom_axis", "geom_halflen", "geom_radius",
]
_TUPLE_FIELDS = ["body_parent", "jnt_body", "jnt_type", "act_dof",
                 "con_body", "pair_a", "pair_b", "con_skip_ground"]
_SCALAR_FIELDS = ["friction", "timestep", "gravity", "free_dof_start",
                  "density", "viscosity"]


def load_spec(path, name="") -> ChainModel:
    with np.load(path) as z:
        kwargs = {f: z[f] for f in _ARRAY_FIELDS}
        # tuple fields default to () for specs saved before they existed
        kwargs.update({f: tuple(int(x) for x in z[f]) if f in z else ()
                       for f in _TUPLE_FIELDS})
        kwargs.update({f: z[f].item() for f in _SCALAR_FIELDS})
    kwargs["free_dof_start"] = int(kwargs["free_dof_start"])
    return ChainModel(name=name, **kwargs)


def get_model(name) -> ChainModel:
    """Load the committed spec ``specs/<name>.npz``."""
    path = os.path.join(_SPEC_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no model spec '{name}' at {path}; the port loads committed "
            f"specs only (known: {sorted(available_models())})")
    return load_spec(path, name)


def available_models():
    return [f[:-4] for f in os.listdir(_SPEC_DIR) if f.endswith(".npz")]
