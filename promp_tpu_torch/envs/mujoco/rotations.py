"""Quaternion / rotation helpers of the rigid-body engine (port of
promp_tpu/envs/mujoco/rotations.py).

Conventions follow MuJoCo: quaternions are (w, x, y, z), rotations are
active, frames compose parent->child. Every function works on any leading
batch shape.
"""
from __future__ import annotations

import torch


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def cross(a, b):
    """a x b over the last axis, broadcasting the leading axes."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_inv(q):
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                        device=q.device)
    return q * sign


def quat_from_axis_angle(axis, angle):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quat_from_euler_xyz(rx, ry, rz):
    """Intrinsic x-y-z Euler angles -> quaternion (the free joint's
    orientation dofs, decomposed as 3 hinges)."""
    kw = dict(dtype=rx.dtype, device=rx.device)
    ex = quat_from_axis_angle(torch.tensor([1.0, 0.0, 0.0], **kw), rx)
    ey = quat_from_axis_angle(torch.tensor([0.0, 1.0, 0.0], **kw), ry)
    ez = quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], **kw), rz)
    return quat_mul(quat_mul(ex, ey), ez)


def euler_xyz_from_quat(q):
    """Inverse of quat_from_euler_xyz (intrinsic x-y-z)."""
    R = quat_to_mat(q)
    # R = Rx(rx) Ry(ry) Rz(rz)
    ry = torch.arcsin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    rx = torch.arctan2(-R[..., 1, 2], R[..., 2, 2])
    rz = torch.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return rx, ry, rz
