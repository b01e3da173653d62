"""Quaternion / rotation helpers on batched tensors, xyzw layout.

PyTorch counterparts of the functions of `isaacgymenv_tpu/ops/maths.py` that
the physics step and the ported tasks use.  Every function accepts arbitrary
leading batch dimensions: quaternions are `(..., 4)`, vectors `(..., 3)`.
"""

from __future__ import annotations

import math

import torch


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize along the last axis."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def scale(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Map [-1, 1] -> [lower, upper]."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Map [lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: v' = v + 2w (u x v) + u x (2 u x v)."""
    u, w = q[..., :3], q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


quat_rotate = quat_apply


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation by angle (...,) about axis (..., 3)."""
    theta = (angle / 2.0)[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    return quat_unit(torch.cat([xyz, torch.cos(theta)], dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4), branch-free Shepperd variant."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0), qw0], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1), (m21 - m12) / (4 * qx1)], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2), (m02 - m20) / (4 * qy2)], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3, (m10 - m01) / (4 * qz3)], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return quat_unit(q)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """Integrate a unit quaternion by a world-frame angular velocity over dt."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * angle * dt
    k = torch.where(
        angle > 1e-9,
        torch.sin(half) / torch.clamp(angle, min=1e-9),
        torch.full_like(angle, 0.5 * dt),
    )
    dq = torch.cat([omega_world * k, torch.cos(half)], dim=-1)
    return quat_unit(quat_mul(dq, q))


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the yaw component of q only."""
    quat_yaw = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:4]], dim=-1)
    return quat_apply(quat_unit(quat_yaw), v)


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] (a floored remainder, as the JAX package's `%`)."""
    a = torch.remainder(angles, 2.0 * math.pi)
    return a - 2.0 * math.pi * (a > math.pi).to(a.dtype)


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to [-pi, pi] through atan2."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), each in [0, 2 pi) (a floored
    remainder, as the JAX package's `%`)."""
    qx, qy, qz, qw = q.unbind(-1)
    roll = torch.atan2(2.0 * (qw * qx + qy * qz), qw * qw - qx * qx - qy * qy + qz * qz)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(torch.abs(sinp) >= 1.0, torch.copysign(torch.full_like(sinp, math.pi / 2.0), sinp),
                        torch.asin(torch.clamp(sinp, -1.0, 1.0)))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy), qw * qw + qx * qx - qy * qy - qz * qz)
    two_pi = 2.0 * math.pi
    return torch.remainder(roll, two_pi), torch.remainder(pitch, two_pi), torch.remainder(yaw, two_pi)


def compute_heading_and_up(torso_rotation, inv_start_rot, to_target, vec0, vec1, up_idx: int):
    """Heading and up projections of the torso (Ant, Humanoid):
    (torso_quat, up_proj, heading_proj, up_vec, heading_vec)."""
    target_dirs = normalize(to_target)
    torso_quat = quat_mul(torso_rotation, inv_start_rot)
    up_vec = quat_rotate(torso_quat, vec1)
    heading_vec = quat_rotate(torso_quat, vec0)
    return torso_quat, up_vec[..., up_idx], (heading_vec * target_dirs).sum(-1), up_vec, heading_vec


def compute_rot(torso_quat, velocity, ang_velocity, targets, torso_positions):
    """Body-frame velocities, roll/pitch/yaw and the angle to the target:
    (vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target)."""
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    walk_target_angle = torch.atan2(targets[..., 2] - torso_positions[..., 2],
                                    targets[..., 0] - torso_positions[..., 0])
    return vel_loc, angvel_loc, roll, pitch, yaw, walk_target_angle - yaw
