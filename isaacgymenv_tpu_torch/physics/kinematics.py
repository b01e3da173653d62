"""Batched forward kinematics and point Jacobians over the kinematic forest.

Functions take `q (..., nq)` / `qd (..., nv)` and loop over bodies in Python
(the topology is static).  Per-body local transform ``(R_l, p_l)`` is the
child frame in its parent's frame; the world transform ``(R_w, p_w)`` is the
body frame in the env-local world frame.  Spatial velocities are body-frame
``[omega, v]`` (physics/spatial.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import spatial
from isaacgymenv_tpu_torch.physics.types import (
    JT_FREE,
    JT_PRISMATIC,
    JT_REVOLUTE,
    JT_SCREW,
    SimModel,
)

_TWO_PI = 6.283185307179586


def _rot_about_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a unit axis (3,) by angle (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    outer = axis[:, None] * axis[None, :]
    return c * eye + s * spatial.skew(axis) + (1.0 - c) * outer


class Kin(NamedTuple):
    """Per-body kinematic quantities; each entry is a list of length nb."""

    R_l: list  # (..., 3, 3)
    p_l: list  # (..., 3)
    R_w: list  # (..., 3, 3)
    p_w: list  # (..., 3)
    S: list    # (..., 6, ni) joint motion subspace, child frame (None if 0-dof)
    v: list    # (..., 6) body-frame spatial velocity


def joint_local_transform(model: SimModel, q: torch.Tensor, i: int):
    """(R_l, p_l) of body i in its parent's frame."""
    qa, jt = model.q_adr[i], model.jtype[i]
    batch = q.shape[:-1]
    R_tree = maths.quat_to_rotmat(model.joint_quat[i])
    p_tree = model.joint_pos[i]
    if jt == JT_FREE:
        R = R_tree @ maths.quat_to_rotmat(q[..., qa + 3 : qa + 7])
        p = p_tree + spatial.mv(R_tree, q[..., qa : qa + 3])
    elif jt == JT_REVOLUTE:
        R = R_tree @ _rot_about_axis(model.joint_axis[i], q[..., qa])
        p = p_tree.expand(batch + (3,))
    elif jt == JT_PRISMATIC:
        R = R_tree.expand(batch + (3, 3))
        p = p_tree + spatial.mv(R_tree, model.joint_axis[i] * q[..., qa : qa + 1])
    elif jt == JT_SCREW:
        axis = model.joint_axis[i]
        R = R_tree @ _rot_about_axis(axis, q[..., qa])
        lead = model.joint_pitch[i] / _TWO_PI
        p = p_tree + spatial.mv(R_tree, axis * (lead * q[..., qa : qa + 1]))
    else:  # JT_FIXED
        R = R_tree.expand(batch + (3, 3))
        p = p_tree.expand(batch + (3,))
    return R, p


def joint_subspace(model: SimModel, i: int, batch_shape, dtype):
    """Motion subspace S (..., 6, ni) in the child frame; None for 0-dof."""
    jt = model.jtype[i]
    dev = model.device
    if jt == JT_FREE:
        return torch.eye(6, dtype=dtype, device=dev).expand(batch_shape + (6, 6))
    axis = model.joint_axis[i].to(dtype)
    zero = torch.zeros_like(axis)
    if jt == JT_REVOLUTE:
        col = torch.cat([axis, zero])
    elif jt == JT_PRISMATIC:
        col = torch.cat([zero, axis])
    elif jt == JT_SCREW:
        col = torch.cat([axis, axis * (model.joint_pitch[i] / _TWO_PI)])
    else:
        return None
    return col[:, None].expand(batch_shape + (6, 1))


def fk(model: SimModel, q: torch.Tensor, qd: torch.Tensor) -> Kin:
    """Forward kinematics and body velocities for all bodies."""
    batch = q.shape[:-1]
    R_l, p_l, R_w, p_w, S_all, v_all = [], [], [], [], [], []
    for i in range(model.nb):
        R, p = joint_local_transform(model, q, i)
        R_l.append(R)
        p_l.append(p)
        par = model.parent[i]
        if par < 0:
            R_w.append(R)
            p_w.append(p)
        else:
            R_w.append(R_w[par] @ R)
            p_w.append(p_w[par] + spatial.mv(R_w[par], p))
        S = joint_subspace(model, i, batch, q.dtype)
        S_all.append(S)
        va, jt = model.v_adr[i], model.jtype[i]
        if jt == JT_FREE:
            vj = qd[..., va : va + 6]
        elif jt in (JT_REVOLUTE, JT_PRISMATIC, JT_SCREW):
            vj = S[..., :, 0] * qd[..., va : va + 1]
        else:
            vj = torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)
        v_all.append(vj if par < 0 else spatial.mot_to_child(R, p, v_all[par]) + vj)
    return Kin(R_l=R_l, p_l=p_l, R_w=R_w, p_w=p_w, S=S_all, v=v_all)


def world_velocities(model: SimModel, kin: Kin):
    """World-frame (angvel, linvel of the origin) per body: lists of (..., 3)."""
    ang = [spatial.mv(kin.R_w[i], kin.v[i][..., :3]) for i in range(model.nb)]
    lin = [spatial.mv(kin.R_w[i], kin.v[i][..., 3:]) for i in range(model.nb)]
    return ang, lin


def body_jacobian(model: SimModel, kin: Kin, body: int, point_w: torch.Tensor) -> torch.Tensor:
    """World-frame (..., 6, nv) Jacobian of a point on `body`: rows [0:3]
    linear, [3:6] angular (Isaac's jacobian tensor layout)."""
    batch = point_w.shape[:-1]
    J = torch.zeros(batch + (6, model.nv), dtype=point_w.dtype, device=point_w.device)
    i = body
    while i >= 0:
        jt, va = model.jtype[i], model.v_adr[i]
        if jt in (JT_REVOLUTE, JT_PRISMATIC, JT_SCREW):
            axis_w = spatial.mv(kin.R_w[i], model.joint_axis[i])
            if jt == JT_PRISMATIC:
                J[..., 0:3, va] = axis_w
            else:
                lin = spatial.cross(axis_w, point_w - kin.p_w[i])
                if jt == JT_SCREW:
                    lin = lin + axis_w * (model.joint_pitch[i] / _TWO_PI)
                J[..., 0:3, va] = lin
                J[..., 3:6, va] = axis_w
        elif jt == JT_FREE:
            R = kin.R_w[i]
            lever = point_w - kin.p_w[i]
            for k in range(3):
                wk = R[..., :, k]
                J[..., 0:3, va + k] = spatial.cross(wk, lever)
                J[..., 3:6, va + k] = wk
                J[..., 0:3, va + 3 + k] = wk
        i = model.parent[i]
    return J
