"""Featherstone 6D spatial algebra on batched tensors.

Conventions (those of `isaacgymenv_tpu/physics/spatial.py`):
- spatial motion vector ``[omega(3), v(3)]``, spatial force ``[n(3), f(3)]``;
- a frame transform is ``(R, p)``: child axes in parent coordinates and the
  child origin in parent coordinates.  All ops broadcast over leading dims.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v for (..., 3, 3) and (..., 3)."""
    return (R @ v.unsqueeze(-1)).squeeze(-1)


def mtv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v."""
    return (R.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )


def mot_to_child(R: torch.Tensor, p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Motion vector in the parent frame -> child frame."""
    w_p, v_p = m[..., :3], m[..., 3:]
    w = mtv(R, w_p)
    v = mtv(R, v_p - cross(p, w_p))
    return torch.cat([w, v], dim=-1)


def frc_to_parent(R: torch.Tensor, p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Force vector in the child frame -> parent frame."""
    lin = mv(R, f[..., 3:])
    n = mv(R, f[..., :3]) + cross(p, lin)
    return torch.cat([n, lin], dim=-1)


def crm(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    w, vl = v[..., :3], v[..., 3:]
    mw, mvv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mvv) + cross(vl, mw)], dim=-1)


def crf(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], dim=-1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor, inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body origin:
    [[Ic + m cx cx^T, m cx], [m cx^T, m 1]]."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(cx.shape)
    top = torch.cat([inertia_com + m * cx @ cx.transpose(-1, -2), m * cx], dim=-1)
    bot = torch.cat([m * cx.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def xform_frc_matrix(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """6x6 force transform child->parent: [[R, px R], [0, R]]."""
    top = torch.cat([R, skew(p) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_to_parent(R: torch.Tensor, p: torch.Tensor, I_child: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia child frame -> parent frame: Xf(c->p) I Xm(p->c)."""
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([-Rt @ skew(p), Rt], dim=-1)
    xm_p2c = torch.cat([top, bot], dim=-2)
    return xform_frc_matrix(R, p) @ I_child @ xm_p2c
