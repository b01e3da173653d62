"""Batched articulated-body dynamics: the CRBA mass matrix and the
articulated-body algorithm (ABA) that the physics step uses.

Counterparts of `crba`, `_solve_sym66` and `aba` of
`isaacgymenv_tpu/physics/dynamics.py`, with the same body-frame spatial
algebra; gravity enters through the accelerating-base trick.
"""

from __future__ import annotations

from typing import Optional

import torch

from isaacgymenv_tpu_torch.physics import spatial
from isaacgymenv_tpu_torch.physics.kinematics import Kin
from isaacgymenv_tpu_torch.physics.types import JT_FIXED, JT_FREE, SimModel


def _ndof(model: SimModel, i: int) -> int:
    jt = model.jtype[i]
    return 6 if jt == JT_FREE else 0 if jt == JT_FIXED else 1


def body_spatial_inertias(model: SimModel, dtype=torch.float32):
    """Per-body 6x6 spatial inertia about the body origin, body frame: (nb, 6, 6)."""
    return spatial.spatial_inertia(
        model.body_mass.to(dtype), model.body_com.to(dtype), model.body_inertia.to(dtype)
    )


def crba(model: SimModel, kin: Kin, inertias: torch.Tensor) -> torch.Tensor:
    """Composite-rigid-body mass matrix (..., nv, nv)."""
    batch = kin.p_w[0].shape[:-1]
    Ic = [inertias[i].expand(batch + (6, 6)) for i in range(model.nb)]
    for i in reversed(range(model.nb)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = Ic[par] + spatial.inertia_to_parent(kin.R_l[i], kin.p_l[i], Ic[i])

    M = torch.zeros(batch + (model.nv, model.nv), dtype=inertias.dtype, device=inertias.device)
    for i in range(model.nb):
        ni = _ndof(model, i)
        if ni == 0:
            continue
        vi = model.v_adr[i]
        F = Ic[i] @ kin.S[i]
        M[..., vi : vi + ni, vi : vi + ni] = kin.S[i].transpose(-1, -2) @ F
        j = i
        while model.parent[j] >= 0:
            F = spatial.xform_frc_matrix(kin.R_l[j], kin.p_l[j]) @ F
            j = model.parent[j]
            nj = _ndof(model, j)
            if nj == 0:
                continue
            vj = model.v_adr[j]
            blk = F.transpose(-1, -2) @ kin.S[j]
            M[..., vi : vi + ni, vj : vj + nj] = blk
            M[..., vj : vj + nj, vi : vi + ni] = blk.transpose(-1, -2)
    if model.nd > 0:
        vi = list(model.dof_v_adr)
        M[..., vi, vi] = M[..., vi, vi] + model.dof_armature.to(M.dtype)
    return M


def _solve_sym66(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve of SPD (..., 6, 6) systems."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _joint_velocity(model: SimModel, kin: Kin, i: int) -> torch.Tensor:
    """S_i qd_i in the child frame (the velocity across joint i)."""
    par = model.parent[i]
    if par < 0:
        return kin.v[i] if model.jtype[i] == JT_FREE else torch.zeros_like(kin.v[i])
    return kin.v[i] - spatial.mot_to_child(kin.R_l[i], kin.p_l[i], kin.v[par])


def aba(
    model: SimModel,
    kin: Kin,
    tau: torch.Tensor,
    f_ext_world: Optional[torch.Tensor] = None,
    d_extra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Articulated-body algorithm: qdd (..., nv).

    tau: (..., nv) generalized applied force; f_ext_world: (..., nb, 6)
    world-frame [moment, force] per body about its origin; d_extra: (..., nd)
    joint-space diagonal added to the armature (implicit drive terms).
    """
    batch = tau.shape[:-1]
    inertias = body_spatial_inertias(model, tau.dtype)
    nb = model.nb

    c, IA, pA = [], [], []
    for i in range(nb):
        I_i = inertias[i].expand(batch + (6, 6))
        c.append(spatial.crm(kin.v[i], _joint_velocity(model, kin, i)))
        IA.append(I_i)
        p_i = spatial.crf(kin.v[i], spatial.mv(I_i, kin.v[i]))
        if f_ext_world is not None:
            fe = f_ext_world[..., i, :]
            n_b = spatial.mtv(kin.R_w[i], fe[..., :3])
            f_b = spatial.mtv(kin.R_w[i], fe[..., 3:])
            p_i = p_i - torch.cat([n_b, f_b], dim=-1)
        pA.append(p_i)

    arm = {}
    for d in range(model.nd):
        extra = d_extra[..., d] if d_extra is not None else 0.0
        arm[model.dof_body[d]] = model.dof_armature[d] + extra

    U, dinv, u = [None] * nb, [None] * nb, [None] * nb
    for i in reversed(range(nb)):
        jt, par = model.jtype[i], model.parent[i]
        if jt == JT_FIXED:
            Ia = IA[i]
            pa = pA[i] + spatial.mv(IA[i], c[i])
        elif jt == JT_FREE:
            Ia = pa = None
        else:  # 1-dof
            S = kin.S[i][..., :, 0]
            Ui = spatial.mv(IA[i], S)
            di = (S * Ui).sum(-1) + arm[i]
            ui = tau[..., model.v_adr[i]] - (S * pA[i]).sum(-1)
            U[i], u[i] = Ui, ui
            dinv[i] = 1.0 / di
            Ia = IA[i] - Ui[..., :, None] * Ui[..., None, :] * dinv[i][..., None, None]
            pa = pA[i] + spatial.mv(Ia, c[i]) + Ui * (ui * dinv[i])[..., None]
        if par >= 0:
            IA[par] = IA[par] + spatial.inertia_to_parent(kin.R_l[i], kin.p_l[i], Ia)
            pA[par] = pA[par] + spatial.frc_to_parent(kin.R_l[i], kin.p_l[i], pa)

    g = model.gravity.to(tau.dtype)
    a_base_world = torch.cat([torch.zeros_like(g), -g]).expand(batch + (6,))
    qdd = torch.zeros_like(tau)
    a = [None] * nb
    for i in range(nb):
        jt, par = model.jtype[i], model.parent[i]
        if par < 0:
            a_par = spatial.mot_to_child(kin.R_w[i], kin.p_w[i], a_base_world)
        else:
            a_par = spatial.mot_to_child(kin.R_l[i], kin.p_l[i], a[par])
        a_p = a_par + c[i]
        va = model.v_adr[i]
        if jt == JT_FREE:
            rhs = tau[..., va : va + 6] - (pA[i] + spatial.mv(IA[i], a_p))
            qdd_root = _solve_sym66(IA[i], rhs)
            qdd[..., va : va + 6] = qdd_root
            a[i] = a_p + qdd_root
        elif jt == JT_FIXED:
            a[i] = a_p
        else:
            S = kin.S[i][..., :, 0]
            qdd_i = (u[i] - (U[i] * a_p).sum(-1)) * dinv[i]
            qdd[..., va] = qdd_i
            a[i] = a_p + S * qdd_i[..., None]
    return qdd
