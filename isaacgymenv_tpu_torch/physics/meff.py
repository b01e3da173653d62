"""Build-time estimate of the articulated effective mass at each contact point.

The impulse-capped contact model (physics/contact.py) bounds damper and
friction forces by kappa * m_eff * |v| / h.  This computes 1 / (J M^-1 J^T)
per contact point at a reference pose, once: the min-direction mass
(`geom_meff`) and the max-direction mass (`geom_meff_el`, the elastic cap).
Counterpart of `isaacgymenv_tpu/physics/meff.py` (ground spheres and pair
surfaces).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import dynamics, kinematics
from isaacgymenv_tpu_torch.physics.types import SimModel, make_zero_state


def _dir_masses(model, kin, Minv, body: int, point_w: torch.Tensor):
    J = kinematics.body_jacobian(model, kin, body, point_w[None])[0]
    lam = J[0:3] @ Minv @ J[0:3].T
    m_dir = 1.0 / torch.clamp(torch.diagonal(lam), min=1e-6)
    return (
        float(torch.clamp(m_dir.min(), 1e-3, 1e4)),
        float(torch.clamp(m_dir.max(), 1e-3, 1e4)),
    )


def attach_effective_masses(model: SimModel, q0: Optional[np.ndarray] = None) -> SimModel:
    """Return the model with geom_meff / geom_meff_el (and surf_meff /
    surf_meff_el when it has surfaces) at the pose q0 (default: zero pose)."""
    if model.ng == 0:
        return model
    if q0 is None:
        q = make_zero_state(model, 1).q
    else:
        q = torch.as_tensor(np.asarray(q0), dtype=torch.float32, device=model.device)[None]
    qd = torch.zeros((1, model.nv), device=model.device)
    kin = kinematics.fk(model, q, qd)
    M = dynamics.crba(model, kin, dynamics.body_spatial_inertias(model))[0]
    Minv = torch.linalg.inv(M + 1e-9 * torch.eye(model.nv, device=model.device))

    masses = []
    for g in range(model.ng):
        b = model.geom_body[g]
        point_w = kin.p_w[b][0] + maths.quat_rotate(
            maths.rotmat_to_quat(kin.R_w[b][0]), model.geom_offset[g]
        )
        masses.append(_dir_masses(model, kin, Minv, b, point_w))
    f32 = dict(dtype=torch.float32, device=model.device)
    changes = dict(
        geom_meff=torch.tensor([m[0] for m in masses], **f32),
        geom_meff_el=torch.tensor([m[1] for m in masses], **f32),
    )
    if model.surf_body:
        masses = [
            _dir_masses(
                model, kin, Minv, b,
                kin.p_w[b][0] + kin.R_w[b][0] @ model.surf_offset[s],
            )
            for s, b in enumerate(model.surf_body)
        ]
        changes.update(
            surf_meff=torch.tensor([m[0] for m in masses], **f32),
            surf_meff_el=torch.tensor([m[1] for m in masses], **f32),
        )
    return dataclasses.replace(model, **changes)
