"""The simulation step: actuation -> contacts -> forward dynamics -> integrate.

Counterpart of `isaacgymenv_tpu/physics/engine.py`.  `step` advances one
control period of `substeps` substeps.  A scene that `fused.fused_structural_ok`
accepts goes through `fused.fused_substep`, which launches the CUDA kernel
for a CUDA state and runs its plain version (the `_substep` loop below) for
a CPU state; any other scene runs the `_substep` loop.

Stability notes: joint drive damping, limit springs and joint friction are
integrated implicitly (h*Kd + h^2*Kp added to the joint-space diagonal);
contacts are compliant penalty springs (physics/contact.py); integration is
semi-implicit Euler (qd first, then q with the new qd).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import contact as contact_mod
from isaacgymenv_tpu_torch.physics import dynamics, kinematics
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_EFFORT,
    DRIVE_NONE,
    DRIVE_POS,
    DRIVE_VEL,
    JT_FREE,
    SimModel,
    SimState,
)

# joint-limit penalty spring/damper (soft limits)
_LIMIT_STIFFNESS = 4000.0
_LIMIT_DAMPING = 40.0
# regularization velocity of the Coulomb joint friction
_FRICTION_VEL_EPS = 0.05
# free-root velocity limits (PhysX asset defaults)
_MAX_ROOT_ANGVEL = 64.0
_MAX_ROOT_LINVEL = 1000.0


@dataclass
class Control:
    """Per-step actuation, held constant across substeps; arrays broadcast
    against (N, nd).  `body_wrench` (N, nb, 6) is not ported and must be None."""

    pos_target: torch.Tensor
    vel_target: torch.Tensor
    effort: torch.Tensor
    body_wrench: Optional[torch.Tensor] = None

    @classmethod
    def zero(cls, model: SimModel, n_envs: int) -> "Control":
        z = torch.zeros((n_envs, model.nd), device=model.device)
        return cls(pos_target=z, vel_target=z, effort=z)


def actuation_force(model: SimModel, dof_pos, dof_vel, ctrl: Control):
    """Applied joint force per drive mode, clamped to the effort limits."""
    mode = model.dof_drive_mode
    kp, kd = model.dof_stiffness, model.dof_damping
    zero = torch.zeros_like(dof_pos)
    pd_pos = kp * (ctrl.pos_target - dof_pos) - kd * dof_vel
    pd_vel = kd * (ctrl.vel_target - dof_vel)
    tau = torch.where(mode == DRIVE_POS, pd_pos, zero)
    tau = torch.where(mode == DRIVE_VEL, pd_vel, tau)
    tau = torch.where(mode == DRIVE_EFFORT, ctrl.effort + zero, tau)
    return torch.clamp(tau, -model.dof_effort, model.dof_effort)


def passive_force(model: SimModel, dof_pos, dof_vel):
    """Soft joint-limit springs + regularized Coulomb joint friction + passive
    damping of drive-less dofs."""
    zero = torch.zeros_like(dof_pos)
    below = torch.clamp(dof_pos - model.dof_lower, max=0.0)
    above = torch.clamp(dof_pos - model.dof_upper, min=0.0)
    violated = ((below < 0.0) | (above > 0.0)).to(dof_pos.dtype)
    tau_lim = torch.where(
        model.dof_has_limit,
        -_LIMIT_STIFFNESS * (below + above) - _LIMIT_DAMPING * dof_vel * violated,
        zero,
    )
    tau_fric = -model.dof_friction * torch.tanh(dof_vel / _FRICTION_VEL_EPS)
    mode = model.dof_drive_mode
    passive_damped = (mode == DRIVE_NONE) | (mode == DRIVE_EFFORT)
    tau_damp = torch.where(passive_damped, -model.dof_damping * dof_vel, zero)
    return tau_lim + tau_fric + tau_damp


def _implicit_drive_terms(model: SimModel, h: float, dof_pos: torch.Tensor) -> torch.Tensor:
    """Joint-space diagonal of the backward-Euler spring-dampers: h*Kd + h^2*Kp
    for the PD drives, the violated limits and the linearized joint friction."""
    mode = model.dof_drive_mode
    kp = torch.where(mode == DRIVE_POS, model.dof_stiffness, torch.zeros_like(model.dof_stiffness))
    kd = model.dof_damping
    at_limit = (model.dof_has_limit & ((dof_pos < model.dof_lower) | (dof_pos > model.dof_upper))).to(dof_pos.dtype)
    kp = kp + _LIMIT_STIFFNESS * at_limit
    kd = kd + _LIMIT_DAMPING * at_limit
    kd = kd + model.dof_friction / _FRICTION_VEL_EPS
    return h * kd + h * h * kp


def _clamp_root_vel(model: SimModel, qd: torch.Tensor) -> torch.Tensor:
    """Clamp free-root velocities at the PhysX per-body limits (in place)."""
    for b in range(model.nb):
        if model.jtype[b] != JT_FREE:
            continue
        va = model.v_adr[b]
        qd[..., va : va + 3] = torch.clamp(qd[..., va : va + 3], -_MAX_ROOT_ANGVEL, _MAX_ROOT_ANGVEL)
        qd[..., va + 3 : va + 6] = torch.clamp(qd[..., va + 3 : va + 6], -_MAX_ROOT_LINVEL, _MAX_ROOT_LINVEL)
    return qd


def _integrate(model: SimModel, q: torch.Tensor, qd_new: torch.Tensor, dt: float) -> torch.Tensor:
    """Semi-implicit Euler position update (free joints via the quat exp map)."""
    q_new = q.clone()
    for b in range(model.nb):
        if model.jtype[b] != JT_FREE:
            continue
        qa, va = model.q_adr[b], model.v_adr[b]
        quat = q[..., qa + 3 : qa + 7]
        omega_w = maths.quat_rotate(quat, qd_new[..., va : va + 3])
        v_w = maths.quat_rotate(quat, qd_new[..., va + 3 : va + 6])
        q_new[..., qa : qa + 3] = q[..., qa : qa + 3] + v_w * dt
        q_new[..., qa + 3 : qa + 7] = maths.quat_integrate(quat, omega_w, dt)
    if model.nd > 0:
        qi, vi = list(model.dof_q_adr), list(model.dof_v_adr)
        q_new[..., qi] = q[..., qi] + qd_new[..., vi] * dt
    return q_new


def _substep(model: SimModel, terrain, q, qd, ctrl: Control, slip_g, h: float):
    """One substep on raw arrays.

    Returns (q_new, qd_new, dof_force, contact_force, contact_torque, slip_g_new).
    """
    kin = kinematics.fk(model, q, qd)
    ang_w, lin_w = kinematics.world_velocities(model, kin)
    body_pos_w = torch.stack(kin.p_w, dim=-2)
    body_ang_w = torch.stack(ang_w, dim=-2)
    body_lin_w = torch.stack(lin_w, dim=-2)

    gb = list(model.geom_body)
    R_w = torch.stack(kin.R_w, dim=-3)
    off_w = (R_w[..., gb, :, :] @ model.geom_offset.unsqueeze(-1)).squeeze(-1)
    geom_pos_w = body_pos_w[..., gb, :] + off_w
    geom_vel_w = body_lin_w[..., gb, :] + torch.linalg.cross(body_ang_w[..., gb, :], off_w, dim=-1)
    act_g = contact_mod.ground_active(model, terrain, geom_pos_w)
    n_act = contact_mod.body_active_counts(model, act_g, geom_pos_w.shape[:-2])
    f_ext, body_cf, slip_g = contact_mod.contact_forces(
        model, terrain, geom_pos_w, geom_vel_w, body_pos_w, h=h,
        n_active=n_act, slip=slip_g, geom_ang_w=body_ang_w[..., gb, :],
    )

    vi = list(model.dof_v_adr)
    dof_p, dof_v = q[..., list(model.dof_q_adr)], qd[..., vi]
    tau_dof = actuation_force(model, dof_p, dof_v, ctrl) + passive_force(model, dof_p, dof_v)
    tau = torch.zeros_like(qd)
    tau[..., vi] = tau_dof
    d_imp = _implicit_drive_terms(model, h, dof_p)
    qdd = dynamics.aba(model, kin, tau, f_ext, d_extra=d_imp)

    qd_new = qd + qdd * h
    qd_new[..., vi] = torch.clamp(qd_new[..., vi], -model.dof_maxvel, model.dof_maxvel)
    qd_new = _clamp_root_vel(model, qd_new)
    q_new = _integrate(model, q, qd_new, h)
    # contact and dof forces are those of the last substep (PhysX CC_LAST_SUBSTEP)
    return q_new, qd_new, tau_dof, body_cf, f_ext[..., :3], slip_g


def _substeps_plain(model: SimModel, terrain, q, qd, ctrl: Control, slip_g, h: float, substeps: int):
    """`substeps` x `_substep`: the plain version of the fused kernel."""
    for _ in range(substeps):
        q, qd, dof_force, cf, ct, slip_g = _substep(model, terrain, q, qd, ctrl, slip_g, h)
    return q, qd, dof_force, cf, ct, slip_g


def _check_supported(model: SimModel, terrain, ctrl: Control) -> None:
    unsupported = {
        "heightfield terrain": terrain is not None,
        "pair contacts": model.n_pairs,
        "SDF colliders": model.n_sdf,
        "world anchors": model.anchor_body,
        "gravity compensation": model.body_gravcomp is not None,
        "force sensors": model.sensor_body,
        "fixed tendons": model.tendon_dof,
        "no_ground scenes": model.no_ground,
        "body wrenches": ctrl.body_wrench is not None,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def step(model: SimModel, terrain, state: SimState, ctrl: Control, dt: float, substeps: int = 2) -> SimState:
    """Advance one control period: `substeps` x (dt / substeps), then `forward`.

    Contact/dof forces are those of the last substep; the body caches are
    refreshed against the new q/qd."""
    from isaacgymenv_tpu_torch.physics import fused as fused_mod

    _check_supported(model, terrain, ctrl)
    h = dt / substeps
    slip_g = state.slip_g
    if model.ng and slip_g is None:
        # zeros = "no anchor yet": re-anchored on the first active substep
        slip_g = torch.zeros(state.q.shape[:-1] + (model.ng, 3), dtype=state.q.dtype, device=state.q.device)
    n = state.q.shape[0]
    nd = model.nd
    args = (
        state.q, state.qd,
        ctrl.pos_target.expand(n, nd), ctrl.vel_target.expand(n, nd), ctrl.effort.expand(n, nd),
        slip_g, h, substeps,
    )
    if state.q.ndim == 2 and fused_mod.fused_structural_ok(model, n):
        q, qd, dof_force, cf, ct, slip_g = fused_mod.fused_substep(fused_mod.tables_for(model, state.q.device), *args)
    else:
        q, qd, dof_force, cf, ct, slip_g = _substeps_plain(model, terrain, state.q, state.qd, ctrl, slip_g, h, substeps)
    state = dataclasses.replace(
        state, q=q, qd=qd, dof_force=dof_force, contact_force=cf, contact_torque=ct,
        slip_g=slip_g if model.ng else None,
    )
    return forward(model, terrain, state)


def forward(model: SimModel, terrain, state: SimState) -> SimState:
    """Refresh the body pose/velocity caches from (q, qd) without advancing time."""
    kin = kinematics.fk(model, state.q, state.qd)
    ang_w, lin_w = kinematics.world_velocities(model, kin)
    return dataclasses.replace(
        state,
        body_pos=torch.stack(kin.p_w, dim=-2),
        body_quat=maths.rotmat_to_quat(torch.stack(kin.R_w, dim=-3)),
        body_linvel=torch.stack(lin_w, dim=-2),
        body_angvel=torch.stack(ang_w, dim=-2),
    )
