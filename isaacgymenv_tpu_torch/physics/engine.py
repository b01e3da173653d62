"""The simulation step: actuation -> contacts -> forward dynamics -> integrate.

Counterpart of `isaacgymenv_tpu/physics/engine.py`.  `step` advances one
control period of `substeps` substeps through one of three paths, which
`_use_fused` picks:
- "mono": `fused.fused_substep`, one CUDA kernel for all substeps (B1), for
  scenes without pairs, tendons or `no_ground`, on the plane or on a
  heightfield, with per-env friction or without, force sensors and a
  per-body external wrench (`Control.body_wrench`) or without;
- "split": `fused_split.split_substep`, a contacts kernel and a dynamics
  kernel per substep (B2 + B3), for scenes with pairs, tendons or
  `no_ground` within the split tables' caps, with world anchors, force
  sensors and body wrenches or without;
- None: the plain `_substep` loop below.
A CUDA state on a kernel path launches the kernels; a CPU state runs their
plain version, which is the `_substep` loop.

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
    against (N, nd).  `body_wrench` (N, nb, 6) or None: an external wrench on
    each body, world frame, [moment, force] about the body origin, added to
    f_ext after the contacts and anchors."""

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
    damping of drive-less dofs + fixed-tendon limit springs."""
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
    tau = tau_lim + tau_fric + tau_damp
    if model.tendon_dof:
        # tendon length L = sum(coef * q) held in [lo, hi] by a spring-damper;
        # its generalized force is f * dL/dq = f * coef on each coupled dof
        td = torch.as_tensor(model.tendon_dof, device=dof_pos.device)  # (nt, k)
        tc = model.tendon_coef
        L = (dof_pos[..., td] * tc).sum(-1)
        Ld = (dof_vel[..., td] * tc).sum(-1)
        lo, hi = model.tendon_range[..., 0], model.tendon_range[..., 1]
        viol = torch.clamp(L - hi, min=0.0) + torch.clamp(L - lo, max=0.0)
        f_t = -model.tendon_k * viol - model.tendon_d * Ld * (torch.abs(viol) > 0).to(dof_pos.dtype)
        tau = tau.index_add(-1, td.reshape(-1), (f_t[..., None] * tc).flatten(-2))
    return tau


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


def _geom_world(model: SimModel, kin):
    """World positions and velocities of the body caches and contact spheres."""
    ang_w, lin_w = kinematics.world_velocities(model, kin)
    body_pos_w = torch.stack(kin.p_w, dim=-2)
    body_ang_w = torch.stack(ang_w, dim=-2)
    body_lin_w = torch.stack(lin_w, dim=-2)
    gb = list(model.geom_body)
    R_w = torch.stack(kin.R_w, dim=-3)
    off_w = (R_w[..., gb, :, :] @ model.geom_offset.unsqueeze(-1)).squeeze(-1)
    geom_pos_w = body_pos_w[..., gb, :] + off_w
    geom_vel_w = body_lin_w[..., gb, :] + torch.linalg.cross(body_ang_w[..., gb, :], off_w, dim=-1)
    return body_pos_w, R_w, body_ang_w, body_lin_w, geom_pos_w, geom_vel_w


def _contacts(model: SimModel, terrain, kin, slip_g, slip_p, h: float):
    """Ground and pair contacts and world anchors at the poses of `kin`
    (kinematics.fk).

    Returns (f_ext (N, nb, 6) world [moment, force] about each body origin,
    contact_force (N, nb, 3) of the ground and pair contacts, slip_g, slip_p)."""
    body_pos_w, R_w, body_ang_w, body_lin_w, geom_pos_w, geom_vel_w = _geom_world(model, kin)
    act_g = None if model.no_ground else contact_mod.ground_active(model, terrain, geom_pos_w)
    act_p = contact_mod.pair_active(model, geom_pos_w, body_pos_w, R_w)
    n_act = contact_mod.body_active_counts(model, act_g, act_p, geom_pos_w.shape[:-2], device=geom_pos_w.device)
    if model.no_ground:
        # the scene guarantees no geom reaches the ground plane (SimModel.no_ground)
        f_ext = torch.zeros(body_pos_w.shape[:-1] + (6,), dtype=body_pos_w.dtype, device=body_pos_w.device)
        body_cf = f_ext[..., 3:]
    else:
        f_ext, body_cf, slip_g = contact_mod.contact_forces(
            model, terrain, geom_pos_w, geom_vel_w, body_pos_w, h=h,
            n_active=n_act, slip=slip_g, geom_ang_w=body_ang_w[..., list(model.geom_body), :],
        )
    if model.n_pairs:
        f_pair, cf_pair, slip_p = contact_mod.pair_contact_forces(
            model, geom_pos_w, body_pos_w, R_w, body_lin_w, body_ang_w, h=h,
            n_active=n_act, slip=slip_p,
        )
        f_ext = f_ext + f_pair
        body_cf = body_cf + cf_pair
    if model.anchor_body:
        f_ext = f_ext + contact_mod.anchor_forces(model, body_pos_w, R_w, body_lin_w, body_ang_w, h)
    return f_ext, body_cf, slip_g, slip_p


def _dynamics(model: SimModel, kin, q, qd, ctrl: Control, f_ext, h: float):
    """Joint forces -> ABA with f_ext -> integration, at the poses of `kin`.

    Returns (q_new, qd_new, dof_force, joint_wrench): joint_wrench (N, ns, 6)
    is the force-sensor reading of each `model.sensor_body`, the wrench its
    inbound joint transmits, [force(3), torque(3)] in the body frame (the
    layout of the reference's force sensors); None without sensors."""
    vi = list(model.dof_v_adr)
    dof_p, dof_v = q[..., list(model.dof_q_adr)], qd[..., vi]
    tau_dof = actuation_force(model, dof_p, dof_v, ctrl) + passive_force(model, dof_p, dof_v)
    tau = torch.zeros_like(qd)
    tau[..., vi] = tau_dof
    d_imp = _implicit_drive_terms(model, h, dof_p)
    joint_wrench = None
    if model.sensor_body:
        qdd, fj = dynamics.aba(model, kin, tau, f_ext, d_extra=d_imp, return_joint_forces=True)
        fj = fj[..., list(model.sensor_body), :]  # rows [n, f]
        joint_wrench = torch.cat([fj[..., 3:], fj[..., :3]], dim=-1)
    else:
        qdd = dynamics.aba(model, kin, tau, f_ext, d_extra=d_imp)

    qd_new = qd + qdd * h
    qd_new[..., vi] = torch.clamp(qd_new[..., vi], -model.dof_maxvel, model.dof_maxvel)
    qd_new = _clamp_root_vel(model, qd_new)
    return _integrate(model, q, qd_new, h), qd_new, tau_dof, joint_wrench


def _substep(model: SimModel, terrain, q, qd, ctrl: Control, slip_g, slip_p, h: float):
    """One substep on raw arrays.

    Returns (q_new, qd_new, dof_force, contact_force, contact_torque, slip_g,
    slip_p, joint_wrench); joint_wrench is None without sensors.  The contact
    torque is the moment of the contacts and anchors, without
    `ctrl.body_wrench`.
    """
    kin = kinematics.fk(model, q, qd)
    f_ext, body_cf, slip_g, slip_p = _contacts(model, terrain, kin, slip_g, slip_p, h)
    contact_torque = f_ext[..., :3]
    if ctrl.body_wrench is not None:
        f_ext = f_ext + ctrl.body_wrench
    q_new, qd_new, tau_dof, joint_wrench = _dynamics(model, kin, q, qd, ctrl, f_ext, h)
    # contact, dof and sensor forces are those of the last substep (PhysX CC_LAST_SUBSTEP)
    return q_new, qd_new, tau_dof, body_cf, contact_torque, slip_g, slip_p, joint_wrench


def _substeps_plain(model: SimModel, terrain, q, qd, ctrl: Control, slip_g, slip_p, h: float, substeps: int):
    """`substeps` x `_substep`: the plain version of the substep kernels."""
    for _ in range(substeps):
        q, qd, dof_force, cf, ct, slip_g, slip_p, jw = _substep(model, terrain, q, qd, ctrl, slip_g, slip_p, h)
    return q, qd, dof_force, cf, ct, slip_g, slip_p, jw


def _check_supported(model: SimModel, terrain, kind: Optional[str], device_type: str) -> None:
    """Raise on a scene that no path of the port runs as the JAX package does.

    Heightfield terrain and per-env friction (`geom_friction` (N, ng)) run on
    B1 on the card and in the plain loop on the CPU; on the card a scene
    that does not go to B1 (`kind` "split", or None: over the kernels' caps,
    or per-env leaves B1 does not take) raises instead of quietly running
    the plain loop there.  Force sensors run on B1 and on the split pair
    (B3's sensor output); on the card they raise off both.  World anchors
    run on the split pair and in the plain loop; B1 has no anchor mode yet,
    so an anchored B1 scene raises on either device."""
    per_env_friction = model.geom_friction.ndim == 2
    on_card = device_type != "cpu"
    off_b1 = on_card and kind != "mono"
    unsupported = {
        "terrain other than a Heightfield": terrain is not None and not isinstance(terrain, contact_mod.Heightfield),
        "heightfield terrain off B1": off_b1 and terrain is not None,
        "per-env friction off B1": off_b1 and per_env_friction,
        "per-env friction with pair contacts": model.n_pairs and per_env_friction,
        "containment-wall surfaces": any(k not in (0, 1, 2, 3) for k in model.surf_kind),
        "SDF colliders": model.n_sdf,
        "world anchors on B1": kind == "mono" and model.anchor_body,
        "gravity compensation": model.body_gravcomp is not None,
        "force sensors off the kernels": on_card and kind is None and model.sensor_body,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def _use_fused(model: SimModel, q: torch.Tensor) -> Optional[str]:
    """Kernel dispatch: "mono" (B1), "split" (B2 + B3) or None (plain loop).

    This rule is the port's own.  The JAX package sends a scene to the split
    pair only when the mono kernel overflows the TPU's VMEM and the pair
    fits it (`fused_split.split_ok`); that rule refuses ShadowHand at 1024
    envs and more, so on a TPU no task takes the split pair by default.  The
    H100 has no VMEM wall: here the scene's features decide.  B1's CUDA
    subset has no pairs, tendons or `no_ground`; scenes with any of them
    take B2 + B3 within the split tables' caps, and the plain loop above them.
    """
    from isaacgymenv_tpu_torch.physics import fused as fused_mod
    from isaacgymenv_tpu_torch.physics import fused_split as split_mod

    if q.ndim != 2 or not fused_mod.fused_structural_ok(model, q.shape[0]):
        return None
    if not (model.n_pairs or model.tendon_dof or model.no_ground):
        return "mono"
    return "split" if split_mod.split_structural_ok(model) else None


def step(model: SimModel, terrain, state: SimState, ctrl: Control, dt: float, substeps: int = 2) -> SimState:
    """Advance one control period: `substeps` x (dt / substeps), then `forward`.

    Contact/dof forces are those of the last substep; the body caches are
    refreshed against the new q/qd.  On a heightfield, B1 takes the ground
    under each geom sampled once from the cached body poses (`state.body_pos`,
    `body_quat`) and held across the substeps (JAX `engine.step`'s kernel
    semantics); a CPU state runs the plain loop instead, which looks the
    ground up every substep, as the JAX package's CPU backend takes its XLA
    path.  So does a CPU split scene with per-env friction: the split pair's
    plain version has neither mode."""
    kind = _use_fused(model, state.q)
    _check_supported(model, terrain, kind, state.q.device.type)
    if model.sensor_body and state.joint_wrench is None:
        # a state made before the model declared its sensors
        state = dataclasses.replace(state, joint_wrench=torch.zeros(
            state.q.shape[:-1] + (len(model.sensor_body), 6), dtype=state.q.dtype, device=state.q.device))
    if state.q.device.type == "cpu" and (terrain is not None or kind == "split" and model.geom_friction.ndim == 2):
        kind = None
    h = dt / substeps
    z = lambda k: torch.zeros(state.q.shape[:-1] + (k, 3), dtype=state.q.dtype, device=state.q.device)  # noqa: E731
    # zeros = "no anchor yet": re-anchored on the first active substep
    slip_g = z(model.ng) if model.ng and state.slip_g is None else state.slip_g
    slip_p = z(model.n_pairs) if model.n_pairs and state.slip_p is None else state.slip_p
    n = state.q.shape[0]
    nd = model.nd
    targets = (ctrl.pos_target.expand(n, nd), ctrl.vel_target.expand(n, nd), ctrl.effort.expand(n, nd))
    bw = None if ctrl.body_wrench is None else ctrl.body_wrench.expand(n, model.nb, 6)
    if kind == "mono":
        from isaacgymenv_tpu_torch.physics import fused as fused_mod

        modes = {"geom_fric": model.geom_friction if model.geom_friction.ndim == 2 else None}
        if terrain is not None:
            held = contact_mod.held_ground(model, terrain, state.body_pos, state.body_quat)
            modes.update(ground_h=held.height, ground_n=held.normal)
        q, qd, dof_force, cf, ct, slip_g, jw = fused_mod.fused_substep(
            fused_mod.tables_for(model, state.q.device), state.q, state.qd, *targets, slip_g, h, substeps,
            body_wrench=bw, **modes
        )
    elif kind == "split":
        from isaacgymenv_tpu_torch.physics import fused_split as split_mod

        q, qd, dof_force, cf, ct, slip_g, slip_p, jw = split_mod.split_substep(
            split_mod.tables_for(model, state.q.device), state.q, state.qd, *targets, slip_g, slip_p, h, substeps,
            body_wrench=bw,
        )
    else:
        q, qd, dof_force, cf, ct, slip_g, slip_p, jw = _substeps_plain(
            model, terrain, state.q, state.qd, ctrl, slip_g, slip_p, h, substeps
        )
    state = dataclasses.replace(
        state, q=q, qd=qd, dof_force=dof_force, contact_force=cf, contact_torque=ct, joint_wrench=jw,
        slip_g=slip_g if model.ng else None, slip_p=slip_p if model.n_pairs else None,
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
