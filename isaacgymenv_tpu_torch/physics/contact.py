"""Soft (penalty) contact between body-attached spheres and the ground plane.

Counterpart of the ground path of `isaacgymenv_tpu/physics/contact.py`:
compliant Hunt-Crossley normal force with the impulse caps, anchored-spring
stiction projected onto the Coulomb cone, and the live per-body contact
counts that renormalize every contact's effective-mass budget.  Only the
flat plane (`terrain=None`) is ported; heightfields, pairs and SDFs are not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from isaacgymenv_tpu_torch.physics import spatial


def _require_flat(terrain) -> None:
    if terrain is not None:
        raise NotImplementedError("heightfield terrain is not ported; only terrain=None")


def ground_active(model, terrain, geom_pos_w: torch.Tensor) -> torch.Tensor:
    """(..., ng) bool: geoms penetrating the ground plane z = 0."""
    _require_flat(terrain)
    return (model.geom_radius - geom_pos_w[..., 2]) > 0.0


def body_active_counts(model, act_g: torch.Tensor, batch_shape) -> torch.Tensor:
    """(..., nb) number of active contacts loading each body, at least 1.

    Each contact's stiffness/impulse budget is divided by its body's live
    count, so the sum over simultaneous contacts stays within the stability
    bound while a single contact keeps its full budget."""
    counts = torch.zeros(batch_shape + (model.nb,), dtype=torch.float32, device=act_g.device)
    gb = torch.as_tensor(model.geom_body, device=act_g.device)
    counts = counts.index_add(-1, gb, act_g.to(torch.float32))
    return torch.clamp(counts, min=1.0)


def stiction_force(slip, v_t, n, fn, mu, kt_el, ct, h, active):
    """Anchored-spring stiction with Coulomb-cone projection.

    Advance the tangential spring `slip` (..., k, 3) by the slip velocity,
    evaluate the spring-damper force, clamp it to the friction cone; while
    clamped the anchor slides so the spring alone sits on the cone boundary.
    Returns (f_t, slip_new).
    """
    s = slip + v_t * h
    s = s - (s * n).sum(-1, keepdim=True) * n
    f_trial = -kt_el[..., None] * s - ct[..., None] * v_t
    f_mag = torch.linalg.norm(f_trial, dim=-1)
    f_max = mu * fn
    clamp = f_mag > f_max
    scale = torch.where(clamp, f_max / torch.clamp(f_mag, min=1e-9), torch.ones_like(f_mag))
    f_t = f_trial * scale[..., None]
    s_new = torch.where(clamp[..., None], -f_t / torch.clamp(kt_el, min=1e-9)[..., None], s)
    s_new = torch.where(active[..., None], s_new, torch.zeros_like(s_new))
    f_t = torch.where(active[..., None], f_t, torch.zeros_like(f_t))
    return f_t, s_new


def contact_forces(
    model,
    terrain,
    geom_pos_w: torch.Tensor,   # (..., ng, 3) sphere centers, world
    geom_vel_w: torch.Tensor,   # (..., ng, 3) sphere-center velocities, world
    body_pos_w: torch.Tensor,   # (..., nb, 3) body origins (torque levers)
    h: float,                   # substep size
    n_active: Optional[torch.Tensor] = None,  # (..., nb) live contact counts
    slip: Optional[torch.Tensor] = None,      # (..., ng, 3) stiction state
    geom_ang_w: Optional[torch.Tensor] = None,  # (..., ng, 3) body angular vel
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-body external forces from ground contact.

    Returns f_ext_world (..., nb, 6) [moment, force] about each body origin in
    world axes, body_contact_force (..., nb, 3), and slip_new (..., ng, 3).
    """
    _require_flat(terrain)
    radius = model.geom_radius
    n = torch.zeros_like(geom_pos_w)
    n[..., 2] = 1.0
    depth = radius - geom_pos_w[..., 2]
    active = depth > 0.0

    kn, kd, kt = model.contact_stiffness, model.contact_damping, model.tangential_stiffness

    v = geom_vel_w
    if geom_ang_w is not None:
        # material velocity at the contact point (sphere bottom)
        v = v + spatial.cross(geom_ang_w, -radius[..., None] * n)
    v_n = (v * n).sum(-1)
    v_t = v - v_n[..., None] * n

    # impulse caps: normal damper at the deadbeat limit m/h (kappa_n = 1),
    # tangential damper at kappa = 0.25 of the momentum per substep
    kappa, kappa_n = 0.25, 1.0
    if n_active is not None:
        share = 1.0 / n_active[..., list(model.geom_body)]
    else:
        share = 1.0
    arrest = kappa * model.geom_meff * share / h
    arrest_n = kappa_n * model.geom_meff * share / h
    m_el = model.geom_meff_el if model.geom_meff_el is not None else model.geom_meff
    kn_eff = torch.minimum(kn, m_el * share / (h * h))

    d_pos = torch.clamp(torch.clamp(depth, min=0.0), max=0.05)
    f_damp = torch.minimum(kd * d_pos, arrest_n) * (-v_n)
    fn = torch.clamp(kn_eff * d_pos + f_damp, min=0.0)
    fn = torch.where(active, fn, torch.zeros_like(fn))

    kt_el = torch.minimum(kt, model.geom_meff * share / (h * h)).expand(v_n.shape)
    ct = torch.minimum(arrest, kt).expand(v_n.shape)
    if slip is None:
        slip = torch.zeros_like(geom_pos_w)
    mu = model.geom_friction.expand(v_n.shape)
    ft, slip_new = stiction_force(slip, v_t, n, fn, mu, kt_el, ct, h, active)

    f_world = fn[..., None] * n + ft
    gb = torch.as_tensor(model.geom_body, device=geom_pos_w.device)
    lever = geom_pos_w - radius[..., None] * n - body_pos_w[..., gb, :]
    torque = spatial.cross(lever, f_world)
    shape = body_pos_w.shape
    body_force = torch.zeros(shape, dtype=f_world.dtype, device=f_world.device).index_add(-2, gb, f_world)
    body_torque = torch.zeros(shape, dtype=f_world.dtype, device=f_world.device).index_add(-2, gb, torque)
    return torch.cat([body_torque, body_force], dim=-1), body_force, slip_new
