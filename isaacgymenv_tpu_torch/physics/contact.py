"""Soft (penalty) contact of body-attached spheres with the ground and with
the body-vs-body surfaces of the static pair list.

Counterpart of the ground and pair paths of `isaacgymenv_tpu/physics/contact.py`:
compliant Hunt-Crossley normal force with the impulse caps, anchored-spring
stiction projected onto the Coulomb cone, and the live per-body contact
counts that renormalize every contact's effective-mass budget.  The ground
is the flat plane z = 0 (`terrain=None`) or a `Heightfield` with the
reference's two-corner-min height lookup; the surfaces are spheres, boxes,
capsules and capped cylinders.  The containment wall (`SURF_WALL`), anchors
and SDFs are not ported.

Where the ground is looked up: the plain `engine._substep` loop looks the
heightfield up every substep at the current geom positions, as the JAX XLA
path does.  The fused kernel (B1) takes the ground height and normal per
geom sampled once per control step (`held_ground`) and holds them across the
substeps; its plain version passes that `HeldGround` here as the terrain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import spatial


@dataclass
class Heightfield:
    """Env-shared terrain grid (host-generated, `utils/terrain.py`)."""

    heights: torch.Tensor  # (H, W) heights in meters (row = x, col = y)
    hscale: float          # meters per cell
    border_x: float        # world x of grid row 0
    border_y: float        # world y of grid col 0

    def to(self, device) -> "Heightfield":
        return Heightfield(self.heights.to(device), self.hscale, self.border_x, self.border_y)


@dataclass
class HeldGround:
    """Ground height (N, ng) and unit normal (N, ng, 3) per geom, sampled
    once per control step and held across its substeps (the kernel's
    semantics, `held_ground`)."""

    height: torch.Tensor
    normal: torch.Tensor


def height_at(terrain: Optional[Heightfield], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Terrain height under world (x, y).

    The reference's two-corner-min lookup: the min of the cell corner and its
    +1,+1 diagonal, not a bilinear value, with the indices truncated toward
    zero and clipped to [0, H-2] x [0, W-2].  The cell index is computed as
    the JAX package does, (x - border) / hscale then truncation; the divisor
    is a tensor so that CUDA divides too (a Python-scalar divisor becomes a
    multiplication by its reciprocal there, which moves cell edges).
    """
    if terrain is None:
        return torch.zeros_like(x)
    H, W = terrain.heights.shape
    hscale = torch.tensor(terrain.hscale, dtype=x.dtype, device=x.device)
    ix = torch.clamp(((x - terrain.border_x) / hscale).to(torch.int32), 0, H - 2).long()
    iy = torch.clamp(((y - terrain.border_y) / hscale).to(torch.int32), 0, W - 2).long()
    return torch.minimum(terrain.heights[ix, iy], terrain.heights[ix + 1, iy + 1])


def terrain_normal(terrain: Optional[Heightfield], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Surface normal by central differences of `height_at` at +-hscale."""
    if terrain is None:
        n = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
        n[..., 2] = 1.0
        return n
    eps = terrain.hscale
    two_eps = torch.tensor(2 * eps, dtype=x.dtype, device=x.device)
    dhdx = (height_at(terrain, x + eps, y) - height_at(terrain, x - eps, y)) / two_eps
    dhdy = (height_at(terrain, x, y + eps) - height_at(terrain, x, y - eps)) / two_eps
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(x)], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def held_ground(model, terrain: Heightfield, body_pos: torch.Tensor, body_quat: torch.Tensor) -> HeldGround:
    """Ground height and normal under every geom at the cached body poses
    (N, nb, 3) / (N, nb, 4), as JAX `engine.step` samples them for the
    fused kernel once per control step."""
    gb = list(model.geom_body)
    off = model.geom_offset.expand(body_pos.shape[0], model.ng, 3)
    gpos = body_pos[:, gb] + maths.quat_rotate(body_quat[:, gb], off)
    gx, gy = gpos[..., 0], gpos[..., 1]
    return HeldGround(height_at(terrain, gx, gy), terrain_normal(terrain, gx, gy))


def _height_under(terrain, geom_pos_w: torch.Tensor) -> Optional[torch.Tensor]:
    """(..., ng) ground height under each geom: None for the plane, looked
    up in a `Heightfield`, or held."""
    if terrain is None:
        return None
    if isinstance(terrain, HeldGround):
        return terrain.height
    return height_at(terrain, geom_pos_w[..., 0], geom_pos_w[..., 1])


def _normal_under(terrain, geom_pos_w: torch.Tensor) -> torch.Tensor:
    """(..., ng, 3) unit ground normal under each geom."""
    if isinstance(terrain, HeldGround):
        return terrain.normal
    return terrain_normal(terrain, geom_pos_w[..., 0], geom_pos_w[..., 1])


def _depth(model, hgt: Optional[torch.Tensor], geom_pos_w: torch.Tensor) -> torch.Tensor:
    """Penetration along +z of each sphere's bottom below the ground (the
    plane's arithmetic unchanged when there is no height)."""
    if hgt is None:
        return model.geom_radius - geom_pos_w[..., 2]
    return hgt + model.geom_radius - geom_pos_w[..., 2]


def ground_active(model, terrain, geom_pos_w: torch.Tensor) -> torch.Tensor:
    """(..., ng) bool: geoms penetrating the ground."""
    return _depth(model, _height_under(terrain, geom_pos_w), geom_pos_w) > 0.0


def _pair_tables(model, device):
    """Index tensors of the pair list: (geom, geom body, surface, surface
    body, surface kind) per pair."""
    idx = lambda v: torch.as_tensor(v, dtype=torch.long, device=device)  # noqa: E731
    return (
        idx(model.pair_geom),
        idx([model.geom_body[g] for g in model.pair_geom]),
        idx(model.pair_surf),
        idx([model.surf_body[s] for s in model.pair_surf]),
        idx([model.surf_kind[s] for s in model.pair_surf]),
    )


def _pair_frames(model, geom_pos_w, body_pos_w, body_R_w):
    """Sphere centers c (..., np, 3), surface frames R_s (..., np, 3, 3) and
    the centers in those frames, local (..., np, 3)."""
    pg, _, ps, sb, _ = _pair_tables(model, geom_pos_w.device)
    c = geom_pos_w[..., pg, :]
    Rb = body_R_w[..., sb, :, :]
    R_s = Rb @ model.surf_rotm[ps]
    p_s = body_pos_w[..., sb, :] + (Rb @ model.surf_offset[ps].unsqueeze(-1)).squeeze(-1)
    local = (R_s.transpose(-1, -2) @ (c - p_s).unsqueeze(-1)).squeeze(-1)
    return c, R_s, local


def pair_depth(model, geom_pos_w, body_pos_w, body_R_w) -> torch.Tensor:
    """(..., np) penetration depth of each pair's sphere into its surface."""
    pg, _, ps, _, kind = _pair_tables(model, geom_pos_w.device)
    _, _, local = _pair_frames(model, geom_pos_w, body_pos_w, body_R_w)
    _, d_surf = _surface_closest(kind, local, model.surf_size[ps])
    return model.geom_radius[pg] - d_surf


def pair_active(model, geom_pos_w, body_pos_w, body_R_w) -> Optional[torch.Tensor]:
    """(..., np) bool: pair contacts currently penetrating; None without pairs."""
    if not model.n_pairs:
        return None
    return pair_depth(model, geom_pos_w, body_pos_w, body_R_w) > 0.0


def body_active_counts(model, act_g: Optional[torch.Tensor], act_p: Optional[torch.Tensor], batch_shape,
                       device=None) -> torch.Tensor:
    """(..., nb) number of active contacts loading each body, at least 1.

    A ground contact loads its geom's body, a pair contact both bodies.
    Each contact's stiffness/impulse budget is divided by its body's live
    count, so the sum over simultaneous contacts stays within the stability
    bound while a single contact keeps its full budget."""
    device = device if act_g is None else act_g.device
    counts = torch.zeros(batch_shape + (model.nb,), dtype=torch.float32, device=device)
    if act_g is not None:
        gb = torch.as_tensor(model.geom_body, device=device)
        counts = counts.index_add(-1, gb, act_g.to(torch.float32))
    if act_p is not None:
        _, pgb, _, psb, _ = _pair_tables(model, device)
        ap = act_p.to(torch.float32)
        counts = counts.index_add(-1, pgb, ap).index_add(-1, psb, ap)
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
    """Per-body external forces from ground contact (`terrain`: None for the
    plane, a `Heightfield`, or a `HeldGround`).

    Returns f_ext_world (..., nb, 6) [moment, force] about each body origin in
    world axes, body_contact_force (..., nb, 3), and slip_new (..., ng, 3).
    """
    radius = model.geom_radius
    n = _normal_under(terrain, geom_pos_w)
    depth = _depth(model, _height_under(terrain, geom_pos_w), geom_pos_w)
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


def _surface_closest(kind: torch.Tensor, local: torch.Tensor, size: torch.Tensor):
    """Closest feature of the surface to a sphere center.

    kind (np,) int: 0 sphere [R], 1 box [half extents], 2 capsule [R, half
    length] and 3 capped cylinder [R, half length], both along local z;
    local (..., np, 3) centers in the surface frame; size (np, 3).
    Returns (normal (..., np, 3) in the surface frame, pointing away from the
    surface; signed distance (..., np) from the surface to the center,
    negative inside).  Every kind is evaluated and the pair's kind selected.
    """
    eps = 1e-9
    # sphere
    dist_c = torch.linalg.norm(local, dim=-1)
    n_sph = local / torch.clamp(dist_c, min=eps)[..., None]
    d_sph = dist_c - size[..., 0]

    # box
    q = torch.maximum(torch.minimum(local, size), -size)
    delta = local - q
    dist_out = torch.linalg.norm(delta, dim=-1)
    n_out = delta / torch.clamp(dist_out, min=eps)[..., None]
    face = size - torch.abs(local)  # >= 0 inside
    k = torch.argmin(face, dim=-1, keepdim=True)
    n_in = torch.sign(torch.gather(local, -1, k)) * torch.nn.functional.one_hot(k[..., 0], 3).to(local.dtype)
    d_in = -torch.gather(face, -1, k)[..., 0]
    inside = dist_out <= eps
    n_box = torch.where(inside[..., None], n_in, n_out)
    d_box = torch.where(inside, d_in, dist_out)

    # capsule
    seg_z = torch.maximum(torch.minimum(local[..., 2], size[..., 1]), -size[..., 1])
    d_vec = torch.stack([local[..., 0], local[..., 1], local[..., 2] - seg_z], dim=-1)
    dist_seg = torch.linalg.norm(d_vec, dim=-1)
    n_cap = d_vec / torch.clamp(dist_seg, min=eps)[..., None]
    d_cap = dist_seg - size[..., 0]

    # capped cylinder (flat caps)
    rho = torch.linalg.norm(local[..., 0:2], dim=-1)
    radial_dir = local[..., 0:2] / torch.clamp(rho, min=eps)[..., None]
    dr = rho - size[..., 0]
    dz = torch.abs(local[..., 2]) - size[..., 1]
    out_r = torch.clamp(dr, min=0.0)
    out_z = torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(out_r * out_r + out_z * out_z)
    d_in_cyl = torch.maximum(dr, dz)
    d_cyl = torch.where(d_in_cyl < 0, d_in_cyl, d_out)
    sz = torch.sign(local[..., 2])
    n_out_vec = torch.cat([out_r[..., None] * radial_dir, (out_z * sz)[..., None]], dim=-1)
    n_out_cyl = n_out_vec / torch.clamp(d_out, min=eps)[..., None]
    zeros2 = torch.zeros_like(radial_dir)
    n_cap_in = torch.cat([zeros2, sz[..., None]], dim=-1)
    n_rad_in = torch.cat([radial_dir, torch.zeros_like(sz)[..., None]], dim=-1)
    n_in_cyl = torch.where((dz > dr)[..., None], n_cap_in, n_rad_in)
    n_cyl = torch.where((d_in_cyl < 0)[..., None], n_in_cyl, n_out_cyl)

    n = n_cap
    n = torch.where((kind == 0)[..., None], n_sph, n)
    n = torch.where((kind == 1)[..., None], n_box, n)
    n = torch.where((kind == 3)[..., None], n_cyl, n)
    d = d_cap
    d = torch.where(kind == 0, d_sph, d)
    d = torch.where(kind == 1, d_box, d)
    d = torch.where(kind == 3, d_cyl, d)
    return n, d


def pair_contact_forces(
    model,
    geom_pos_w: torch.Tensor,   # (..., ng, 3)
    body_pos_w: torch.Tensor,   # (..., nb, 3)
    body_R_w: torch.Tensor,     # (..., nb, 3, 3)
    body_lin_w: torch.Tensor,   # (..., nb, 3)
    body_ang_w: torch.Tensor,   # (..., nb, 3)
    h: float,
    n_active: Optional[torch.Tensor] = None,  # (..., nb) live contact counts
    slip: Optional[torch.Tensor] = None,      # (..., np, 3) stiction state
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Body-vs-body contact over the static (sphere, surface) pair list.

    The ground's Hunt-Crossley + anchored-spring stiction law on the pair's
    reduced effective mass; equal and opposite forces on the two bodies.
    Returns (f_ext (..., nb, 6), body_contact_force (..., nb, 3), slip_new).
    """
    pg, gb, ps, sb, kind = _pair_tables(model, geom_pos_w.device)
    c, R_s, local = _pair_frames(model, geom_pos_w, body_pos_w, body_R_w)
    r = model.geom_radius[pg]
    n_local, d_surf = _surface_closest(kind, local, model.surf_size[ps])
    n = (R_s @ n_local.unsqueeze(-1)).squeeze(-1)  # world, away from the surface
    depth = r - d_surf
    active = depth > 0.0

    # contact point: on the sphere, toward the surface
    x_c = c - n * r[..., None]
    lever_g = x_c - body_pos_w[..., gb, :]
    lever_s = x_c - body_pos_w[..., sb, :]
    v_g = body_lin_w[..., gb, :] + spatial.cross(body_ang_w[..., gb, :], lever_g)
    v_s = body_lin_w[..., sb, :] + spatial.cross(body_ang_w[..., sb, :], lever_s)
    v_rel = v_g - v_s
    v_n = (v_rel * n).sum(-1)
    v_t = v_rel - v_n[..., None] * n

    kn, kd, kt = model.contact_stiffness, model.contact_damping, model.tangential_stiffness
    if n_active is not None:
        share_g = 1.0 / n_active[..., gb]
        share_s = 1.0 / n_active[..., sb]
    else:
        share_g = share_s = 1.0
    m_g = model.geom_meff[pg] * share_g
    m_s = model.surf_meff[ps] * share_s
    m_pair = m_g * m_s / (m_g + m_s)  # reduced mass of the pair
    kappa, kappa_n = 0.25, 1.0
    arrest = kappa * m_pair / h
    arrest_n = kappa_n * m_pair / h
    g_el = model.geom_meff_el if model.geom_meff_el is not None else model.geom_meff
    s_el = model.surf_meff_el if model.surf_meff_el is not None else model.surf_meff
    m_g_el = g_el[pg] * share_g
    m_s_el = s_el[ps] * share_s
    m_pair_el = m_g_el * m_s_el / (m_g_el + m_s_el)
    kn_eff = torch.minimum(kn, m_pair_el / (h * h))

    d_pos = torch.clamp(torch.clamp(depth, min=0.0), max=0.05)
    f_damp = torch.minimum(kd * d_pos, arrest_n) * (-v_n)
    fn = torch.clamp(kn_eff * d_pos + f_damp, min=0.0)
    fn = torch.where(active, fn, torch.zeros_like(fn))

    mu = torch.sqrt(model.geom_friction[pg] * model.surf_friction[ps]).expand(v_n.shape)
    kt_el = torch.minimum(kt, m_pair / (h * h)).expand(v_n.shape)
    ct = torch.minimum(arrest, kt).expand(v_n.shape)
    if slip is None:
        slip = torch.zeros_like(c)
    ft, slip_new = stiction_force(slip, v_t, n, fn, mu, kt_el, ct, h, active)
    f = fn[..., None] * n + ft  # force on the sphere's body

    shape = body_pos_w.shape
    zeros = torch.zeros(shape, dtype=f.dtype, device=f.device)
    body_force = zeros.index_add(-2, gb, f).index_add(-2, sb, -f)
    body_torque = zeros.index_add(-2, gb, spatial.cross(lever_g, f)).index_add(
        -2, sb, spatial.cross(lever_s, -f)
    )
    return torch.cat([body_torque, body_force], dim=-1), body_force, slip_new
