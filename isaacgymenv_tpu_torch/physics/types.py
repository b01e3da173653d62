"""SimModel / SimState: the data model of the physics engine.

Dataclasses of tensors with the field names and shapes of
`isaacgymenv_tpu/physics/types.py`.  Topology (body count, parents, joint
types, dof addressing) is plain Python ints and tuples; parameters and state
are tensors.  State is batched: `q` is `(N, nq)`, `qd` is `(N, nv)`.

Conventions (Isaac Gym's): quaternions are (x, y, z, w); an actor root state
is 13 floats [pos3, quat4, linvel3, angvel3] in the world frame; dof state is
[pos, vel] per 1-DoF joint.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from isaacgymenv_tpu_torch.ops import maths

# joint types
JT_FREE = 0       # 6-DoF floating root: q = [pos3, quat4], qd = [ang3, lin3] body frame
JT_REVOLUTE = 1
JT_PRISMATIC = 2
JT_FIXED = 3
JT_SCREW = 4

# dof drive modes (gymapi.DOF_MODE_*)
DRIVE_NONE = 0
DRIVE_POS = 1
DRIVE_VEL = 2
DRIVE_EFFORT = 3


def _map_tensors(obj, fn):
    """dataclasses.replace(obj) with fn applied to every tensor field."""
    changes = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif isinstance(v, tuple) and v and all(isinstance(x, torch.Tensor) for x in v):
            changes[f.name] = tuple(fn(x) for x in v)
    return dataclasses.replace(obj, **changes)


@dataclass
class SimModel:
    """Static articulated model, replicated across all envs."""

    # --- static topology ---
    nb: int
    nq: int
    nv: int
    nd: int
    parent: Tuple[int, ...]
    jtype: Tuple[int, ...]
    q_adr: Tuple[int, ...]
    v_adr: Tuple[int, ...]
    dof_body: Tuple[int, ...]
    dof_v_adr: Tuple[int, ...]
    dof_q_adr: Tuple[int, ...]
    actor_root: Tuple[int, ...]
    body_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]
    geom_body: Tuple[int, ...]

    # --- joint placement ---
    joint_pos: torch.Tensor    # (nb, 3) joint frame origin in parent frame
    joint_quat: torch.Tensor   # (nb, 4) joint frame rotation in parent frame
    joint_axis: torch.Tensor   # (nb, 3) motion axis in child frame

    # --- body inertial params ---
    body_mass: torch.Tensor     # (nb,)
    body_com: torch.Tensor      # (nb, 3)
    body_inertia: torch.Tensor  # (nb, 3, 3) about the COM, body frame

    # --- per-dof params (nd,) ---
    dof_lower: torch.Tensor
    dof_upper: torch.Tensor
    dof_effort: torch.Tensor
    dof_maxvel: torch.Tensor
    dof_armature: torch.Tensor
    dof_friction: torch.Tensor
    dof_stiffness: torch.Tensor
    dof_damping: torch.Tensor
    dof_drive_mode: torch.Tensor  # int32
    dof_has_limit: torch.Tensor   # bool

    # --- contact spheres attached to bodies (ng,) ---
    geom_offset: torch.Tensor   # (ng, 3)
    geom_radius: torch.Tensor
    geom_friction: torch.Tensor
    geom_meff: torch.Tensor

    gravity: torch.Tensor       # (3,)
    contact_stiffness: torch.Tensor
    contact_damping: torch.Tensor
    tangential_stiffness: torch.Tensor

    # --- body-vs-body surfaces and the static pair list ---
    surf_body: Tuple[int, ...] = ()
    surf_kind: Tuple[int, ...] = ()
    pair_geom: Tuple[int, ...] = ()
    pair_surf: Tuple[int, ...] = ()
    surf_offset: Optional[torch.Tensor] = None
    surf_rotm: Optional[torch.Tensor] = None
    surf_size: Optional[torch.Tensor] = None
    surf_friction: Optional[torch.Tensor] = None
    surf_meff: Optional[torch.Tensor] = None

    # --- world anchors ---
    anchor_body: Tuple[int, ...] = ()
    anchor_offset: Optional[torch.Tensor] = None
    anchor_target: Optional[torch.Tensor] = None
    anchor_meff: Optional[torch.Tensor] = None

    body_gravcomp: Optional[torch.Tensor] = None

    # --- fixed tendons ---
    tendon_dof: Tuple[Tuple[int, ...], ...] = ()
    tendon_coef: Optional[torch.Tensor] = None
    tendon_range: Optional[torch.Tensor] = None
    tendon_k: Optional[torch.Tensor] = None
    tendon_d: Optional[torch.Tensor] = None

    # max-direction effective masses for the elastic contact-stiffness cap
    geom_meff_el: Optional[torch.Tensor] = None
    surf_meff_el: Optional[torch.Tensor] = None

    joint_pitch: Tuple[float, ...] = ()
    sensor_body: Tuple[int, ...] = ()
    no_ground: bool = False

    # --- signed-distance-field colliders (no loader of the port builds them yet) ---
    sdf_body: Tuple[int, ...] = ()
    sdf_pair_geom: Tuple[Tuple[int, ...], ...] = ()
    sdf_dist: Tuple[torch.Tensor, ...] = ()
    sdf_origin: Optional[torch.Tensor] = None
    sdf_spacing: Optional[torch.Tensor] = None
    sdf_friction: Optional[torch.Tensor] = None
    sdf_meff: Optional[torch.Tensor] = None
    sdf_meff_el: Optional[torch.Tensor] = None

    # per-device kernel tables built by physics/fused.py (not a model field)
    fused_cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def ng(self) -> int:
        return len(self.geom_body)

    @property
    def n_pairs(self) -> int:
        return len(self.pair_geom)

    @property
    def n_sdf(self) -> int:
        return len(self.sdf_body)

    @property
    def device(self) -> torch.device:
        return self.joint_pos.device

    def to(self, device) -> "SimModel":
        return _map_tensors(self, lambda t: t.to(device))


@dataclass
class SimState:
    """Batched dynamic state plus the caches `engine.forward` refreshes.

    body_pos/quat: body frame pose in the env-local world frame;
    body_linvel/angvel: world-frame velocity of the body origin;
    contact_force/torque: (N, nb, 3) net contact force and moment about the
    body origin, world frame, from the last substep.
    """

    q: torch.Tensor            # (N, nq)
    qd: torch.Tensor           # (N, nv)
    body_pos: torch.Tensor     # (N, nb, 3)
    body_quat: torch.Tensor    # (N, nb, 4)
    body_linvel: torch.Tensor  # (N, nb, 3)
    body_angvel: torch.Tensor  # (N, nb, 3)
    contact_force: torch.Tensor
    contact_torque: torch.Tensor
    dof_force: torch.Tensor    # (N, nd)
    joint_wrench: Optional[torch.Tensor] = None
    slip_g: Optional[torch.Tensor] = None  # (N, ng, 3) ground stiction springs
    slip_p: Optional[torch.Tensor] = None

    @property
    def N(self) -> int:
        return self.q.shape[0]


def make_zero_state(model: SimModel, n_envs: int) -> SimState:
    """All-zero float32 state with identity quaternions, on the model's device."""
    z = lambda *s: torch.zeros((n_envs,) + s, device=model.device)  # noqa: E731
    q = z(model.nq)
    for b in range(model.nb):
        if model.jtype[b] == JT_FREE:
            q[:, model.q_adr[b] + 6] = 1.0
    body_quat = z(model.nb, 4)
    body_quat[..., 3] = 1.0
    return SimState(
        q=q,
        qd=z(model.nv),
        body_pos=z(model.nb, 3),
        body_quat=body_quat,
        body_linvel=z(model.nb, 3),
        body_angvel=z(model.nb, 3),
        contact_force=z(model.nb, 3),
        contact_torque=z(model.nb, 3),
        dof_force=z(model.nd),
        joint_wrench=z(len(model.sensor_body), 6) if model.sensor_body else None,
        slip_g=z(model.ng, 3) if model.ng else None,
        slip_p=z(model.n_pairs, 3) if model.n_pairs else None,
    )


def dof_pos(model: SimModel, state: SimState) -> torch.Tensor:
    return state.q[..., list(model.dof_q_adr)]


def dof_vel(model: SimModel, state: SimState) -> torch.Tensor:
    return state.qd[..., list(model.dof_v_adr)]


def set_dof_state(model: SimModel, state: SimState, pos: torch.Tensor, vel: torch.Tensor) -> SimState:
    """Write all dof positions and velocities (into fresh q/qd tensors)."""
    q, qd = state.q.clone(), state.qd.clone()
    q[..., list(model.dof_q_adr)] = pos
    qd[..., list(model.dof_v_adr)] = vel
    return dataclasses.replace(state, q=q, qd=qd)


def root_state(model: SimModel, state: SimState) -> torch.Tensor:
    """(N, n_actors, 13) actor root states, world-frame velocities."""
    roots = list(model.actor_root)
    return torch.cat(
        [
            state.body_pos[..., roots, :],
            state.body_quat[..., roots, :],
            state.body_linvel[..., roots, :],
            state.body_angvel[..., roots, :],
        ],
        dim=-1,
    )


def set_root_state(model: SimModel, state: SimState, rs: torch.Tensor) -> SimState:
    """Write free-base actor root states; rs is (N, n_actors, 13) or (N, 13).

    World-frame velocities are stored as the body-frame [omega_b, v_b] of the
    free joint.  Call `engine.forward` afterwards to refresh the caches.
    """
    if rs.ndim == state.q.ndim:
        rs = rs[..., None, :]
    q, qd = state.q.clone(), state.qd.clone()
    for a, b in enumerate(model.actor_root):
        if model.jtype[b] != JT_FREE:
            continue
        qa, va = model.q_adr[b], model.v_adr[b]
        quat = maths.quat_unit(rs[..., a, 3:7])
        q[..., qa : qa + 3] = rs[..., a, 0:3]
        q[..., qa + 3 : qa + 7] = quat
        qd[..., va : va + 3] = maths.quat_rotate_inverse(quat, rs[..., a, 10:13])
        qd[..., va + 3 : va + 6] = maths.quat_rotate_inverse(quat, rs[..., a, 7:10])
    return dataclasses.replace(state, q=q, qd=qd)
