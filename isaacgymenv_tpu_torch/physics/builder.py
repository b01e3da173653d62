"""Host-side model builder: accumulates bodies/joints/geoms -> SimModel.

This is the construction path under the URDF/MJCF loaders (the equivalent of
`gym.load_asset` + `create_actor` scene composition, ref: tasks/anymal.py:166-224)
and of procedural test fixtures.  Pure numpy on the host; `finalize`
returns a SimModel of CPU tensors (move it with `SimModel.to`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_NONE,
    JT_FIXED,
    JT_FREE,
    JT_PRISMATIC,
    JT_REVOLUTE,
    JT_SCREW,
    SimModel,
)


def _t(x, dtype):
    """Host value -> CPU tensor of `dtype`."""
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def box_inertia(mass: float, sx: float, sy: float, sz: float) -> np.ndarray:
    """Solid box rotational inertia about COM (full extents sx, sy, sz)."""
    return np.diag(
        [
            mass / 12.0 * (sy * sy + sz * sz),
            mass / 12.0 * (sx * sx + sz * sz),
            mass / 12.0 * (sx * sx + sy * sy),
        ]
    ).astype(np.float64)


def sphere_inertia(mass: float, r: float) -> np.ndarray:
    i = 2.0 / 5.0 * mass * r * r
    return np.diag([i, i, i]).astype(np.float64)


def cylinder_inertia(mass: float, r: float, length: float, axis: int = 2) -> np.ndarray:
    ia = 0.5 * mass * r * r
    ip = mass / 12.0 * (3 * r * r + length * length)
    vals = [ip, ip, ip]
    vals[axis] = ia
    return np.diag(vals).astype(np.float64)


def capsule_inertia(mass: float, r: float, length: float, axis: int = 2) -> np.ndarray:
    """Capsule (cylinder of `length` + hemispherical caps), uniform density."""
    vc = math.pi * r * r * length
    vs = 4.0 / 3.0 * math.pi * r ** 3
    v = vc + vs
    mc, ms = mass * vc / v, mass * vs / v
    ia = 0.5 * mc * r * r + 0.4 * ms * r * r
    ip = (
        mc * (length * length / 12.0 + r * r / 4.0)
        + ms * (0.4 * r * r + length * length / 4.0 + 3.0 / 8.0 * r * length)
    )
    vals = [ip, ip, ip]
    vals[axis] = ia
    return np.diag(vals).astype(np.float64)


@dataclass
class _Body:
    name: str
    parent: int
    jtype: int
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    joint_axis: np.ndarray
    joint_name: str = ""
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    lower: float = -1e9
    upper: float = 1e9
    effort: float = 1e9
    maxvel: float = 1e9
    armature: float = 0.0
    friction: float = 0.0
    stiffness: float = 0.0
    damping: float = 0.0
    drive_mode: int = DRIVE_NONE
    has_limit: bool = False
    pitch: float = 0.0  # screw-joint thread pitch [m/rev]
    gravcomp: float = 0.0  # 1.0 = gravity-free (asset disable_gravity)


class ModelBuilder:
    def __init__(self):
        self.bodies: List[_Body] = []
        self.actor_roots: List[int] = []
        self.geom_body: List[int] = []
        self.sensor_body: List[int] = []
        self.geom_offset: List[np.ndarray] = []
        self.geom_radius: List[float] = []
        self.geom_friction: List[float] = []
        self.surfaces: List[tuple] = []  # (body, kind, offset, rotm, size, friction)
        self.anchors: List[tuple] = []   # (body, offset, world target)
        self.tendons: List[tuple] = []   # (joint names, coefs, lo, hi, k, d)
        self.gravity = np.array([0.0, 0.0, -9.81])
        # Hunt-Crossley units: normal force = kn*d + kd*d*approach_speed;
        # tangential_stiffness only caps the impulse-based stiction
        self.contact_stiffness = 1.0e4
        self.contact_damping = 1.0e5
        self.tangential_stiffness = 1.0e6
        # optional static broadphase: pair_filter(geom_body, surf_body) ->
        # bool keeps/prunes a cross-actor contact pair at build time (the
        # compile-time analog of PhysX's runtime broadphase culling; scenes
        # with many clutter actors use it to bound the static pair list)
        self.pair_filter = None
        self.no_ground = False

    # -- construction ------------------------------------------------------
    def add_body(
        self,
        name: str,
        parent: int,
        jtype: int,
        joint_pos=(0, 0, 0),
        joint_quat=(0, 0, 0, 1),
        joint_axis=(0, 0, 1),
        joint_name: str = "",
        mass: float = 0.0,
        com=(0, 0, 0),
        inertia: Optional[np.ndarray] = None,
        **dof_props,
    ) -> int:
        b = _Body(
            name=name,
            parent=parent,
            jtype=jtype,
            joint_pos=np.asarray(joint_pos, np.float64),
            joint_quat=np.asarray(joint_quat, np.float64),
            joint_axis=np.asarray(joint_axis, np.float64),
            joint_name=joint_name or f"{name}_joint",
            mass=mass,
            com=np.asarray(com, np.float64),
            inertia=np.zeros((3, 3)) if inertia is None else np.asarray(inertia, np.float64),
        )
        for k, v in dof_props.items():
            setattr(b, k, v)
        idx = len(self.bodies)
        self.bodies.append(b)
        if parent < 0:
            self.actor_roots.append(idx)
        return idx

    def add_force_sensor(self, body: int) -> int:
        """Declare a force sensor on `body`: its inbound-joint reaction
        wrench appears in SimState.joint_wrench (the create_asset_force_sensor
        equivalent, ref: tasks/ant.py:174-178 foot sensors)."""
        self.sensor_body.append(body)
        return len(self.sensor_body) - 1

    def add_geom_sphere(self, body: int, offset, radius: float, friction: float = 1.0):
        self.geom_body.append(body)
        self.geom_offset.append(np.asarray(offset, np.float64))
        self.geom_radius.append(float(radius))
        self.geom_friction.append(float(friction))

    # surface kinds
    SURF_SPHERE, SURF_BOX, SURF_CAPSULE, SURF_CYLINDER = 0, 1, 2, 3
    # cylindrical containment band (inward-facing wall): size [R, half_h, -];
    # geoms inside radius R are free, crossing outward makes contact with an
    # inward normal.  The trifinger arena boundary (ref: trifinger.py:187
    # high_table_boundary.urdf).
    SURF_WALL = 4

    def add_tendon(self, joint_names, coefs, lo: float, hi: float, k: float = 30.0, d: float = 0.1):
        """Fixed tendon L = sum(coef*q) limited to [lo, hi] (spring outside).

        joint_names are resolved to dof indices at finalize."""
        self.tendons.append((tuple(joint_names), tuple(float(c) for c in coefs), lo, hi, k, d))

    def add_anchor(self, body: int, offset=(0, 0, 0), target=(0, 0, 0)):
        """Pin a body point to a world target (attractor equivalent)."""
        self.anchors.append(
            (int(body), np.asarray(offset, np.float64), np.asarray(target, np.float64))
        )

    def add_surface(
        self,
        body: int,
        kind: int,
        offset=(0, 0, 0),
        rotm: Optional[np.ndarray] = None,
        size=(0.1, 0.1, 0.1),
        friction: float = 1.0,
    ):
        """Register a body-vs-body contact surface (sphere/box/capsule).

        size: sphere [r,-,-]; box HALF extents; capsule [r, half_len, -].
        Contact spheres of other actors collide against it."""
        self.surfaces.append(
            (
                int(body),
                int(kind),
                np.asarray(offset, np.float64),
                np.eye(3) if rotm is None else np.asarray(rotm, np.float64),
                np.asarray(size, np.float64),
                float(friction),
            )
        )

    def merge(self, other: "ModelBuilder") -> int:
        """Append another builder's actors into this scene (the equivalent of
        multiple create_actor calls per env; ref: shadow_hand.py:358-393 hand
        + object + goal actors).  Returns the body-index offset."""
        off = len(self.bodies)
        for b in other.bodies:
            import copy as _copy

            b2 = _copy.copy(b)
            b2.parent = b.parent + off if b.parent >= 0 else -1
            self.bodies.append(b2)
        self.actor_roots += [r + off for r in other.actor_roots]
        self.geom_body += [g + off for g in other.geom_body]
        self.sensor_body += [s + off for s in other.sensor_body]
        self.geom_offset += list(other.geom_offset)
        self.geom_radius += list(other.geom_radius)
        self.geom_friction += list(other.geom_friction)
        self.surfaces += [
            (s[0] + off, s[1], s[2], s[3], s[4], s[5]) for s in other.surfaces
        ]
        self.anchors += [(a[0] + off, a[1], a[2]) for a in other.anchors]
        self.tendons += list(other.tendons)  # joint names stay valid
        return off

    def body_actor(self, b: int) -> int:
        """Actor index owning body b (index of its kinematic tree root)."""
        while self.bodies[b].parent >= 0:
            b = self.bodies[b].parent
        return self.actor_roots.index(b)

    # -- finalize ----------------------------------------------------------
    def finalize(self, dtype=torch.float32) -> SimModel:
        nb = len(self.bodies)
        parent, jtype, q_adr, v_adr = [], [], [], []
        dof_body, dof_v_adr, dof_q_adr, dof_names = [], [], [], []
        nq = nv = 0
        for i, b in enumerate(self.bodies):
            assert b.parent < i, "bodies must be added parents-first"
            parent.append(b.parent)
            jtype.append(b.jtype)
            q_adr.append(nq)
            v_adr.append(nv)
            if b.jtype == JT_FREE:
                nq += 7
                nv += 6
            elif b.jtype in (JT_REVOLUTE, JT_PRISMATIC, JT_SCREW):
                dof_body.append(i)
                dof_q_adr.append(nq)
                dof_v_adr.append(nv)
                dof_names.append(b.joint_name)
                nq += 1
                nv += 1
        nd = len(dof_body)

        def darr(attr):
            return _t([getattr(self.bodies[b], attr) for b in dof_body], dtype)

        ng = len(self.geom_body)
        model = SimModel(
            no_ground=bool(self.no_ground),
            joint_pitch=tuple(float(b.pitch) for b in self.bodies),
            sensor_body=tuple(self.sensor_body),
            nb=nb,
            nq=nq,
            nv=nv,
            nd=nd,
            parent=tuple(parent),
            jtype=tuple(jtype),
            q_adr=tuple(q_adr),
            v_adr=tuple(v_adr),
            dof_body=tuple(dof_body),
            dof_v_adr=tuple(dof_v_adr),
            dof_q_adr=tuple(dof_q_adr),
            actor_root=tuple(self.actor_roots),
            body_names=tuple(b.name for b in self.bodies),
            dof_names=tuple(dof_names),
            geom_body=tuple(self.geom_body),
            joint_pos=_t(np.stack([b.joint_pos for b in self.bodies]), dtype),
            joint_quat=_t(np.stack([b.joint_quat for b in self.bodies]), dtype),
            joint_axis=_t(np.stack([b.joint_axis for b in self.bodies]), dtype),
            body_mass=_t([b.mass for b in self.bodies], dtype),
            body_com=_t(np.stack([b.com for b in self.bodies]), dtype),
            body_inertia=_t(np.stack([b.inertia for b in self.bodies]), dtype),
            dof_lower=darr("lower"),
            dof_upper=darr("upper"),
            dof_effort=darr("effort"),
            dof_maxvel=darr("maxvel"),
            dof_armature=darr("armature"),
            dof_friction=darr("friction"),
            dof_stiffness=darr("stiffness"),
            dof_damping=darr("damping"),
            dof_drive_mode=_t(
                [self.bodies[b].drive_mode for b in dof_body], torch.int32
            ),
            dof_has_limit=_t(
                [self.bodies[b].has_limit for b in dof_body], torch.bool
            ),
            geom_offset=_t(
                np.stack(self.geom_offset) if ng else np.zeros((0, 3)), dtype
            ),
            geom_radius=_t(self.geom_radius, dtype),
            geom_friction=_t(self.geom_friction, dtype),
            geom_meff=_t(
                [max(self.bodies[b].mass, 1e-3) for b in self.geom_body], dtype
            ),
            gravity=_t(self.gravity, dtype),
            contact_stiffness=_t(self.contact_stiffness, dtype),
            contact_damping=_t(self.contact_damping, dtype),
            tangential_stiffness=_t(self.tangential_stiffness, dtype),
            **self._surface_fields(dtype),
            **self._anchor_fields(dtype),
            **self._tendon_fields(dof_names, dtype),
            **(
                {"body_gravcomp": _t([b.gravcomp for b in self.bodies], dtype)}
                if any(b.gravcomp for b in self.bodies)
                else {}
            ),
        )
        return model

    def _tendon_fields(self, dof_names, dtype):
        if not self.tendons:
            return {}
        td, tc = [], []
        for names, coefs, lo, hi, k, d in self.tendons:
            td.append(tuple(dof_names.index(n) for n in names))
            tc.append(coefs)
        return dict(
            tendon_dof=tuple(td),
            tendon_coef=_t(tc, dtype),
            tendon_range=_t([[t[2], t[3]] for t in self.tendons], dtype),
            tendon_k=_t([t[4] for t in self.tendons], dtype),
            tendon_d=_t([t[5] for t in self.tendons], dtype),
        )

    def _anchor_fields(self, dtype):
        if not self.anchors:
            return {}
        return dict(
            anchor_body=tuple(a[0] for a in self.anchors),
            anchor_offset=_t(np.stack([a[1] for a in self.anchors]), dtype),
            anchor_target=_t(np.stack([a[2] for a in self.anchors]), dtype),
            anchor_meff=_t(
                [max(self.bodies[a[0]].mass, 1e-3) for a in self.anchors], dtype
            ),
        )

    def _surface_fields(self, dtype):
        """Surface arrays + cross-actor (geom sphere, surface) pair list."""
        ns = len(self.surfaces)
        if ns == 0:
            return {}
        actor_of_body = [self.body_actor(i) for i in range(len(self.bodies))]
        pair_geom, pair_surf = [], []
        for g, gb in enumerate(self.geom_body):
            for s, (sb, *_rest) in enumerate(self.surfaces):
                if actor_of_body[gb] != actor_of_body[sb] and (
                    self.pair_filter is None or self.pair_filter(gb, sb)
                ):
                    pair_geom.append(g)
                    pair_surf.append(s)
        return dict(
            surf_body=tuple(s[0] for s in self.surfaces),
            surf_kind=tuple(s[1] for s in self.surfaces),
            pair_geom=tuple(pair_geom),
            pair_surf=tuple(pair_surf),
            surf_offset=_t(np.stack([s[2] for s in self.surfaces]), dtype),
            surf_rotm=_t(np.stack([s[3] for s in self.surfaces]), dtype),
            surf_size=_t(np.stack([s[4] for s in self.surfaces]), dtype),
            surf_friction=_t([s[5] for s in self.surfaces], dtype),
            surf_meff=_t(
                [max(self.bodies[s[0]].mass, 1e-3) for s in self.surfaces], dtype
            ),
        )
