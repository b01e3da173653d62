"""URDF -> SimModel loader (host-side, build-time only; never traced).

Replaces the reference's `gym.load_asset` for URDF robots
(ref: tasks/cartpole.py:89-92, tasks/anymal.py:166-207), including the
asset options that change topology: `fix_base_link`,
`collapse_fixed_joints`, default density for missing inertials, per-DOF
`armature` (SURVEY.md §7 hard-part #6).

Collision geometry is converted to contact spheres (physics/contact.py):
sphere -> itself; capsule/cylinder -> end + middle spheres; box -> 8
inset corner spheres; mesh (.obj/.stl) -> its axis-aligned bounding box
(PhysX-style convex approximation is overkill for inertia/contact here;
the AABB gives mass, inertia, and corner contact spheres).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from isaacgymenv_tpu_torch.physics import builder as B
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_NONE,
    JT_FIXED,
    JT_FREE,
    JT_PRISMATIC,
    JT_REVOLUTE,
    SimModel,
)


# ---------------------------------------------------------------------------
# host-side rotation helpers (numpy; xyzw quats)
# ---------------------------------------------------------------------------


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> xyzw quat (host numpy)."""
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    if i == 0:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array([0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s])
    if i == 1:
        s = math.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
        return np.array([(m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s])
    s = math.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
    return np.array([(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s, (m[1, 0] - m[0, 1]) / s])


def _f(s, default=0.0) -> float:
    """Tolerant float: real-world URDFs contain typos like '0.0.0000001'
    (assets/urdf/Hound_new/Hound.urdf); take the longest valid prefix."""
    if s is None:
        return float(default)
    try:
        return float(s)
    except ValueError:
        import re

        m = re.match(r"\s*[-+]?\d*\.?\d+([eE][-+]?\d+)?", str(s))
        return float(m.group(0)) if m else float(default)


def _parse_vec(s: Optional[str], default, n=3) -> np.ndarray:
    if s is None:
        return np.array(default, dtype=np.float64)
    return np.array([_f(x) for x in s.split()], dtype=np.float64)[:n]


def _origin(el: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    """<origin xyz rpy> -> (R, p)."""
    if el is None:
        return np.eye(3), np.zeros(3)
    xyz = _parse_vec(el.get("xyz"), (0, 0, 0))
    rpy = _parse_vec(el.get("rpy"), (0, 0, 0))
    return _rpy_to_mat(rpy), xyz


@dataclass
class Geom:
    kind: str             # sphere|box|cylinder|capsule|mesh
    R: np.ndarray         # orientation in link frame
    p: np.ndarray         # position in link frame
    size: np.ndarray      # sphere: [r]; box: [sx,sy,sz]; cyl/capsule: [r, len]


@dataclass
class Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    has_inertial: bool = False
    geoms: List[Geom] = field(default_factory=list)


@dataclass
class Joint:
    name: str
    jtype: str
    parent: str
    child: str
    R: np.ndarray
    p: np.ndarray
    axis: np.ndarray
    lower: float = -1e9
    upper: float = 1e9
    effort: float = 1e9
    velocity: float = 1e9
    damping: float = 0.0
    friction: float = 0.0


@dataclass
class AssetOptions:
    """Mirror of the gymapi.AssetOptions fields the tasks use
    (ref: tasks/anymal.py:170-181, tasks/cartpole.py:88)."""

    fix_base_link: bool = False
    collapse_fixed_joints: bool = False
    default_dof_drive_mode: int = DRIVE_NONE
    density: float = 1000.0          # for links with no inertial
    armature: float = 0.0            # added to every DOF
    replace_cylinder_with_capsule: bool = False  # affects inertia only here
    flip_visual_attachments: bool = False        # visual-only; ignored


def _geom_inertia(g: Geom, mass: float) -> Tuple[np.ndarray, np.ndarray]:
    """(inertia about geom COM in link frame, COM position)."""
    if g.kind == "sphere":
        I = B.sphere_inertia(mass, g.size[0])
    elif g.kind == "box":
        I = B.box_inertia(mass, *g.size[:3])
    elif g.kind in ("cylinder", "capsule"):
        I = B.cylinder_inertia(mass, g.size[0], g.size[1], axis=2)
    else:
        I = B.sphere_inertia(mass, 0.1)
    return g.R @ I @ g.R.T, g.p


def _geom_volume(g: Geom) -> float:
    if g.kind == "sphere":
        return 4.0 / 3.0 * math.pi * g.size[0] ** 3
    if g.kind == "box":
        return float(np.prod(g.size[:3]))
    if g.kind in ("cylinder", "capsule"):
        v = math.pi * g.size[0] ** 2 * g.size[1]
        if g.kind == "capsule":
            v += 4.0 / 3.0 * math.pi * g.size[0] ** 3
        return v
    return 1e-3


_MESH_AABB_CACHE: Dict[Tuple[str, Tuple[float, float, float]], Tuple[np.ndarray, np.ndarray]] = {}


def _resolve_mesh_path(filename: str, urdf_path: str) -> Optional[str]:
    """Resolve `package://<pkg>/rest` / relative mesh references against the
    asset tree the URDF lives in (how gym.load_asset resolves them)."""
    urdf_dir = os.path.dirname(os.path.abspath(urdf_path))
    if filename.startswith("package://"):
        rest = filename[len("package://"):]
        pkg, _, rel = rest.partition("/")
        # walk up from the urdf dir looking for the package directory
        d = urdf_dir
        for _ in range(8):
            cand = os.path.join(d, pkg, rel) if os.path.basename(d) != pkg else os.path.join(d, rel)
            if os.path.exists(cand):
                return cand
            d = os.path.dirname(d)
        return None
    cand = os.path.join(urdf_dir, filename)
    return cand if os.path.exists(cand) else None


def _mesh_vertices(path: str) -> Optional[np.ndarray]:
    """Vertices of an .obj (ascii) or .stl (binary or ascii) mesh."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        vs = []
        with open(path, "r", errors="ignore") as f:
            for line in f:
                if line.startswith("v "):
                    parts = line.split()
                    vs.append([float(parts[1]), float(parts[2]), float(parts[3])])
        return np.array(vs) if vs else None
    if ext == ".stl":
        with open(path, "rb") as f:
            head = f.read(5)
            f.seek(0)
            if head == b"solid":
                data = f.read().decode(errors="ignore")
                vs = []
                for line in data.splitlines():
                    t = line.split()
                    if len(t) == 4 and t[0] == "vertex":
                        vs.append([float(t[1]), float(t[2]), float(t[3])])
                if vs:
                    return np.array(vs)
                f.seek(0)  # mislabeled binary
            f.seek(80)
            n = int.from_bytes(f.read(4), "little")
            raw = np.frombuffer(f.read(n * 50), dtype=np.uint8)
            if raw.size < n * 50:
                return None
            tri = raw.reshape(n, 50)[:, :48].copy().view(np.float32).reshape(n, 4, 3)
            return tri[:, 1:4].reshape(-1, 3).astype(np.float64)
    return None


def _mesh_aabb(path: str, scale: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(center, full extents) of the scaled mesh's AABB; cached per file."""
    key = (path, tuple(float(s) for s in scale))
    if key in _MESH_AABB_CACHE:
        return _MESH_AABB_CACHE[key]
    vs = _mesh_vertices(path)
    if vs is None or len(vs) == 0:
        return None
    vs = vs * np.asarray(scale)
    lo, hi = vs.min(0), vs.max(0)
    out = ((lo + hi) / 2.0, np.maximum(hi - lo, 1e-4))
    _MESH_AABB_CACHE[key] = out
    return out


def _parse_geometry(
    geo_el: ET.Element, urdf_path: str = ""
) -> Optional[Tuple[str, np.ndarray, np.ndarray]]:
    """Returns (kind, size, center offset in geom frame) or None."""
    z3 = np.zeros(3)
    for child in geo_el:
        tag = child.tag
        if tag == "sphere":
            return "sphere", np.array([float(child.get("radius"))]), z3
        if tag == "box":
            return "box", _parse_vec(child.get("size"), (0.1, 0.1, 0.1)), z3
        if tag == "cylinder":
            return "cylinder", np.array([float(child.get("radius")), float(child.get("length"))]), z3
        if tag == "capsule":
            return "capsule", np.array([float(child.get("radius")), float(child.get("length"))]), z3
        if tag == "mesh":
            # mesh -> AABB box (mass/inertia/contact approximation)
            mp = _resolve_mesh_path(child.get("filename", ""), urdf_path)
            if mp is None:
                return None
            scale = _parse_vec(child.get("scale"), (1.0, 1.0, 1.0))
            ab = _mesh_aabb(mp, scale)
            if ab is None:
                return None
            center, extents = ab
            return "box", extents, center
    return None


def parse_urdf(path: str) -> Tuple[Dict[str, Link], List[Joint], str]:
    tree = ET.parse(path)
    robot = tree.getroot()
    links: Dict[str, Link] = {}
    joints: List[Joint] = []

    for lel in robot.findall("link"):
        link = Link(name=lel.get("name"))
        inertial = lel.find("inertial")
        if inertial is not None:
            R_i, p_i = _origin(inertial.find("origin"))
            mass_el = inertial.find("mass")
            link.mass = _f(mass_el.get("value")) if mass_el is not None else 0.0
            link.com = p_i
            in_el = inertial.find("inertia")
            if in_el is not None:
                ixx = _f(in_el.get("ixx"));  iyy = _f(in_el.get("iyy"))
                izz = _f(in_el.get("izz"));  ixy = _f(in_el.get("ixy"))
                ixz = _f(in_el.get("ixz"));  iyz = _f(in_el.get("iyz"))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                link.inertia = R_i @ I @ R_i.T
                link.has_inertial = True
            else:
                link.has_inertial = link.mass > 0  # inertia from geometry later
        for cel in lel.findall("collision"):
            R_c, p_c = _origin(cel.find("origin"))
            geo = cel.find("geometry")
            if geo is None:
                continue
            parsed = _parse_geometry(geo, path)
            if parsed is None:
                continue
            kind, size, center = parsed
            link.geoms.append(Geom(kind=kind, R=R_c, p=p_c + R_c @ center, size=size))
        links[link.name] = link

    for jel in robot.findall("joint"):
        R_j, p_j = _origin(jel.find("origin"))
        axis = _parse_vec(jel.find("axis").get("xyz"), (1, 0, 0)) if jel.find("axis") is not None else np.array([1.0, 0, 0])
        n = np.linalg.norm(axis)
        axis = axis / n if n > 0 else np.array([1.0, 0, 0])
        j = Joint(
            name=jel.get("name"),
            jtype=jel.get("type"),
            parent=jel.find("parent").get("link"),
            child=jel.find("child").get("link"),
            R=R_j,
            p=p_j,
            axis=axis,
        )
        lim = jel.find("limit")
        if lim is not None:
            j.lower = _f(lim.get("lower"), -1e9)
            j.upper = _f(lim.get("upper"), 1e9)
            j.effort = _f(lim.get("effort"), 1e9)
            j.velocity = _f(lim.get("velocity"), 1e9)
        dyn = jel.find("dynamics")
        if dyn is not None:
            j.damping = _f(dyn.get("damping"))
            j.friction = _f(dyn.get("friction"))
        joints.append(j)

    return links, joints, robot.get("name", os.path.basename(path))


def _finalize_link_inertia(link: Link, density: float):
    """Fill missing mass/inertia from collision geometry (PhysX behavior)."""
    if link.mass <= 0.0 and link.geoms:
        vol = sum(_geom_volume(g) for g in link.geoms)
        link.mass = density * vol
    if not link.has_inertial and link.mass > 0.0 and link.geoms:
        vols = np.array([_geom_volume(g) for g in link.geoms])
        masses = link.mass * vols / max(vols.sum(), 1e-12)
        com = sum(m * g.p for m, g in zip(masses, link.geoms)) / max(link.mass, 1e-12)
        I = np.zeros((3, 3))
        for m_g, g in zip(masses, link.geoms):
            I_g, p_g = _geom_inertia(g, m_g)
            d = p_g - com
            I += I_g + m_g * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        link.com = com
        link.inertia = I
        link.has_inertial = True


def geom_to_spheres(g: Geom, friction: float = 1.0):
    """Approximate a collision primitive with contact spheres.

    Returns list of (offset(3,), radius).
    """
    out = []
    if g.kind == "sphere":
        out.append((g.p, float(g.size[0])))
    elif g.kind in ("cylinder", "capsule"):
        r, ln = float(g.size[0]), float(g.size[1])
        half = ln / 2.0
        for s in (-half, 0.0, half):
            out.append((g.p + g.R @ np.array([0.0, 0.0, s]), r))
    elif g.kind == "box":
        sx, sy, sz = [float(v) for v in g.size[:3]]
        r = max(min(sx, sy, sz) / 4.0, 1e-3)
        for dx in (-1, 1):
            for dy in (-1, 1):
                for dz in (-1, 1):
                    corner = np.array(
                        [dx * (sx / 2 - r), dy * (sy / 2 - r), dz * (sz / 2 - r)]
                    )
                    out.append((g.p + g.R @ corner, r))
    return out


def geom_to_surface(g: Geom):
    """Geom -> body-vs-body contact surface spec (kind, offset, rotm, size)."""
    if g.kind == "sphere":
        return B.ModelBuilder.SURF_SPHERE, g.p, g.R, np.array([float(g.size[0]), 0.0, 0.0])
    if g.kind == "box":
        return B.ModelBuilder.SURF_BOX, g.p, g.R, np.asarray(g.size[:3], np.float64) / 2.0
    if g.kind in ("cylinder", "capsule"):
        kind = (
            B.ModelBuilder.SURF_CAPSULE
            if g.kind == "capsule"
            else B.ModelBuilder.SURF_CYLINDER
        )
        return (
            kind,
            g.p,
            g.R,
            np.array([float(g.size[0]), float(g.size[1]) / 2.0, 0.0]),
        )
    return None


def load_urdf(
    path: str,
    opts: Optional[AssetOptions] = None,
    base_pos=(0.0, 0.0, 0.0),
    base_quat=(0.0, 0.0, 0.0, 1.0),
    friction: float = 1.0,
):
    """Parse URDF and build a single-actor SimModel.

    Returns (ModelBuilder, info) — the builder is finalized by the caller so
    multiple actors can be composed into one scene (multi-actor envs).
    `info["link_body"]` maps every original link name to its body index
    (fixed-collapsed links map to the body they merged into), replacing the
    reference's `find_actor_rigid_body_handle` lookups (tasks/anymal.py:192).
    """
    opts = opts or AssetOptions()
    links, joints, robot_name = parse_urdf(path)

    child_joint: Dict[str, Joint] = {j.child: j for j in joints}
    children: Dict[str, List[str]] = {}
    for j in joints:
        children.setdefault(j.parent, []).append(j.child)
    root_links = [name for name in links if name not in child_joint]
    assert len(root_links) == 1, f"URDF must have one root link, got {root_links}"
    root = root_links[0]

    for link in links.values():
        _finalize_link_inertia(link, opts.density)

    mb = B.ModelBuilder()
    info: Dict[str, object] = {"name": robot_name, "link_body": {}, "dof_joints": []}

    # world-attach joint for the root link
    jt_root = JT_FIXED if opts.fix_base_link else JT_FREE
    type_map = {
        "revolute": JT_REVOLUTE,
        "continuous": JT_REVOLUTE,
        "prismatic": JT_PRISMATIC,
        "fixed": JT_FIXED,
        "floating": JT_FREE,
    }

    # DFS, collapsing fixed joints if requested.
    # frame bookkeeping: for a collapsed link we remember (body, R, p) = its
    # pose within the merged body's frame.
    def add_link(link_name: str, parent_body: int, R_j, p_j, jspec: Optional[Joint]):
        link = links[link_name]
        if jspec is None:
            jt = jt_root
            if jt == JT_FREE:
                # free roots carry their absolute pose in q — the spawn pose
                # is applied by the env via set_root_state, not the tree
                quat = np.array([0.0, 0.0, 0.0, 1.0])
                pos = np.zeros(3)
                info["init_root"] = (np.array(base_pos), np.array(base_quat))
            else:
                quat = np.array(base_quat, np.float64)
                pos = np.array(base_pos, np.float64)
            axis = np.array([0.0, 0.0, 1.0])
            dof = {}
            jname = f"{link_name}_root"
        else:
            jt = type_map[jspec.jtype]
            quat = _mat_to_quat(R_j)
            pos = p_j
            axis = jspec.axis
            has_limit = jspec.jtype in ("revolute", "prismatic")
            dof = dict(
                lower=jspec.lower if has_limit else -1e9,
                upper=jspec.upper if has_limit else 1e9,
                effort=jspec.effort,
                maxvel=jspec.velocity,
                damping_passive=jspec.damping,
                friction=jspec.friction,
                armature=opts.armature,
                drive_mode=opts.default_dof_drive_mode,
                has_limit=has_limit and jspec.upper > jspec.lower and jspec.upper < 1e8,
            )
            dof.pop("damping_passive")  # joint <dynamics damping> folds into drive damping
            jname = jspec.name

        body = mb.add_body(
            link_name,
            parent_body,
            jt,
            joint_pos=pos,
            joint_quat=quat,
            joint_axis=axis,
            joint_name=jname,
            mass=link.mass,
            com=link.com,
            inertia=link.inertia,
            **dof,
        )
        if jspec is not None and jt in (JT_REVOLUTE, JT_PRISMATIC):
            info["dof_joints"].append(jspec.name)
        info["link_body"][link_name] = body
        for g in link.geoms:
            for off, r in geom_to_spheres(g):
                mb.add_geom_sphere(body, off, r, friction)
            surf = geom_to_surface(g)
            if surf is not None:
                k, p_g, R_g, size = surf
                mb.add_surface(body, k, p_g, R_g, size, friction)
        _descend(link_name, body, np.eye(3), np.zeros(3))
        return body

    def _merge_link(link_name: str, body: int, R_in_body, p_in_body):
        """Collapse `link_name` into existing `body` at pose (R, p)."""
        link = links[link_name]
        b = mb.bodies[body]
        m2 = link.mass
        if m2 > 0:
            com2 = p_in_body + R_in_body @ link.com
            I2 = R_in_body @ link.inertia @ R_in_body.T
            m1 = b.mass
            com1 = b.com
            m = m1 + m2
            com = (m1 * com1 + m2 * com2) / m
            def shift(I, mm, c, new_c):
                d = c - new_c
                return I + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            b.inertia = shift(b.inertia, m1, com1, com) + shift(I2, m2, com2, com)
            b.mass = m
            b.com = com
        info["link_body"][link_name] = body
        for g in link.geoms:
            for off, r in geom_to_spheres(g):
                mb.add_geom_sphere(body, p_in_body + R_in_body @ off, r, friction)
            surf = geom_to_surface(g)
            if surf is not None:
                k, p_g, R_g, size = surf
                mb.add_surface(
                    body, k, p_in_body + R_in_body @ p_g, R_in_body @ R_g, size, friction
                )
        _descend(link_name, body, R_in_body, p_in_body)

    def _descend(link_name: str, body: int, R_acc, p_acc):
        for child_name in children.get(link_name, []):
            j = child_joint[child_name]
            if opts.collapse_fixed_joints and j.jtype == "fixed":
                R_new = R_acc @ j.R
                p_new = p_acc + R_acc @ j.p
                _merge_link(child_name, body, R_new, p_new)
            else:
                # joint origin is relative to link frame; compose with the
                # accumulated collapse transform
                R_j = R_acc @ j.R
                p_j = p_acc + R_acc @ j.p
                add_link(child_name, body, R_j, p_j, j)

    add_link(root, -1, np.eye(3), np.zeros(3), None)
    return mb, info
