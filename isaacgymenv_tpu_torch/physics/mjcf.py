"""MJCF -> SimModel loader (host-side).

Counterpart of `isaacgymenv_tpu/physics/mjcf.py`, pure numpy on the host.
Replaces `gym.load_asset` for the MJCF robots (nv_ant.xml, nv_humanoid.xml,
amp_humanoid.xml; ref: tasks/ant.py:140, tasks/humanoid.py,
tasks/amp/humanoid_amp_base.py).  Supports the subset those assets use:

- <default> joint/geom attribute defaults (incl. nested <default class=...>)
- <compiler angle="degree|radian" inertiafromgeom>
- body tree with pos/quat/euler/zaxis, freejoint, hinge/slide joints
  (multiple joints per body via phantom intermediate bodies)
- geoms: sphere, capsule (fromto or pos+size), box, cylinder; density-based
  mass/inertia (MuJoCo semantics: inertia always from geoms here)
- <actuator><motor gear=...> -> per-dof gear vector (effort actuation scale)
- <custom><numeric name="init_qpos"> -> default reset pose (MJCF wxyz quats
  converted to xyzw)

MJCF quirk handled: joint <pos> offsets re-root the child frame so that all
1-DoF joints rotate about the child frame origin (our canonical form).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from isaacgymenv_tpu_torch.physics import builder as B
from isaacgymenv_tpu_torch.physics.types import DRIVE_NONE, DRIVE_POS, JT_FIXED, JT_FREE, JT_PRISMATIC, JT_REVOLUTE
from isaacgymenv_tpu_torch.physics.urdf import (
    Geom,
    _geom_inertia,
    _geom_volume,
    _mat_to_quat,
    geom_to_spheres,
    geom_to_surface,
)


def _vec(s, default=None, n=None):
    if s is None:
        return np.array(default, np.float64)
    v = np.array([float(x) for x in s.split()], np.float64)
    return v if n is None else v[:n]


def _quat_wxyz_to_xyzw(q):
    return np.array([q[1], q[2], q[3], q[0]], np.float64)


def _quat_to_mat(q_xyzw):
    x, y, z, w = q_xyzw
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _zaxis_to_mat(zaxis):
    z = zaxis / np.linalg.norm(zaxis)
    ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(ref, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def _euler_to_mat(euler_rad):
    r, p, y = euler_rad
    cr, sr, cp, sp, cy, sy = (
        math.cos(r), math.sin(r), math.cos(p), math.sin(p), math.cos(y), math.sin(y),
    )
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    # MuJoCo lowercase eulerseq "xyz": rotations composed in sequence about
    # the CURRENT (moving) axes -> R = Rx @ Ry @ Rz (mjCompiler euler2quat
    # right-multiplies q *= rot(axis_i) for lowercase entries)
    return Rx @ Ry @ Rz


@dataclass
class MJCFOptions:
    fix_base_link: bool = False
    armature_scale: float = 1.0
    default_density: float = 1000.0
    # world placement of a fixed root body (replaces the MJCF root body pos,
    # like create_actor's start pose; rotation from the MJCF is kept)
    base_pos: Optional[Tuple[float, float, float]] = None


def _inline_includes(root: ET.Element, base_dir: str) -> None:
    """Recursively replace <include file=.../> with the file's root children
    (MJCF include semantics; used by the OpenAI shadow hand assets)."""
    changed = True
    while changed:
        changed = False
        for parent in list(root.iter()):
            for idx, ch in enumerate(list(parent)):
                if ch.tag != "include":
                    continue
                sub = ET.parse(os.path.join(base_dir, ch.get("file"))).getroot()
                pos = list(parent).index(ch)
                parent.remove(ch)
                for j, sc in enumerate(list(sub)):
                    parent.insert(pos + j, sc)
                changed = True
                break


def _body_frame_attrs(el, angle_scale):
    pos = _vec(el.get("pos"), (0, 0, 0))
    if el.get("quat") is not None:
        R = _quat_to_mat(_quat_wxyz_to_xyzw(_vec(el.get("quat"), (1, 0, 0, 0))))
    elif el.get("euler") is not None:
        R = _euler_to_mat(_vec(el.get("euler"), (0, 0, 0)) * angle_scale)
    elif el.get("zaxis") is not None:
        R = _zaxis_to_mat(_vec(el.get("zaxis"), (0, 0, 1)))
    else:
        R = np.eye(3)
    return R, pos


def _geom_from_el(gel, gdef, angle_scale) -> Optional[Geom]:
    attrs = {**gdef, **gel.attrib}
    gtype = attrs.get("type", "sphere")
    if gtype == "plane":
        return None
    size = _vec(attrs.get("size"), (0.05,))
    if attrs.get("fromto") is not None:
        ft = _vec(attrs.get("fromto"), None)
        a, b = ft[:3], ft[3:6]
        mid = (a + b) / 2.0
        d = b - a
        ln = np.linalg.norm(d)
        R = _zaxis_to_mat(d / max(ln, 1e-9))
        if gtype == "capsule" or gtype == "cylinder":
            return Geom(kind=gtype, R=R, p=mid, size=np.array([size[0], ln]))
        return Geom(kind="capsule", R=R, p=mid, size=np.array([size[0], ln]))
    R, pos = _body_frame_attrs(gel, angle_scale)
    if gtype == "sphere":
        return Geom(kind="sphere", R=R, p=pos, size=np.array([size[0]]))
    if gtype == "capsule" or gtype == "cylinder":
        return Geom(kind=gtype, R=R, p=pos, size=np.array([size[0], 2 * size[1]]))
    if gtype == "box":
        return Geom(kind="box", R=R, p=pos, size=2 * size[:3])  # MJCF size = half-extents
    return None


def _geom_mass_props(g: Geom, density: float):
    vol = _geom_volume(g)
    mass = density * vol
    if g.kind == "capsule":
        I = B.capsule_inertia(mass, g.size[0], g.size[1], axis=2)
        I = g.R @ I @ g.R.T
        return mass, g.p, I
    I, p = _geom_inertia(g, mass)
    return mass, p, I


def load_mjcf(path: str, opts: Optional[MJCFOptions] = None):
    """Parse MJCF -> (ModelBuilder, info).

    info: link_body, dof_joints, gears (nd,), ctrl_limited, init_qpos
    (converted to our q layout), actuator_order (dof index per actuator).
    """
    opts = opts or MJCFOptions()
    tree = ET.parse(path)
    root = tree.getroot()
    _inline_includes(root, os.path.dirname(os.path.abspath(path)))

    compiler = root.find("compiler")
    angle_scale = 1.0
    if compiler is None or compiler.get("angle", "degree") == "degree":
        angle_scale = math.pi / 180.0

    # defaults (flat + per-class)
    def collect_defaults(el, inherited):
        out = dict(inherited)
        for tag in ("joint", "geom", "motor", "position"):
            d = el.find(tag)
            if d is not None:
                out[tag] = {**out.get(tag, {}), **d.attrib}
        classes = {}
        for sub in el.findall("default"):
            cname = sub.get("class", "")
            sub_out, sub_classes = collect_defaults(sub, out)
            classes[cname] = sub_out
            classes.update(sub_classes)
        return out, classes

    defaults: Dict[str, dict] = {"joint": {}, "geom": {}, "motor": {}, "position": {}}
    classes: Dict[str, dict] = {}
    for droot in root.findall("default"):
        defaults, new_classes = collect_defaults(droot, defaults)
        classes.update(new_classes)

    mb = B.ModelBuilder()
    info: Dict[str, object] = {"link_body": {}, "dof_joints": [], "init_qpos": None}
    joint_meta: Dict[str, dict] = {}  # name -> {dof index-to-be, armature, ...}

    def jdef(el, childclass=None):
        cls = el.get("class") or childclass
        base = classes.get(cls, defaults).get("joint", {}) if cls else defaults.get("joint", {})
        return {**base, **el.attrib}

    def gdef_for(el, childclass=None):
        cls = el.get("class") or childclass
        return classes.get(cls, defaults).get("geom", {}) if cls else defaults.get("geom", {})

    def process_body(bel, parent_idx, is_root, childclass=None):
        name = bel.get("name", f"body{len(mb.bodies)}")
        childclass = bel.get("childclass", childclass)
        R_b, p_b = _body_frame_attrs(bel, angle_scale)
        quat_b = _mat_to_quat(R_b)

        joints = bel.findall("joint")
        freejoint = bel.find("freejoint")

        # geoms + mass from geoms (inertiafromgeom)
        geoms: List[Geom] = []
        geom_frictions: List[float] = []
        densities: List[float] = []
        for gel in bel.findall("geom"):
            gd = gdef_for(gel, childclass)
            attrs = {**gd, **gel.attrib}
            if attrs.get("contype", "1") == "0":
                continue  # visual-only geom (e.g. shadow hand D_Vizual class)
            g = _geom_from_el(gel, gd, angle_scale)
            if g is None:
                continue
            geoms.append(g)
            densities.append(float(attrs.get("density", opts.default_density)))
            fr = _vec(attrs.get("friction"), (1.0, 0.005, 0.0001))
            geom_frictions.append(float(fr[0]))

        # explicit <inertial> wins over geom-derived mass (the OpenAI hand
        # specifies inertials everywhere; its collision geoms are thin shells)
        inertial = bel.find("inertial")
        if inertial is not None:
            mass_tot = float(inertial.get("mass", 0.0))
            com = _vec(inertial.get("pos"), (0, 0, 0))
            if inertial.get("diaginertia") is not None:
                di = np.diag(_vec(inertial.get("diaginertia"), (1e-5,) * 3))
            elif inertial.get("fullinertia") is not None:
                fi = _vec(inertial.get("fullinertia"), (1e-5,) * 6, n=6)
                di = np.array(
                    [[fi[0], fi[3], fi[4]], [fi[3], fi[1], fi[5]], [fi[4], fi[5], fi[2]]]
                )
            else:
                di = np.eye(3) * 1e-5
            if inertial.get("quat") is not None:
                R_i = _quat_to_mat(_quat_wxyz_to_xyzw(_vec(inertial.get("quat"), (1, 0, 0, 0))))
                I_tot = R_i @ di @ R_i.T
            else:
                I_tot = di
        else:
            mass_tot, com, I_tot = 0.0, np.zeros(3), np.zeros((3, 3))
            props = [_geom_mass_props(g, d) for g, d in zip(geoms, densities)]
            mass_tot = sum(p[0] for p in props)
            if mass_tot > 0:
                com = sum(p[0] * p[1] for p in props) / mass_tot
                for m_g, p_g, I_g in props:
                    d = p_g - com
                    I_tot += I_g + m_g * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        # joint chain: free joint, or K hinges/slides via phantom bodies
        if freejoint is not None or (is_root and not joints and not opts.fix_base_link):
            # free joints carry the absolute pose in q; the MJCF body pos is
            # only the DEFAULT spawn pose (returned via info["init_root"])
            body = mb.add_body(
                name, parent_idx, JT_FREE,
                joint_pos=(0, 0, 0), joint_quat=(0, 0, 0, 1),
                mass=mass_tot, com=com, inertia=I_tot,
                joint_name=f"{name}_free",
            )
            info.setdefault("init_root", {})[name] = (p_b, _mat_to_quat(R_b))
        elif not joints:
            # fixed root: base_pos (the create_actor start pose) replaces the
            # MJCF world position; the MJCF rotation is kept
            jp = (
                np.asarray(opts.base_pos, np.float64)
                if (is_root and opts.base_pos is not None)
                else p_b
            )
            body = mb.add_body(
                name, parent_idx, JT_FIXED,
                joint_pos=jp, joint_quat=quat_b,
                mass=mass_tot, com=com, inertia=I_tot,
                joint_name=f"{name}_fixed",
            )
        else:
            # K joints in one MJCF body -> chain of K bodies, each carrying
            # one joint; frames are re-rooted to each joint's anchor point so
            # every 1-DoF joint rotates about its body-frame origin.
            # jpos_k are expressed in the ORIGINAL body frame B; phantom k
            # has B's orientation with origin at jpos_k.
            jpos_list = [_vec(j.get("pos"), (0, 0, 0)) for j in joints]
            cur_parent = parent_idx
            prev_origin = None  # origin of previous frame, in B coords
            for k, jel in enumerate(joints):
                attrs = jdef(jel, childclass)
                jname = attrs.get("name", f"{name}_j{k}")
                jt = JT_REVOLUTE if attrs.get("type", "hinge") == "hinge" else JT_PRISMATIC
                axis = _vec(attrs.get("axis"), (0, 0, 1))
                axis = axis / np.linalg.norm(axis)
                limited = str(attrs.get("limited", "false")).lower() == "true"
                rng = _vec(attrs.get("range"), (0, 0))
                scale = angle_scale if jt == JT_REVOLUTE else 1.0
                last = k == len(joints) - 1
                if prev_origin is None:
                    j_pos = p_b + R_b @ jpos_list[k]
                    j_quat = quat_b
                else:
                    j_pos = jpos_list[k] - prev_origin
                    j_quat = np.array([0.0, 0.0, 0.0, 1.0])
                body = mb.add_body(
                    name if last else f"{name}__ph{k}",
                    cur_parent,
                    jt,
                    joint_pos=j_pos,
                    joint_quat=j_quat,
                    joint_axis=axis,
                    joint_name=jname,
                    mass=mass_tot if last else 1e-4,
                    com=(com - jpos_list[-1]) if last else np.zeros(3),
                    inertia=I_tot if last else np.eye(3) * 1e-7,
                    lower=rng[0] * scale if limited else -1e9,
                    upper=rng[1] * scale if limited else 1e9,
                    effort=1e9,
                    maxvel=1e9,
                    armature=float(attrs.get("armature", 0.0)) * opts.armature_scale,
                    damping=float(attrs.get("damping", 0.0)),
                    friction=float(attrs.get("frictionloss", 0.0)),
                    stiffness=float(attrs.get("stiffness", 0.0)),
                    drive_mode=DRIVE_NONE,
                    has_limit=limited,
                )
                info["dof_joints"].append(jname)
                joint_meta[jname] = {"body": body}
                cur_parent = body
                prev_origin = jpos_list[k]

        info["link_body"][name] = body
        # geoms and children are relative to B; the final frame origin sits at
        # the last joint anchor (zero when there are no joints / free root)
        shift = _vec(joints[-1].get("pos"), (0, 0, 0)) if joints else np.zeros(3)
        for g, fr in zip(geoms, geom_frictions):
            for off, r in geom_to_spheres(g):
                mb.add_geom_sphere(body, off - shift, r, fr)
            surf = geom_to_surface(g)
            if surf is not None:
                k, p_g, R_g, size = surf
                mb.add_surface(body, k, p_g - shift, R_g, size, fr)

        for child in bel.findall("body"):
            saved = child.get("pos")
            _, p_c = _body_frame_attrs(child, angle_scale)
            child.set("pos", " ".join(str(v) for v in (p_c - shift)))
            process_body(child, body, False, childclass)
            if saved is not None:
                child.set("pos", saved)
            else:
                child.attrib.pop("pos", None)

        return body

    world = root.find("worldbody")
    for bel in world.findall("body"):
        process_body(bel, -1, True)

    # actuators: gear per dof, in actuator order
    gears, actuator_dofs = [], []
    position_actuators = []  # (joint, kp, force_hi) in actuator order
    for act in root.findall("actuator"):
        for mel in act.findall("motor"):
            jn = mel.get("joint")
            gears.append(float(mel.get("gear", defaults.get("motor", {}).get("gear", 1.0))))
            actuator_dofs.append(jn)
        for pel in act.findall("position"):
            cls = pel.get("class")
            base = classes.get(cls, defaults).get("position", {}) if cls else defaults.get("position", {})
            attrs = {**base, **pel.attrib}
            jn = attrs.get("joint")
            kp = float(attrs.get("kp", 1.0))
            fr = _vec(attrs.get("forcerange"), (-1e9, 1e9), n=2)
            position_actuators.append((jn, kp, float(fr[1])))
            # wire PD drive into the joint's dof (PhysX maps MJCF position
            # actuators to DOF_MODE_POS drives; ref shadow_hand.py:248
            # "DOF mode is set in the MJCF file")
            meta = joint_meta.get(jn)
            if meta is not None:
                b = mb.bodies[meta["body"]]
                b.drive_mode = DRIVE_POS
                b.stiffness = kp
                b.effort = min(b.effort, float(fr[1])) if b.effort else float(fr[1])
    info["gears"] = np.array(gears)
    info["actuator_joints"] = actuator_dofs
    info["position_actuators"] = position_actuators

    # fixed tendons with >1 joint: linear coupling limits (shadow hand
    # distal pairs); single-joint fixed tendons duplicate joint limits and
    # are skipped
    for tend in root.findall("tendon"):
        for fel in tend.findall("fixed"):
            jels = fel.findall("joint")
            if len(jels) < 2:
                continue
            names = [j.get("joint") for j in jels]
            coefs = [float(j.get("coef", 1.0)) for j in jels]
            rng = _vec(fel.get("range"), (0, 0), n=2)
            mb.add_tendon(names, coefs, float(rng[0]), float(rng[1]))

    # init qpos from <custom><numeric name="init_qpos"> (MJCF order:
    # root pos3 + root quat wxyz + joint angles)
    for num in root.iter("numeric"):
        if num.get("name") == "init_qpos":
            vals = _vec(num.get("data"), None)
            info["init_qpos"] = vals
    return mb, info
