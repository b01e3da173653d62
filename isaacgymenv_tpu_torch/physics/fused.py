"""The fused physics substep: one CUDA kernel for all substeps of a control step.

Replaces the TPU kernel `isaacgymenv_tpu/physics/fused.py:build_fused_substep`
for the scenes that `fused_structural_ok` accepts.  The kernel
(`csrc/fused_substep.cu`, one thread per env) is one fixed source: the model
arrives as data, a `FusedModel` table that `build_tables` fills once per
model and device.  It is built with one `nvcc` call at first use into the
git-ignored `_build/` directory (`build_library`, shared with the split
kernels) and loaded with ctypes.

`fused_substep` is the wrapper: a CUDA state launches the kernel (or raises),
a CPU state runs `fused_substep_plain`, the eager port of the XLA path
(`engine._substep` looped `substeps` times).  `fused_substep.launches` counts
kernel launches.  The kernel's optional modes are inputs, null when off: the
held ground (`terrain_mode`), per-env friction (`fric_mode`) and the body
wrenches (`wrench_mode`); its sensor output is written when the model has
force sensors.  Gravity compensation (`body_gravcomp`) travels in the
table: `gc_mass` (gravcomp x mass per body, 0 where a body keeps its
gravity) and `com`, read by `gravcomp_wrench` of `csrc/substep_common.cuh`,
which B2 shares.  A scene may have no contact geoms (ng = 0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from isaacgymenv_tpu_torch.physics import contact, engine
from isaacgymenv_tpu_torch.physics.types import (
    JT_FIXED,
    JT_FREE,
    JT_PRISMATIC,
    JT_REVOLUTE,
    SimModel,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "fused_substep.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# compile-time caps of csrc/substep_common.cuh (FS_MAX_*)
MAX_BODIES, MAX_DOFS, MAX_GEOMS, MAX_Q, MAX_V, MAX_SENSORS = 32, 32, 256, 64, 64, 8


class FusedModel(ctypes.Structure):
    """Field-for-field mirror of `struct FusedModel` in csrc/substep_common.cuh."""

    _fields_ = [
        ("nb", ctypes.c_int), ("nq", ctypes.c_int), ("nv", ctypes.c_int),
        ("nd", ctypes.c_int), ("ng", ctypes.c_int), ("ns", ctypes.c_int),
        ("parent", ctypes.c_int * MAX_BODIES),
        ("jtype", ctypes.c_int * MAX_BODIES),
        ("q_adr", ctypes.c_int * MAX_BODIES),
        ("v_adr", ctypes.c_int * MAX_BODIES),
        ("body_dof", ctypes.c_int * MAX_BODIES),
        ("dof_body", ctypes.c_int * MAX_DOFS),
        ("dof_mode", ctypes.c_int * MAX_DOFS),
        ("dof_haslim", ctypes.c_int * MAX_DOFS),
        ("geom_body", ctypes.c_int * MAX_GEOMS),
        ("sensor_body", ctypes.c_int * MAX_SENSORS),
        ("R_tree", ctypes.c_float * (MAX_BODIES * 9)),
        ("p_tree", ctypes.c_float * (MAX_BODIES * 3)),
        ("axis", ctypes.c_float * (MAX_BODIES * 3)),
        ("inertia", ctypes.c_float * (MAX_BODIES * 36)),
        ("dof_kp", ctypes.c_float * MAX_DOFS),
        ("dof_kd", ctypes.c_float * MAX_DOFS),
        ("dof_lower", ctypes.c_float * MAX_DOFS),
        ("dof_upper", ctypes.c_float * MAX_DOFS),
        ("dof_effort", ctypes.c_float * MAX_DOFS),
        ("dof_maxvel", ctypes.c_float * MAX_DOFS),
        ("dof_armature", ctypes.c_float * MAX_DOFS),
        ("dof_friction", ctypes.c_float * MAX_DOFS),
        ("geom_off", ctypes.c_float * (MAX_GEOMS * 3)),
        ("geom_r", ctypes.c_float * MAX_GEOMS),
        ("geom_mu", ctypes.c_float * MAX_GEOMS),
        ("geom_meff", ctypes.c_float * MAX_GEOMS),
        ("geom_meff_el", ctypes.c_float * MAX_GEOMS),
        ("gravity", ctypes.c_float * 3),
        ("kn", ctypes.c_float), ("kd", ctypes.c_float), ("kt", ctypes.c_float),
        ("limit_k", ctypes.c_float), ("limit_d", ctypes.c_float), ("fric_eps", ctypes.c_float),
        ("max_angvel", ctypes.c_float), ("max_linvel", ctypes.c_float),
        ("gc_mass", ctypes.c_float * MAX_BODIES),
        ("com", ctypes.c_float * (MAX_BODIES * 3)),
    ]


def fused_structural_ok(model: SimModel, num_envs: int) -> bool:
    """True when the scene's joints, sizes and leaves fit the kernel; anything
    else takes the plain path.  The one per-env leaf the kernel takes is
    `geom_friction` (num_envs, ng) (`fric_mode`); every other model leaf must
    be shared by all envs.  Force sensors are an output of the kernel, up to
    MAX_SENSORS bodies; body wrenches an input; gravity compensation a
    table field.  Features B1 has not yet (anchors, ...) are refused before
    this by `engine._check_supported`."""
    if num_envs < 1:
        return False
    if any(jt not in (JT_FREE, JT_REVOLUTE, JT_PRISMATIC, JT_FIXED) for jt in model.jtype):
        return False
    # free joints only at actor roots: the ABA inward pass ends there
    if any(jt == JT_FREE and par >= 0 for jt, par in zip(model.jtype, model.parent)):
        return False
    shared = {
        "body_mass": 1, "body_com": 2, "body_inertia": 3, "joint_pos": 2, "joint_quat": 2, "joint_axis": 2,
        "geom_offset": 2, "geom_radius": 1, "geom_meff": 1, "gravity": 1,
        "dof_stiffness": 1, "dof_damping": 1, "dof_lower": 1, "dof_upper": 1,
    }
    if any(getattr(model, name).ndim != nd for name, nd in shared.items()):
        return False
    if model.geom_friction.ndim == 2 and tuple(model.geom_friction.shape) != (num_envs, model.ng):
        return False
    return (0 < model.nd <= MAX_DOFS and model.nb <= MAX_BODIES and model.ng <= MAX_GEOMS
            and model.nq <= MAX_Q and model.nv <= MAX_V and len(model.sensor_body) <= MAX_SENSORS)


def _spatial_inertia64(mass, com, inertia_com) -> np.ndarray:
    c = np.asarray(com, np.float64)
    cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0.0]])
    I = np.zeros((6, 6))
    I[:3, :3] = inertia_com + mass * cx @ cx.T
    I[:3, 3:] = mass * cx
    I[3:, :3] = mass * cx.T
    I[3:, 3:] = mass * np.eye(3)
    return I


def _quat_to_R64(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def pack_model(model: SimModel) -> FusedModel:
    """Fill the kernel's model table (host side).  Rotations and spatial
    inertias are formed in float64 and rounded once, as the TPU kernel bakes
    its constants."""
    c = lambda t: t.detach().cpu().numpy()  # noqa: E731
    m = FusedModel()
    m.nb, m.nq, m.nv, m.nd, m.ng = model.nb, model.nq, model.nv, model.nd, model.ng
    m.ns = len(model.sensor_body)
    body_dof = [-1] * model.nb
    for d, b in enumerate(model.dof_body):
        body_dof[b] = d
    for name, vals in (
        ("parent", model.parent), ("jtype", model.jtype), ("q_adr", model.q_adr),
        ("v_adr", model.v_adr), ("body_dof", body_dof), ("dof_body", model.dof_body),
        ("dof_mode", c(model.dof_drive_mode)), ("dof_haslim", c(model.dof_has_limit)),
        ("geom_body", model.geom_body), ("sensor_body", model.sensor_body),
    ):
        getattr(m, name)[: len(vals)] = [int(v) for v in vals]
    mass, com, inert = c(model.body_mass), c(model.body_com), c(model.body_inertia)
    joint_quat = c(model.joint_quat)
    floats = {
        "R_tree": np.stack([_quat_to_R64(joint_quat[i]) for i in range(model.nb)]),
        "p_tree": c(model.joint_pos),
        "axis": c(model.joint_axis),
        "inertia": np.stack([
            _spatial_inertia64(float(mass[i]), com[i], inert[i].astype(np.float64))
            for i in range(model.nb)
        ]),
        "dof_kp": c(model.dof_stiffness), "dof_kd": c(model.dof_damping),
        "dof_lower": c(model.dof_lower), "dof_upper": c(model.dof_upper),
        "dof_effort": c(model.dof_effort), "dof_maxvel": c(model.dof_maxvel),
        "dof_armature": c(model.dof_armature), "dof_friction": c(model.dof_friction),
        "geom_off": c(model.geom_offset), "geom_r": c(model.geom_radius),
        # per-env friction (N, ng) reaches the kernel as an input, not here
        "geom_mu": c(model.geom_friction) if model.geom_friction.ndim == 1 else [],
        "geom_meff": c(model.geom_meff),
        "geom_meff_el": c(model.geom_meff if model.geom_meff_el is None else model.geom_meff_el),
        "gravity": c(model.gravity),
        # gravity compensation: 0 where a body keeps its gravity; the product
        # in fp32, as the plain version forms it
        "gc_mass": [] if model.body_gravcomp is None else c(model.body_gravcomp) * mass,
        "com": com,
    }
    for name, arr in floats.items():
        flat = np.asarray(arr, np.float32).ravel()
        getattr(m, name)[: flat.size] = flat.tolist()
    m.kn = float(model.contact_stiffness)
    m.kd = float(model.contact_damping)
    m.kt = float(model.tangential_stiffness)
    m.limit_k, m.limit_d = engine._LIMIT_STIFFNESS, engine._LIMIT_DAMPING
    m.fric_eps = engine._FRICTION_VEL_EPS
    m.max_angvel, m.max_linvel = engine._MAX_ROOT_ANGVEL, engine._MAX_ROOT_LINVEL
    return m


@dataclass
class FusedTables:
    """A model and its kernel table on one device."""

    model: SimModel
    table: torch.Tensor  # uint8 bytes of a FusedModel, on the model's device


def build_tables(model: SimModel, device) -> FusedTables:
    raw = bytes(pack_model(model))
    table = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    return FusedTables(model=model.to(device), table=table)


def cached_tables(model: SimModel, device, build):
    """`build(model, device)`, cached on the model per builder and device."""
    key = (build.__module__, str(torch.device(device)))
    if key not in model.fused_cache:
        model.fused_cache[key] = build(model, device)
    return model.fused_cache[key]


def tables_for(model: SimModel, device) -> FusedTables:
    """`build_tables`, cached on the model per device."""
    return cached_tables(model, device, build_tables)


# ------------------------------------------------ helpers of the kernel wrappers

def to_minor(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) -> its env-minor copy (k, n): element (i, env) at i * n + env."""
    return t.reshape(n, t.numel() // n).t().contiguous()


def from_minor(t: torch.Tensor, n: int, *shape) -> torch.Tensor:
    """An env-minor (k, n) tensor back to (n, *shape)."""
    return t.t().contiguous().view(n, *shape)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a launch function; None and an empty
    tensor (a zero-width table of a scene without geoms) give NULL."""
    return ctypes.c_void_p(0 if t is None or t.numel() == 0 else t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """The current CUDA stream of `dev`, for a launch function."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def fused_substep_plain(tables: FusedTables, q, qd, pos_target, vel_target, effort, slip_g, h: float,
                        substeps: int, ground_h=None, ground_n=None, geom_fric=None, body_wrench=None):
    """The kernel's plain version: `engine._substep` looped `substeps` times,
    with the kernel's semantics for its optional inputs: the ground height
    `ground_h` (N, ng) and normal `ground_n` (N, ng, 3) under each geom are
    held across the substeps (None: the plane z = 0), `geom_fric` (N, ng)
    is the per-env friction (None: the model's `geom_friction`), and
    `body_wrench` (N, nb, 6), world [moment, force] about each body origin,
    is added to f_ext after the contacts in every substep (None: none).
    `slip_g` may be None for a scene without geoms.

    Returns (q, qd, dof_force, contact_force, contact_torque, slip_g,
    joint_wrench): the contact torque is the contacts' moment alone, without
    the body wrench; joint_wrench (N, ns, 6) is that of the last substep,
    None when the model has no force sensors (`sensor_body`)."""
    model = tables.model
    if geom_fric is not None:
        model = dataclasses.replace(model, geom_friction=geom_fric)
    terrain = None if ground_h is None else contact.HeldGround(ground_h, ground_n)
    ctrl = engine.Control(pos_target=pos_target, vel_target=vel_target, effort=effort, body_wrench=body_wrench)
    out = engine._substeps_plain(model, terrain, q, qd, ctrl, slip_g, None, h, substeps)
    # a scene without geoms has no slip state: `slip_g` back as given, as the kernel's wrapper returns it
    return out[:5] + (out[5] if model.ng else slip_g, out[7])


def _check(name: str, t: torch.Tensor, shape, device, who: str = "fused_substep") -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{who}: {name} must be float32 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def fused_substep(tables: FusedTables, q, qd, pos_target, vel_target, effort, slip_g, h: float, substeps: int,
                  ground_h=None, ground_n=None, geom_fric=None, body_wrench=None, probe=None):
    """All `substeps` substeps of one control step; same outputs as
    `fused_substep_plain` (the sensor wrenches, None without sensors: the
    kernel writes them from the last substep's ABA).  A CUDA
    `q` launches the kernel; a CPU `q` runs the plain version.

    `ground_h`/`ground_n` (terrain_mode), `geom_fric` (fric_mode) and
    `body_wrench` (wrench_mode) are the kernel's optional inputs, as
    `fused_substep_plain` reads them.  `probe`,
    when given, is an (N, substeps, 2, ng) float32 CUDA tensor that the
    kernel fills, per substep and geom, with the ground depth ([:, s, 0],
    active where > 0) and f_mag - f_max of the Coulomb clamp ([:, s, 1],
    clamped where > 0): a witness of the decisions taken near their
    thresholds, for checks; nothing on the main path reads it."""
    if (ground_h is None) != (ground_n is None):
        raise ValueError("fused_substep: ground_h and ground_n go together")
    if q.device.type == "cpu":
        if probe is not None:
            raise ValueError("fused_substep: probe is an output of the kernel only")
        return fused_substep_plain(tables, q, qd, pos_target, vel_target, effort, slip_g, h, substeps,
                                   ground_h, ground_n, geom_fric, body_wrench)
    if q.device.type != "cuda":
        raise ValueError(f"fused_substep: unsupported device {q.device}")
    model = tables.model
    n, dev = q.shape[0], q.device
    if tables.table.device != dev:
        raise ValueError(f"fused_substep: tables on {tables.table.device}, state on {dev}")
    if geom_fric is None and model.geom_friction.ndim != 1:
        raise ValueError("fused_substep: a model with per-env friction needs geom_fric")
    _check("q", q, (n, model.nq), dev)
    _check("qd", qd, (n, model.nv), dev)
    for name, t in (("pos_target", pos_target), ("vel_target", vel_target), ("effort", effort)):
        _check(name, t, (n, model.nd), dev)
    if model.ng or slip_g is not None:
        _check("slip_g", slip_g, (n, model.ng, 3), dev)
    for name, t, shape in (("ground_h", ground_h, (n, model.ng)), ("ground_n", ground_n, (n, model.ng, 3)),
                           ("geom_fric", geom_fric, (n, model.ng)), ("body_wrench", body_wrench, (n, model.nb, 6)),
                           ("probe", probe, (n, substeps, 2, model.ng))):
        if t is not None:
            _check(name, t, shape, dev)

    qT, qdT, tgtT, vtgT, effT = (to_minor(t, n) for t in (q, qd, pos_target, vel_target, effort))
    # a scene without geoms has no slip state: a null pointer the kernel never reads
    slipT = None if not model.ng else to_minor(slip_g, n)
    ghT, gnT, gfT, bwT = (None if t is None else to_minor(t, n) for t in (ground_h, ground_n, geom_fric, body_wrench))
    dof_force = torch.empty((model.nd, n), dtype=torch.float32, device=dev)
    cf = torch.empty((model.nb * 3, n), dtype=torch.float32, device=dev)
    ct = torch.empty((model.nb * 3, n), dtype=torch.float32, device=dev)
    probeT = None if probe is None else torch.empty((substeps * 2 * model.ng, n), dtype=torch.float32, device=dev)
    ns = len(model.sensor_body)
    jwT = torch.empty((ns * 6, n), dtype=torch.float32, device=dev) if ns else None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused_substep_launch(
            ptr(tables.table), ptr(qT), ptr(qdT), ptr(tgtT), ptr(vtgT), ptr(effT),
            ptr(slipT), ptr(ghT), ptr(gnT), ptr(gfT), ptr(bwT), ptr(dof_force), ptr(cf), ptr(ct), ptr(jwT),
            ptr(probeT),
            n, float(h), float(h * h), int(substeps), stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"fused_substep kernel launch failed: CUDA error {err}")
    fused_substep.launches += 1
    if probe is not None:
        probe.copy_(from_minor(probeT, n, substeps, 2, model.ng))
    return (
        from_minor(qT, n, model.nq),
        from_minor(qdT, n, model.nv),
        from_minor(dof_force, n, model.nd),
        from_minor(cf, n, model.nb, 3),
        from_minor(ct, n, model.nb, 3),
        slip_g if slipT is None else from_minor(slipT, n, model.ng, 3),
        None if jwT is None else from_minor(jwT, n, ns, 6),
    )


fused_substep.launches = 0


def build_library(source: str = SOURCE) -> tuple[str, float, str]:
    """Compile `source` (a .cu file of csrc/) with one nvcc call unless a build
    of the same csrc/ files already exists.  Returns (library path, build
    seconds, nvcc output).

    The library's name carries a hash of every file under csrc/ (the shared
    header too) and of the flags, so an edit to any of them builds anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(f for f in os.listdir(CSRC) if os.path.isfile(os.path.join(CSRC, f))):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {stem} needs the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    fn = lib.fused_substep_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
