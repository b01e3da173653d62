"""The split physics substep: a contacts kernel and a dynamics kernel per substep.

Replaces the TPU kernels of `isaacgymenv_tpu/physics/fused_split.py`,
`contacts_kernel` (B2) and `dynamics_kernel` (B3), for the scenes that
`split_structural_ok` accepts and `engine._use_fused` sends here: those with
pair contacts, fixed tendons or `no_ground` (ShadowHand).  Both kernels live
in one fixed source, `csrc/split_substep.cu`, built by one `nvcc` call at
first use (`fused.build_library`).  The model travels as data: a
`SplitModel` table (B1's `FusedModel` plus the tendons) and the pair table,
`pint` (n_pairs x 4, int32) and `pflt` (n_pairs x 25, fp32), in the slots of
the TPU kernel.

`split_substep` is the wrapper: a CUDA state launches `substeps` x (B2 -> B3)
through `launch_contacts` and `launch_dynamics`, which count their launches
in `.launches` and raise when a launch fails; a CPU state runs
`split_substep_plain`, the `engine._substep` loop.  `contacts_plain` and
`dynamics_plain` are the plain versions of each kernel alone.

B2's wrench mode (`body_wrench=`, JAX `wrench_mode`): an external wrench
per body (N, nb, 6), world frame, [moment, force] about the body origin,
held across the substeps, which B2 adds to f_ext after the contacts and
anchors; the contact torque it writes holds no wrench.  World anchors
(`SimModel.anchor_body`, up to MAX_ANCHORS) travel in the table; B2 adds
their spring-dampers after the pairs.  B3's sensor output: when the model
has force sensors (`sensor_body`), the last substep's B3 launch writes each
sensor body's inbound joint wrench from its ABA, as B1 does.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from isaacgymenv_tpu_torch.physics import engine, fused, kinematics
from isaacgymenv_tpu_torch.physics.fused import from_minor, ptr, stream, to_minor
from isaacgymenv_tpu_torch.physics.types import SimModel

SOURCE = os.path.join(fused.CSRC, "split_substep.cu")

# compile-time caps of csrc/split_substep.cu (SP_MAX_*)
MAX_PAIRS, MAX_TENDONS, MAX_TENDON_DOFS, MAX_ANCHORS = 1024, 8, 4, 8

# pair table slots (isaacgymenv_tpu/physics/fused_split.py:83-101)
PI_G, PI_GB, PI_SB, PI_KIND, PI_N = 0, 1, 2, 3, 4
PF_RG, PF_MG, PF_MGEL, PF_MS, PF_MSEL, PF_MU_S, PF_MU = 0, 1, 2, 3, 4, 5, 6
PF_OFF, PF_SIZE, PF_ROTM, PF_GOFF, PF_N = 7, 10, 13, 22, 25


class SplitModel(ctypes.Structure):
    """Field-for-field mirror of `struct SplitModel` in csrc/split_substep.cu."""

    _fields_ = [
        ("base", fused.FusedModel),
        ("no_ground", ctypes.c_int), ("n_pairs", ctypes.c_int), ("nt", ctypes.c_int),
        ("tendon_n", ctypes.c_int * MAX_TENDONS),
        ("tendon_dof", ctypes.c_int * (MAX_TENDONS * MAX_TENDON_DOFS)),
        ("tendon_coef", ctypes.c_float * (MAX_TENDONS * MAX_TENDON_DOFS)),
        ("tendon_lo", ctypes.c_float * MAX_TENDONS), ("tendon_hi", ctypes.c_float * MAX_TENDONS),
        ("tendon_k", ctypes.c_float * MAX_TENDONS), ("tendon_d", ctypes.c_float * MAX_TENDONS),
        ("na", ctypes.c_int),
        ("anchor_body", ctypes.c_int * MAX_ANCHORS),
        ("anchor_off", ctypes.c_float * (MAX_ANCHORS * 3)),
        ("anchor_target", ctypes.c_float * (MAX_ANCHORS * 3)),
        ("anchor_meff", ctypes.c_float * MAX_ANCHORS),
    ]


def split_structural_ok(model: SimModel) -> bool:
    """True when the scene's pairs, tendons and anchors fit the split tables'
    caps.  The joints and the FusedModel caps are `fused.fused_structural_ok`'s."""
    return (model.n_pairs <= MAX_PAIRS and len(model.tendon_dof) <= MAX_TENDONS
            and all(len(td) <= MAX_TENDON_DOFS for td in model.tendon_dof)
            and len(model.anchor_body) <= MAX_ANCHORS)


def pack_pairs(model: SimModel) -> tuple[np.ndarray, np.ndarray]:
    """The pair table: pint (n_pairs, 4) int32 and pflt (n_pairs, 25) fp32,
    one row per (sphere geom, surface) pair, from the model leaves."""
    c = lambda t: t.detach().cpu().numpy()  # noqa: E731
    n_pairs = model.n_pairs
    pint = np.zeros((n_pairs, PI_N), np.int32)
    pflt = np.zeros((n_pairs, PF_N), np.float32)
    if not n_pairs:
        return pint, pflt
    g = np.asarray(model.pair_geom)
    s = np.asarray(model.pair_surf)
    pint[:, PI_G] = g
    pint[:, PI_GB] = np.asarray(model.geom_body)[g]
    pint[:, PI_SB] = np.asarray(model.surf_body)[s]
    pint[:, PI_KIND] = np.asarray(model.surf_kind)[s]
    g_el = model.geom_meff if model.geom_meff_el is None else model.geom_meff_el
    s_el = model.surf_meff if model.surf_meff_el is None else model.surf_meff_el
    pflt[:, PF_RG] = c(model.geom_radius)[g]
    pflt[:, PF_MG] = c(model.geom_meff)[g]
    pflt[:, PF_MGEL] = c(g_el)[g]
    pflt[:, PF_MS] = c(model.surf_meff)[s]
    pflt[:, PF_MSEL] = c(s_el)[s]
    pflt[:, PF_MU_S] = c(model.surf_friction)[s]
    # in fp32, as the plain version forms it
    pflt[:, PF_MU] = np.sqrt(c(model.geom_friction)[g] * c(model.surf_friction)[s])
    pflt[:, PF_OFF:PF_OFF + 3] = c(model.surf_offset)[s]
    pflt[:, PF_SIZE:PF_SIZE + 3] = c(model.surf_size)[s]
    pflt[:, PF_ROTM:PF_ROTM + 9] = c(model.surf_rotm)[s].reshape(n_pairs, 9)
    pflt[:, PF_GOFF:PF_GOFF + 3] = c(model.geom_offset)[g]
    return pint, pflt


def pack_model(model: SimModel) -> SplitModel:
    """Fill the kernels' model table (host side)."""
    m = SplitModel()
    m.base = fused.pack_model(model)
    m.no_ground = int(bool(model.no_ground))
    m.n_pairs = model.n_pairs
    m.nt = len(model.tendon_dof)
    if m.nt:
        coef = model.tendon_coef.detach().cpu().numpy()
        rng = model.tendon_range.detach().cpu().numpy()
        for t, dofs in enumerate(model.tendon_dof):
            m.tendon_n[t] = len(dofs)
            for j, d in enumerate(dofs):
                m.tendon_dof[t * MAX_TENDON_DOFS + j] = int(d)
                m.tendon_coef[t * MAX_TENDON_DOFS + j] = float(coef[t, j])
            m.tendon_lo[t], m.tendon_hi[t] = float(rng[t, 0]), float(rng[t, 1])
            m.tendon_k[t], m.tendon_d[t] = float(model.tendon_k[t]), float(model.tendon_d[t])
    m.na = len(model.anchor_body)
    if m.na:
        m.anchor_body[: m.na] = [int(b) for b in model.anchor_body]
        for name, t in (("anchor_off", model.anchor_offset), ("anchor_target", model.anchor_target),
                        ("anchor_meff", model.anchor_meff)):
            flat = t.detach().cpu().numpy().astype(np.float32).ravel()
            getattr(m, name)[: flat.size] = flat.tolist()
    return m


@dataclass
class SplitTables:
    """A model, its kernel table and its pair table on one device."""

    model: SimModel
    table: torch.Tensor  # uint8 bytes of a SplitModel
    pint: torch.Tensor   # (n_pairs, 4) int32
    pflt: torch.Tensor   # (n_pairs, 25) float32


def build_tables(model: SimModel, device) -> SplitTables:
    raw = bytes(pack_model(model))
    pint, pflt = pack_pairs(model)
    return SplitTables(
        model=model.to(device),
        table=torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device),
        pint=torch.from_numpy(pint).to(device),
        pflt=torch.from_numpy(pflt).to(device),
    )


def tables_for(model: SimModel, device) -> SplitTables:
    """`build_tables`, cached on the model per device."""
    return fused.cached_tables(model, device, build_tables)


# ------------------------------------------------------------ plain versions

def split_substep_plain(tables: SplitTables, q, qd, pos_target, vel_target, effort, slip_g, slip_p,
                        h: float, substeps: int, body_wrench=None):
    """The kernel pair's plain version: `engine._substep` looped `substeps` times.

    Returns (q, qd, dof_force, contact_force, contact_torque, slip_g, slip_p,
    joint_wrench): joint_wrench (N, ns, 6) is the last substep's, None when
    the model has no force sensors."""
    ctrl = engine.Control(pos_target=pos_target, vel_target=vel_target, effort=effort, body_wrench=body_wrench)
    return engine._substeps_plain(tables.model, None, q, qd, ctrl, slip_g, slip_p, h, substeps)


def contacts_plain(tables: SplitTables, q, qd, slip_g, slip_p, h: float, body_wrench=None):
    """B2's plain version: (f_ext (N, nb, 6), contact_force, contact_torque, slip_g, slip_p);
    the contact torque is the moment of the contacts and anchors; `body_wrench`
    (N, nb, 6) is added to f_ext and not to the contact torque."""
    model = tables.model
    f_ext, cf, slip_g, slip_p = engine._contacts(model, None, kinematics.fk(model, q, qd), slip_g, slip_p, h)
    ct = f_ext[..., :3]
    if body_wrench is not None:
        f_ext = f_ext + body_wrench
    return f_ext, cf, ct, slip_g, slip_p


def dynamics_plain(tables: SplitTables, q, qd, pos_target, vel_target, effort, f_ext, h: float):
    """B3's plain version: (q, qd, dof_force, joint_wrench), joint_wrench
    (N, ns, 6) None when the model has no force sensors."""
    model = tables.model
    ctrl = engine.Control(pos_target=pos_target, vel_target=vel_target, effort=effort)
    return engine._dynamics(model, kinematics.fk(model, q, qd), q, qd, ctrl, f_ext, h)


# ------------------------------------------------------------ the kernels

def launch_contacts(tables: SplitTables, qT, qdT, slip_gT, slip_pT, fext, cf, ct, h: float, counts=None,
                    bwT=None) -> None:
    """One launch of B2 on env-minor CUDA tensors: q (nq, N), qd (nv, N),
    slip_g (3 ng, N) or None for a `no_ground` scene, slip_p (3 n_pairs, N)
    or None without pairs, both updated in place; writes fext (6 nb, N), cf
    and ct (3 nb, N), and, when given, counts (nb, N): the live contacts
    loading each body, as the kernel counted them in its first pass.  bwT
    (6 nb, N) or None: the body wrenches (wrench mode), added to fext."""
    if qT.device.type != "cuda":
        raise ValueError(f"launch_contacts: the kernel needs CUDA tensors, got {qT.device}")
    with torch.cuda.device(qT.device):
        err = _library().split_contacts_launch(
            ptr(tables.table), ptr(tables.pint), ptr(tables.pflt), ptr(qT), ptr(qdT),
            ptr(slip_gT), ptr(slip_pT), ptr(fext), ptr(cf), ptr(ct), ptr(counts), ptr(bwT),
            qT.shape[1], float(h), float(h * h), stream(qT.device),
        )
    if err != 0:
        raise RuntimeError(f"split_contacts kernel launch failed: CUDA error {err}")
    launch_contacts.launches += 1


def launch_dynamics(tables: SplitTables, qT, qdT, tgtT, vtgT, effT, fext, dof_force, h: float,
                    jwT=None) -> None:
    """One launch of B3 on env-minor CUDA tensors: q (nq, N) and qd (nv, N)
    updated in place from the targets (nd, N) and fext (6 nb, N); writes
    dof_force (nd, N) and, when given, jwT (6 ns, N): the sensor bodies'
    joint wrenches of this launch's ABA (the sensor output)."""
    if qT.device.type != "cuda":
        raise ValueError(f"launch_dynamics: the kernel needs CUDA tensors, got {qT.device}")
    with torch.cuda.device(qT.device):
        err = _library().split_dynamics_launch(
            ptr(tables.table), ptr(qT), ptr(qdT), ptr(tgtT), ptr(vtgT), ptr(effT),
            ptr(fext), ptr(dof_force), ptr(jwT), qT.shape[1], float(h), float(h * h), stream(qT.device),
        )
    if err != 0:
        raise RuntimeError(f"split_dynamics kernel launch failed: CUDA error {err}")
    launch_dynamics.launches += 1


launch_contacts.launches = 0
launch_dynamics.launches = 0


def split_substep(tables: SplitTables, q, qd, pos_target, vel_target, effort, slip_g, slip_p,
                  h: float, substeps: int, body_wrench=None):
    """All `substeps` substeps of one control step; same outputs as
    `split_substep_plain`.  A CUDA `q` launches B2 and B3 once per substep
    (B2 in its wrench mode when `body_wrench` (N, nb, 6) is given; the last
    B3 with its sensor output when the model has force sensors); a CPU `q`
    runs the plain version."""
    if q.device.type == "cpu":
        return split_substep_plain(tables, q, qd, pos_target, vel_target, effort, slip_g, slip_p, h, substeps,
                                   body_wrench)
    if q.device.type != "cuda":
        raise ValueError(f"split_substep: unsupported device {q.device}")
    model = tables.model
    n, dev = q.shape[0], q.device
    if tables.table.device != dev:
        raise ValueError(f"split_substep: tables on {tables.table.device}, state on {dev}")
    check = functools.partial(fused._check, device=dev, who="split_substep")
    check("q", q, (n, model.nq))
    check("qd", qd, (n, model.nv))
    for name, t in (("pos_target", pos_target), ("vel_target", vel_target), ("effort", effort)):
        check(name, t, (n, model.nd))
    ground = model.ng and not model.no_ground
    if ground:
        check("slip_g", slip_g, (n, model.ng, 3))
    if model.n_pairs:
        check("slip_p", slip_p, (n, model.n_pairs, 3))
    if body_wrench is not None:
        check("body_wrench", body_wrench, (n, model.nb, 6))

    qT, qdT, tgtT, vtgT, effT = (to_minor(t, n) for t in (q, qd, pos_target, vel_target, effort))
    slip_gT = to_minor(slip_g, n) if ground else None
    slip_pT = to_minor(slip_p, n) if model.n_pairs else None
    bwT = None if body_wrench is None else to_minor(body_wrench, n)
    empty = lambda k: torch.empty((k, n), dtype=torch.float32, device=dev)  # noqa: E731
    fext, cf, ct, dof_force = empty(6 * model.nb), empty(3 * model.nb), empty(3 * model.nb), empty(model.nd)
    ns = len(model.sensor_body)
    jwT = empty(6 * ns) if ns else None
    for s in range(substeps):
        launch_contacts(tables, qT, qdT, slip_gT, slip_pT, fext, cf, ct, h, bwT=bwT)
        launch_dynamics(tables, qT, qdT, tgtT, vtgT, effT, fext, dof_force, h, jwT if s == substeps - 1 else None)
    return (
        from_minor(qT, n, model.nq),
        from_minor(qdT, n, model.nv),
        from_minor(dof_force, n, model.nd),
        from_minor(cf, n, model.nb, 3),
        from_minor(ct, n, model.nb, 3),
        from_minor(slip_gT, n, model.ng, 3) if ground else slip_g,
        from_minor(slip_pT, n, model.n_pairs, 3) if model.n_pairs else slip_p,
        None if jwT is None else from_minor(jwT, n, ns, 6),
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(fused.build_library(SOURCE)[0])
    lib.split_contacts_launch.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.split_dynamics_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.split_contacts_launch.restype = ctypes.c_int
    lib.split_dynamics_launch.restype = ctypes.c_int
    return lib
