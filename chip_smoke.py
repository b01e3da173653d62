"""Chip smoke test of the PyTorch + CUDA port (isaacgymenv_tpu_torch) on one GPU.

Run from the repo root on a machine with an NVIDIA H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. device: the card's name and power limit (nvidia-smi);
2. build: both kernel sources of isaacgymenv_tpu_torch/csrc/, one nvcc call
   each, started together, as `make()` would at first use;
3. B1 vs plain: Anymal at 4096 envs, numpy-seeded states near the standing
   pose with feet in contact, one control step through the fused kernel and
   through `fused_substep_plain` on the card, compared at the tolerances of
   tests/test_fused.py; both timed with CUDA events (median of several runs);
   B2 + B3 on the same flat-ground states (Anymal's model through the split
   tables) against `split_substep_plain`;
4. B1 in terrain_mode + fric_mode vs plain: AnymalTerrain at 4096 envs on
   the full 10 x 20 trimesh grid, states on every level and type off the
   flat spawn platforms with feet in contact on slopes, stairs, obstacles
   and stones, one control step of 8 substeps with the same held ground
   (height and normal per geom) and per-env friction given to both, at the
   tolerances of phase 3; B1's probe (each geom's depth and Coulomb clamp
   margin per substep) against the plain version's as the decision witness;
   timed as phase 3;
5. the Anymal slice: `make("Anymal", num_envs=4096)` on cuda, then 100
   acting steps (normalize obs -> ActorCritic -> sample actions -> env.step)
   with random weights from a seed; checks finiteness, the obs shape and the
   launch counts (B1 once per step, no split kernel); then 2 steps at 128
   envs held against the plain version on the CPU with the same draws;
6. the AnymalTerrain slice: `make("AnymalTerrain", 4096)` with the trimesh
   grid, 100 acting steps with the [512, 256, 128] policy, B1 once per step;
   then the env step on the card (ground held per control step) against the
   CPU (ground looked up every substep) at 128 envs: 8 steps from the env's
   own start, through the feet's touchdown, and 2 steps from states standing
   and moving on the hard terrain; envs excused only where a geom's or a
   height-scan point's lookup differs (the held-against-per-substep
   witness) or a contact decision differs within rounding of its threshold
   (the decision witness), each check's share bounded;
7. B2 + B3 vs plain: ShadowHand at 16384 envs, numpy-seeded states with the
   cube resting on the palm (pair contacts active), one control step through
   the split kernels and through `split_substep_plain`, compared at the
   tolerances of tests/test_fused_split.py, envs excused only where B2's own
   live contact counts (its `counts=` output) differ from the plain
   version's; the plain second substep from the kernel's own state; each
   kernel alone against its own plain version (`contacts_plain`,
   `dynamics_plain`); each kernel, the wrapper and the plain versions timed
   with CUDA events;
8. the ShadowHand slice: `make("ShadowHand", num_envs=16384)` on cuda, 100
   acting steps with the [512, 512, 256, 128] policy; launch counts (each
   split kernel twice per step, no B1); then 2 steps at 128 envs from the
   resting state held against the CPU plain path;
8b. the ShadowHandOpenAI_FF slice (openai obs of 42, states of 211, random
   object forces): B2 in its wrench mode + B3 against the plain version at
   16384 envs as phase 7, every env carrying a body wrench (the task's
   object force, small wrenches on the hand's moving bodies, 3 N and 1 N m
   on the two welded root bodies), with the count witness; B2's own outputs
   held to its contract, f_ext = the contacts' wrench + the body wrench in
   each of the 162 entries and no wrench in the contact torque; 100 acting steps with the [400, 400, 200, 100] policy (each
   split kernel twice per step); the env step on the card against the CPU
   at 128 envs with the same draws (obs, states, reward, done, q, the
   object force; at least one env's force fired); then the training CLI
   (`task=ShadowHandOpenAI_FF`, 16384 envs, HAND_TRAIN_EPOCHS epochs and a
   resumed one, the central value on the states): finite actor and central
   value losses, 16 launches of each split kernel per epoch (horizon 8),
   the checkpoint's central value equal to the trained one;
9. the Ant slice: B1's force-sensor output against `fused_substep_plain` at
   4096 Ant envs (the four feet, revolute) from a state settled onto the
   feet, and on tests/test_fused.py's scene (a fixed-joint sensor body) at
   4096 envs, with the decision witness of phase 4 and the sensor
   wrenches' tolerance of tests/test_fused.py; 100 acting steps at 4096
   envs (B1 once per step); the env step against the CPU at 128 envs, obs
   with the sensor entries; then the training CLI in-process
   (`task=Ant`, 4096 envs, TRAIN_EPOCHS epochs, then a resume from its
   checkpoint for one more): finite losses and learning rate, B1 launched
   horizon_length times per epoch; rollout and update times, env-steps/s
   and the mean return as information;
10. the Quadcopter slice: B1 in its wrench mode against `fused_substep_plain`
   at 8192 envs on the scene without geoms (every env in flight with
   thrusts of 0-2 N along its rotors' axes and small wrenches on every
   body): the contact force and torque exactly 0, a zero wrench bit for bit
   equal to none; 100 acting steps with the [256, 256, 128] policy (B1 once
   per step); the env step against the CPU at 128 envs (obs, reward, done,
   q, the dof targets and thrusts); the training CLI (`task=Quadcopter`,
   SMALL_TRAIN_EPOCHS epochs and a resumed one, B1 8 times per epoch);
11. the BallBalance slice: B2 with the world anchors and B3 with the tray's
   sensor output against `split_substep_plain` at 4096 envs from the ball
   on the tray (the count witness at every one of the 4 substeps' starts),
   each kernel alone against its plain version; B3's sensor output on
   ShadowHand's model with six revolute finger bodies declared as sensor
   bodies at 16384 envs (real wrenches, tests/test_fused.py's tolerance);
   100 acting steps with the [128, 64, 32] policy (B2 and B3 each 4 times
   per step); the env step against the CPU at 128 envs from the ball on the
   tray; the training CLI (`task=BallBalance`, 64 + 64 launches per epoch);
12. the FrankaCubeStack slice: B2 in its gravcomp mode + B3 (the arm on
   effort drive, the fingers on position drive) against `split_substep_plain`
   at 8192 envs from the cubes settled on the table and the fingers at cube
   A (40 acting steps of a reaching command from the env's own start; the
   compared step closes the gripper), with
   the count witness at both substeps' starts and each kernel alone; B2
   alone on every compensated body without contact, whose f_ext must be
   -gravcomp m g at its world COM; B1's gravcomp mode on the Franka alone
   (no pairs, B1's scene) at 8192 envs against `fused_substep_plain`, the
   scene without gravity compensation bit for bit equal to all-zero
   gravcomp; 100 acting steps with the [256, 128, 64] policy (B2 and B3
   twice per step, the OSC on the host side of the step); the env step
   against the CPU at 128 envs from the env's own start, with the count
   witness replayed over every recorded physics step; the training CLI
   (`task=FrankaCubeStack`, 32 + 32 launches per epoch);
13. the `kernels` JSON line (B1 once per mode set: flat, terrain + friction,
   sensors, wrench, gravcomp; B2, B2 in wrench mode, B2 with anchors, B2 in
   gravcomp mode; B3, B3 with its sensor output), the card line, and the
   final ok line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 4096          # Anymal (cfg/task/Anymal.yaml)
HAND_ENVS = 16384      # ShadowHand (cfg/task/ShadowHand.yaml)
QUAD_ENVS = 8192       # Quadcopter (cfg/task/Quadcopter.yaml)
BALL_ENVS = 4096       # BallBalance (cfg/task/BallBalance.yaml)
N_STEPS = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
# (rtol, atol) per output, those of tests/test_fused.py for q, qd, dof_force,
# contact_force; contact torque as contact force; slip as a position
TOLS = {
    "q": (2e-4, 2e-4), "qd": (2e-3, 2e-3), "dof_force": (2e-3, 2e-3),
    "contact_force": (2e-3, 2e-2), "contact_torque": (2e-3, 2e-2), "slip_g": (2e-4, 2e-4),
}
# the sensor wrenches' tolerance of tests/test_fused.py:126-130
SENSOR_TOLS = {**TOLS, "joint_wrench": (2e-3, 5e-2)}
# those of tests/test_fused_split.py:93-152, for the split pair's outputs
SPLIT_TOLS = {
    "q": (5e-4, 5e-4), "qd": (2e-3, 1e-2), "dof_force": (2e-3, 1e-2),
    "contact_force": (2e-3, 5e-2), "contact_torque": (2e-3, 5e-2), "slip_g": None, "slip_p": (2e-3, 1e-5),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# fp32 operation counts (an add, multiply, compare, min/max, sqrt or divide
# is one; an FMA two) of the per-env stages of csrc/substep_common.cuh and
# csrc/split_substep.cu, counted from their code for a model's topology
MM3, MV3, CROSS3, MV6 = 45, 15, 9, 72
MOT_TO_CHILD = FRC_TO_PARENT = 2 * MV3 + CROSS3 + 3
INERTIA_TO_PARENT = 13 * MM3 + 81
CHOL6 = 150


def _stage_flops(model) -> dict:
    """Per env, per substep: fk, ground (both passes and the budget shares),
    joint (drive + passive forces), aba and integrate."""
    from isaacgymenv_tpu_torch.physics.types import JT_FIXED, JT_FREE, JT_PRISMATIC, JT_REVOLUTE

    local = {JT_FREE: 30 + MM3 + MV3 + 3, JT_REVOLUTE: 48 + MM3, JT_PRISMATIC: MV3 + 9, JT_FIXED: 0}
    fk = aba = integrate = 0
    for i, jt in enumerate(model.jtype):
        has_par = model.parent[i] >= 0
        fk += local[jt] + (MM3 + MV3 + 3 + MOT_TO_CHILD + 6 if has_par else 0) + 30 + 2 * MV3
        aba += MV6 + 30 + 2 * MV3 + 6                                              # setup
        if jt in (JT_REVOLUTE, JT_PRISMATIC):
            aba += 2 * MV6 + 24 + 4 + 3 * 36 + 24                                  # inward
        elif jt == JT_FIXED:
            aba += MV6 + 6
        if has_par:
            aba += INERTIA_TO_PARENT + FRC_TO_PARENT + 6
        aba += MOT_TO_CHILD + 6 + (MV6 + 12 + CHOL6 + 12 if jt == JT_FREE else 17)  # outward
        integrate += 130 if jt == JT_FREE else 0
    ground = model.ng * (7 + MV3 + 2 + 2 * (CROSS3 + 3) + 47 + 1 + CROSS3 + 9) + model.nb * 2
    return {"fk": fk, "ground": ground, "joint": model.nd * (30 + 4), "aba": aba,
            "integrate": integrate + model.nv * 2}


# extra fp32 operations per geom that a held heightfield needs beyond the
# plane (csrc/substep_common.cuh ground_forces, which runs the plane as
# n = (0, 0, 1)): the held height in the depth, the normal in the contact
# point, v_n, v_t, the slip's third component and its projection, the third
# tangential force component and the normal force along n.  The plane's
# bound leaves them out: the plane's work does not need them.
TERRAIN_GROUND_EXTRA = 44


def sensor_flops(model) -> int:
    """fp32 operations of the force-sensor output per env, once per launch
    (csrc/substep_common.cuh aba, last substep): IA a and + pA for each
    sensor body, and for a 1-dof body the unreduced inertia's term U (U.a) / d."""
    from isaacgymenv_tpu_torch.physics.types import JT_PRISMATIC, JT_REVOLUTE

    one_dof = sum(model.jtype[b] in (JT_REVOLUTE, JT_PRISMATIC) for b in model.sensor_body)
    return len(model.sensor_body) * (MV6 + 6) + one_dof * (12 + 1 + 12)


def fused_substep_flops(model, n: int, substeps: int, terrain: bool = False, wrench: bool = False) -> int:
    """fp32 operations that csrc/fused_substep.cu performs for one launch
    (the sensor output when the model has sensors; in wrench mode one add
    per body wrench entry and substep; the gravity compensation of each
    compensated body per substep)."""
    extra = (TERRAIN_GROUND_EXTRA * model.ng if terrain else 0) + (6 * model.nb if wrench else 0) \
        + GRAVCOMP_FLOPS * gravcomp_bodies(model)
    return (sum(_stage_flops(model).values()) + extra) * substeps * n + sensor_flops(model) * n


def fused_substep_bytes(model, n: int, terrain: bool = False, fric: bool = False, wrench: bool = False) -> int:
    """Bytes one launch of B1 must move: each input read once, each output
    written once; the held ground (4 floats per geom), the per-env friction
    (1) and the body wrenches (6 per body) when their modes are on, the
    sensor wrenches (6 per sensor) when the model has sensors."""
    return 4 * n * (
        2 * (model.nq + model.nv + 3 * model.ng)   # q, qd, slip in and out
        + 3 * model.nd                             # targets + effort in
        + model.nd + 6 * model.nb                  # dof_force, contact force + torque out
        + (4 * model.ng if terrain else 0)         # ground_h, ground_n in
        + (model.ng if fric else 0)                # geom_fric in
        + (6 * model.nb if wrench else 0)          # body wrenches in
        + 6 * len(model.sensor_body)               # joint_wrench out
    )


# surface_closest per kind (sphere, box from outside, capsule, cylinder from outside)
CLOSEST_FLOPS = {0: 11, 1: 26, 2: 15, 3: 30}
PAIR_QUERY_FLOPS = 2 * MV3 + 3 + MM3 + 3 + 3 + MV3 + MV3 + 1   # c, R_s, p_s, d, local, n, depth
PAIR_FORCE_FLOPS = 170                                            # lever .. accumulation


# csrc/substep_common.cuh anchor_force: lever, w x lever, kp and kd, the
# spring-damper force, its moment and the accumulation
ANCHOR_FLOPS = MV3 + CROSS3 + 4 + 18 + CROSS3 + 6


# csrc/substep_common.cuh gravcomp_wrench, per compensated body: the force
# -gc_mass g, the world COM R com, its moment and the accumulation
GRAVCOMP_FLOPS = 3 + MV3 + CROSS3 + 6


def gravcomp_bodies(model) -> int:
    """The bodies whose gravity is compensated (gravcomp != 0)."""
    return 0 if model.body_gravcomp is None else int((model.body_gravcomp != 0).sum())


def split_contacts_flops(model, n: int, wrench: bool = False) -> int:
    """fp32 operations that one launch of B2 (split_contacts_kernel) performs:
    FK, the ground passes unless `no_ground`, two surface queries plus one
    force evaluation per pair (box queries counted on their outside branch)
    the world anchors and the gravity compensation of each compensated body;
    in wrench mode one add per body wrench entry (6 per body)."""
    st = _stage_flops(model)
    pairs = sum(2 * (PAIR_QUERY_FLOPS + CLOSEST_FLOPS[model.surf_kind[s]]) + 3 + PAIR_FORCE_FLOPS
                for s in model.pair_surf)
    ground = model.nb * 2 if model.no_ground else st["ground"]
    anchors = ANCHOR_FLOPS * len(model.anchor_body) + GRAVCOMP_FLOPS * gravcomp_bodies(model)
    return (st["fk"] + ground + pairs + anchors + (6 * model.nb if wrench else 0)) * n


def split_contacts_bytes(tables, n: int, wrench: bool = False) -> int:
    """Bytes one launch of B2 must move: its tables, q and qd in, the slips
    in and out, f_ext, contact force and torque out; in wrench mode the body
    wrenches (6 per body) in."""
    model = tables.model
    table_bytes = tables.table.numel() + 4 * (tables.pint.numel() + tables.pflt.numel())
    return table_bytes + 4 * n * (
        model.nq + model.nv                    # q, qd in
        + 6 * model.n_pairs                    # slip_p in and out
        + (0 if model.no_ground else 6 * model.ng)
        + 12 * model.nb                        # f_ext, contact force and torque out
        + (6 * model.nb if wrench else 0)      # body wrenches in
    )


def split_dynamics_flops(model, n: int) -> int:
    """fp32 operations that one launch of B3 (split_dynamics_kernel) performs."""
    st = _stage_flops(model)
    tendons = sum(6 * len(td) + 7 for td in model.tendon_dof)
    return (st["fk"] + st["joint"] + tendons + st["aba"] + st["integrate"]) * n


def bound(n_bytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is longer."""
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def near_standing_state(env, n: int, seed: int):
    """q, qd, pos_target, slip near the standing pose; many feet in contact."""
    rng = np.random.default_rng(seed)
    default = env.default_dof_pos.cpu().numpy()
    q = np.zeros((n, env.model.nq), np.float32)
    q[:, 2] = 0.5 + 0.12 * rng.random(n)
    quat = rng.normal(size=(n, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = default + 0.2 * rng.normal(size=(n, env.model.nd))
    qd = 0.3 * rng.normal(size=(n, env.model.nv))
    tgt = default + 0.3 * rng.normal(size=(n, env.model.nd))
    slip = 0.002 * rng.normal(size=(n, env.model.ng, 3))
    slip[..., 2] = 0.0
    return [torch.tensor(a, dtype=torch.float32) for a in (q, qd, tgt, slip)]


def phase_kernel_vs_plain(env, fused) -> dict:
    dev = env.device
    model = env.model
    tables = fused.tables_for(model, dev)
    q, qd, tgt, slip = (t.to(dev) for t in near_standing_state(env, N_ENVS, seed=1))
    zero = torch.zeros_like(tgt)
    h = env.dt / env.substeps
    args = (q, qd, tgt, zero, zero, slip, h, env.substeps)
    out = fused.fused_substep(tables, *args)
    ref = fused.fused_substep_plain(tables, *args)
    torch.cuda.synchronize()
    max_err = _compare("fused_substep (B1)", out, ref, TOLS)
    active = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"kernel vs plain at {N_ENVS} envs, {env.substeps} substeps: max abs err {max_err}; "
          f"envs with ground contact {active}")
    if active < N_ENVS // 4:
        raise AssertionError(f"only {active} envs have ground contact; the contact path is not exercised")

    ms = cuda_ms(lambda: fused.fused_substep(tables, *args))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(tables, *args), warmup=1, runs=5)
    b = bound(fused_substep_bytes(model, N_ENVS), fused_substep_flops(model, N_ENVS, env.substeps))
    print(f"fused_substep: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} bytes "
          f"-> {b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}


TERRAIN_OVERRIDES = {"env.terrain.terrainType": "trimesh"}  # the JAX package's run of this task
TILT_DEG = 5.0


def terrain_standing_state(env, n: int, seed: int, motion: float = 1.0):
    """AnymalTerrain q, qd, pos_target, slip, levels, types (CPU tensors):
    env e on level e % levels and type (e // levels) % types of the grid,
    1.8-3.5 m off its sub-terrain's center (past the flat spawn platform, on
    the slopes, stairs, obstacles or stones), near the standing pose and
    lowered until its lowest geom is 0-5 mm into the ground.  `motion` scales
    the spread of the pose and the velocities (qd ~ N(0, 0.3 motion))."""
    from isaacgymenv_tpu_torch.physics import contact, engine, kinematics

    rng = np.random.default_rng(seed)
    model = env.model.to("cpu")
    terrain = env.terrain.to("cpu")
    levels = torch.arange(n) % env.num_levels
    types = (torch.arange(n) // env.num_levels) % env.num_types
    origins = env.terrain_origins.cpu()[levels, types].numpy()
    default = env.default_dof_pos.cpu().numpy()
    q = np.zeros((n, model.nq), np.float32)
    angle, radius = rng.uniform(0.0, 2 * np.pi, n), rng.uniform(1.8, 3.5, n)
    q[:, 0] = origins[:, 0] + radius * np.cos(angle)
    q[:, 1] = origins[:, 1] + radius * np.sin(angle)
    quat = rng.normal(size=(n, 4)) * 0.05 * motion + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = default + 0.2 * motion * rng.normal(size=(n, model.nd))
    _, _, _, _, gpos, _ = engine._geom_world(model, kinematics.fk(model, torch.tensor(q), torch.zeros(n, model.nv)))
    clearance = gpos[..., 2] - model.geom_radius - contact.height_at(terrain, gpos[..., 0], gpos[..., 1])
    q[:, 2] -= clearance.min(-1).values.numpy() + rng.uniform(0.0, 0.005, n)
    qd = 0.3 * motion * rng.normal(size=(n, model.nv))
    tgt = default + 0.3 * rng.normal(size=(n, model.nd))
    slip = np.zeros((n, model.ng, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return f(q), f(qd), f(tgt), f(slip), levels, types


# A Coulomb clamp decision (f_mag > f_max) whose margin |f_mag - f_max| lies
# within the contact force tolerance (TOLS' atol, in newtons) may be taken
# either way by two runs held to that tolerance; taken the other way it
# moves the slip anchor by a step, so the two legitimately diverge.
CLAMP_EPS = TOLS["contact_force"][1]


class PlainProbe:
    """The plain ground law's counterpart of B1's `probe`: while entered,
    each call of `contact.contact_forces` (one per substep of the plain loop)
    appends an (N, 2, ng) row of each geom's depth and f_mag - f_max of its
    Coulomb clamp, computed from the law's own inputs.  `probe(start, k)`
    stacks k rows into (N, k, 2, ng), as B1 writes its probe."""

    def __enter__(self):
        from isaacgymenv_tpu_torch.physics import contact

        self.rows, self._contact = [], contact
        self._saved = forces, stiction = contact.contact_forces, contact.stiction_force
        depth = {}

        def forces_rec(model, terrain, geom_pos_w, *args, **kwargs):
            depth["d"] = contact._depth(model, contact._height_under(terrain, geom_pos_w), geom_pos_w)
            return forces(model, terrain, geom_pos_w, *args, **kwargs)

        def stiction_rec(slip, v_t, n, fn, mu, kt_el, ct, h, active):
            s = slip + v_t * h  # the trial force of contact.stiction_force
            s = s - (s * n).sum(-1, keepdim=True) * n
            f_mag = torch.linalg.norm(-kt_el[..., None] * s - ct[..., None] * v_t, dim=-1)
            self.rows.append(torch.stack([depth["d"], f_mag - mu * fn], dim=-2).cpu())
            return stiction(slip, v_t, n, fn, mu, kt_el, ct, h, active)

        contact.contact_forces, contact.stiction_force = forces_rec, stiction_rec
        return self

    def __exit__(self, *exc) -> None:
        self._contact.contact_forces, self._contact.stiction_force = self._saved

    def probe(self, start: int, k: int) -> torch.Tensor:
        return torch.stack(self.rows[start:start + k], dim=1)


def decision_flips(k: torch.Tensor, p: torch.Tensor) -> dict:
    """The decision witness of one control step, from B1's probe `k` and the
    plain probe `p` (N, substeps, 2, ng): per env (N,) bools.  A geom's
    activation (depth > 0) or, active in both runs, its Coulomb clamp
    (f_mag - f_max > 0) differs at a substep ("activation", "clamp"); the
    flip is explained when, at the env's first such substep, a geom that
    differs there has its margin within rounding in either run: |depth|
    under THRESHOLD_EPS, |f_mag - f_max| under CLAMP_EPS."""
    act_k, act_p = k[:, :, 0] > 0, p[:, :, 0] > 0
    act_flip = act_k != act_p
    clamp_flip = act_k & act_p & ((k[:, :, 1] > 0) != (p[:, :, 1] > 0))
    margin = torch.minimum(k.abs(), p.abs())
    near = (act_flip & (margin[:, :, 0] < THRESHOLD_EPS)) | (clamp_flip & (margin[:, :, 1] < CLAMP_EPS))
    at = (act_flip | clamp_flip).any(-1)
    flipped = at.any(-1)
    first = at.int().argmax(-1)
    return {"flipped": flipped, "explained": flipped & near[torch.arange(k.shape[0]), first].any(-1),
            "activation": act_flip.any(-1).any(-1), "clamp": clamp_flip.any(-1).any(-1)}


def phase_terrain_kernel_vs_plain(env, fused) -> dict:
    """B1 in terrain_mode + fric_mode against `fused_substep_plain` on the same
    held inputs: AnymalTerrain at 4096 envs on the full grid, one control step
    of 8 substeps; B1's probe against the plain probe as the decision witness."""
    from isaacgymenv_tpu_torch.physics import contact, engine, kinematics, types

    dev, model = env.device, env.model
    n, h, substeps = env.num_envs, env.dt / env.substeps, env.substeps
    tables = fused.tables_for(model, dev)
    q, qd, tgt, slip, _, _ = (t.to(dev) for t in terrain_standing_state(env, n, seed=1))
    sim = engine.forward(model, env.terrain, dataclasses.replace(types.make_zero_state(model, n), q=q, qd=qd))
    held = contact.held_ground(model, env.terrain, sim.body_pos, sim.body_quat)
    zero = torch.zeros_like(tgt)
    ctl = (tgt, zero, zero)
    extras = {"ground_h": held.height, "ground_n": held.normal, "geom_fric": model.geom_friction}
    probe = torch.empty((n, substeps, 2, model.ng), device=dev)
    out = fused.fused_substep(tables, q, qd, *ctl, slip, h, substeps, probe=probe, **extras)
    with PlainProbe() as rec:
        ref = fused.fused_substep_plain(tables, q, qd, *ctl, slip, h, substeps, **extras)
    torch.cuda.synchronize()
    w = decision_flips(probe.cpu(), rec.probe(0, substeps))
    flipped = w["flipped"].to(dev)
    n_flip, unexplained = int(w["flipped"].sum()), int((w["flipped"] & ~w["explained"]).sum())
    print(f"B1 terrain decision witness: {n_flip} envs where a geom's activation ({int(w['activation'].sum())} envs) "
          f"or Coulomb clamp ({int(w['clamp'].sum())} envs) differs from the plain version's at a substep, "
          f"{unexplained} of them without a geom within {THRESHOLD_EPS} m or {CLAMP_EPS} N of its threshold at the "
          f"first")
    if unexplained:
        raise AssertionError("B1 terrain: contact decisions differ without a geom at its threshold")
    if n_flip > MAX_THRESHOLD_SHARE * n:
        raise AssertionError(f"B1 terrain: {n_flip} envs have decisions that differ; more than {MAX_THRESHOLD_SHARE}")
    max_err = _compare("fused_substep (B1, terrain + friction)", out, ref, TOLS, flipped)
    active = contact.ground_active(model, held, engine._geom_world(model, kinematics.fk(model, q, qd))[4])
    tilt = torch.rad2deg(torch.acos(held.normal[..., 2].clamp(-1.0, 1.0)))
    tilted = int((active & (tilt > TILT_DEG)).sum())
    contact_envs = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"B1 terrain + friction vs plain at {n} envs, {substeps} substeps, the same held inputs: max abs err "
          f"{max_err} over the {n - n_flip} envs whose decisions agree; envs in ground contact {contact_envs} at the "
          f"last substep, {int(active.any(-1).sum())} at the start; active geoms at the start {int(active.sum())}, "
          f"{tilted} of them ({tilted / max(int(active.sum()), 1):.3f}) on a normal tilted more than {TILT_DEG} deg")
    if contact_envs < n // 4:
        raise AssertionError(f"only {contact_envs} envs have ground contact; the terrain path is not exercised")
    if tilted < int(active.sum()) // 10:
        raise AssertionError(f"only {tilted} active geoms stand on a tilted normal; slopes are not exercised")

    args = (tables, q, qd, *ctl, slip, h, substeps)
    ms = cuda_ms(lambda: fused.fused_substep(*args, **extras))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(*args, **extras), warmup=1, runs=5)
    b = bound(fused_substep_bytes(model, n, terrain=True, fric=True),
              fused_substep_flops(model, n, substeps, terrain=True))
    print(f"fused_substep (terrain + friction): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} "
          f"bytes -> {b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "decision_flip_envs": n_flip, "contact_envs": contact_envs, "tilted_active_geoms": tilted, **b}


def sensor_kernel_vs_plain(label: str, fused, model, q, qd, tgt, eff, slip, h: float, substeps: int) -> dict:
    """B1 with its force-sensor output against `fused_substep_plain` on the
    same inputs (flat ground), at the tolerances of tests/test_fused.py with
    the sensor wrenches'; envs excused only where B1's probe and the plain
    probe show a contact decision taken the other way within rounding of
    its threshold (the decision witness of the terrain phase)."""
    n, dev = q.shape[0], q.device
    tables = fused.tables_for(model, dev)
    zero = torch.zeros_like(tgt)
    args = (q, qd, tgt, zero, eff, slip, h, substeps)
    probe = torch.empty((n, substeps, 2, model.ng), device=dev)
    out = fused.fused_substep(tables, *args, probe=probe)
    with PlainProbe() as rec:
        ref = fused.fused_substep_plain(tables, *args)
    torch.cuda.synchronize()
    if out[6] is None or tuple(out[6].shape) != (n, len(model.sensor_body), 6):
        raise AssertionError(f"{label}: B1 returned no sensor wrenches of shape (N, ns, 6)")
    w = decision_flips(probe.cpu(), rec.probe(0, substeps))
    n_flip, unexplained = int(w["flipped"].sum()), int((w["flipped"] & ~w["explained"]).sum())
    if unexplained:
        raise AssertionError(f"{label}: contact decisions differ without a geom at its threshold in {unexplained} envs")
    if n_flip > MAX_THRESHOLD_SHARE * n:
        raise AssertionError(f"{label}: {n_flip} envs have decisions that differ; more than {MAX_THRESHOLD_SHARE}")
    max_err = _compare(label, out, ref, SENSOR_TOLS, w["flipped"].to(dev))
    contact_envs = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"{label} vs plain at {n} envs, {substeps} substeps, sensors on bodies {model.sensor_body}: max abs err "
          f"{max_err} over the {n - n_flip} envs whose contact decisions agree ({n_flip} flips, each within "
          f"rounding of its threshold); envs in ground contact at the last substep {contact_envs}; max |wrench| "
          f"{float(ref[6].abs().max()):.4g}")
    if contact_envs < n // 4:
        raise AssertionError(f"{label}: only {contact_envs} envs have ground contact; the feet are not loaded")

    ms = cuda_ms(lambda: fused.fused_substep(tables, *args))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(tables, *args), warmup=1, runs=5)
    b = bound(fused_substep_bytes(model, n), fused_substep_flops(model, n, substeps))
    print(f"fused_substep ({label}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} bytes -> "
          f"{b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "decision_flip_envs": n_flip, "contact_envs": contact_envs, **b}


@torch.no_grad()
def settled_ant_state(env, steps: int = 25, seed: int = 0):
    """q, qd, slip of `env` (Ant) after `steps` env steps from its reset
    with actions ~ U(-1, 1): the robots have dropped onto their feet."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.initial_state(seed=seed)
    for _ in range(steps):
        actions = torch.rand((env.num_envs, env.num_actions), generator=gen, device=env.device) * 2 - 1
        state, *_ = env.step(state, actions)
    return state.sim.q, state.sim.qd, state.sim.slip_g


def phase_sensor_kernel_vs_plain(env, fused) -> dict:
    """B1's sensor mode on Ant at the slice's width: the four feet's wrenches
    (revolute joints), from a settled state with random efforts."""
    model, n = env.model, env.num_envs
    q, qd, slip = settled_ant_state(env)
    gen = torch.Generator(device=env.device).manual_seed(1)
    eff = (torch.rand((n, model.nd), generator=gen, device=env.device) * 2 - 1) * env.joint_gears * env.power_scale
    return sensor_kernel_vs_plain("B1 sensors (Ant)", fused, model, q, qd, torch.zeros_like(eff), eff, slip,
                                  env.dt / env.substeps, env.substeps)


def quad_sensor_model(device):
    """tests/test_fused.py's scene: a free trunk, two revolute hips with
    fixed feet, a prismatic slider; sensors on a hip (revolute) and on a
    foot (fixed joint), through the port's builder."""
    from isaacgymenv_tpu_torch.physics.builder import ModelBuilder
    from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses
    from isaacgymenv_tpu_torch.physics.types import DRIVE_EFFORT, DRIVE_POS, JT_FIXED, JT_FREE, JT_PRISMATIC, \
        JT_REVOLUTE

    mb = ModelBuilder()
    trunk = mb.add_body("trunk", -1, JT_FREE, mass=5.0, inertia=np.diag([0.05, 0.07, 0.09]), com=(0.01, 0.0, -0.02))
    mb.add_geom_sphere(trunk, (0.0, 0.0, -0.05), 0.06, friction=0.9)
    for side, y in (("l", 0.15), ("r", -0.15)):
        hip = mb.add_body(f"hip_{side}", trunk, JT_REVOLUTE, joint_pos=(0.1, y, 0.0), joint_axis=(0, 1, 0), mass=0.8,
                          com=(0, 0, -0.12), inertia=np.diag([0.004, 0.004, 0.001]), drive_mode=DRIVE_POS,
                          stiffness=60.0, damping=2.0, lower=-1.2, upper=1.2, has_limit=True, effort=40.0,
                          armature=0.01, friction=0.05, maxvel=20.0)
        foot = mb.add_body(f"foot_{side}", hip, JT_FIXED, joint_pos=(0.0, 0.0, -0.25), mass=0.1,
                           inertia=np.diag([1e-4] * 3))
        mb.add_geom_sphere(foot, (0.0, 0.0, 0.0), 0.03, friction=1.1)
    slider = mb.add_body("slider", trunk, JT_PRISMATIC, joint_pos=(-0.1, 0.0, 0.05), joint_axis=(1, 0, 0),
                         mass=0.3, com=(0.02, 0, 0), inertia=np.diag([2e-4, 3e-4, 3e-4]), drive_mode=DRIVE_EFFORT,
                         lower=-0.2, upper=0.2, has_limit=True, effort=15.0, armature=0.002, friction=0.02,
                         maxvel=5.0)
    mb.add_geom_sphere(slider, (0.05, 0.0, 0.0), 0.02, friction=0.8)
    mb.add_force_sensor(1)  # hip_l, revolute
    mb.add_force_sensor(2)  # foot_l, fixed
    mb.gravity = np.array([0.0, 0.0, -9.81])
    return attach_effective_masses(mb.finalize()).to(device)


def phase_fixed_sensor_kernel_vs_plain(dev, fused, n: int = N_ENVS) -> dict:
    """B1's sensor mode on the fixed-joint sensor scene, feet near the ground."""
    model = quad_sensor_model(dev)
    rng = np.random.default_rng(2)
    q = np.zeros((n, model.nq), np.float32)
    q[:, 2] = 0.25 + 0.03 * rng.random(n)
    quat = rng.normal(size=(n, 4)) * 0.1 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = 0.3 * rng.normal(size=(n, model.nq - 7))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return sensor_kernel_vs_plain(
        "B1 sensors (fixed-joint scene)", fused, model, f(q), f(0.5 * rng.normal(size=(n, model.nv))),
        f(0.4 * rng.normal(size=(n, model.nd))), f(5.0 * rng.normal(size=(n, model.nd))),
        torch.zeros((n, model.ng, 3), device=dev), 0.02 / 4, 4)


def launch_counts() -> dict:
    from isaacgymenv_tpu_torch.physics import fused, fused_split

    return {"fused_substep": fused.fused_substep.launches,
            "split_contacts": fused_split.launch_contacts.launches,
            "split_dynamics": fused_split.launch_dynamics.launches}


def zero_launch_counts() -> None:
    from isaacgymenv_tpu_torch.physics import fused, fused_split

    fused.fused_substep.launches = 0
    fused_split.launch_contacts.launches = fused_split.launch_dynamics.launches = 0


@torch.no_grad()
def phase_slice(task: str, n_envs: int, expected: dict, card: str, overrides=None) -> dict:
    """`make(task, **overrides)` on the card and N_STEPS acting steps; the
    kernels' launch counts in that run must be `expected` (per acting step)."""
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.networks import ActorCritic
    from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    env = isaacgymenv_tpu_torch.make(task, num_envs=n_envs, **(overrides or {}))
    if env.device.type != "cuda":
        raise AssertionError(f"make() chose {env.device}, not the card")
    torch.manual_seed(0)
    policy = ActorCritic.from_train_config(load_train_config(task), env.num_obs, env.num_actions).to(env.device)
    stats = RunningStats.create((env.num_obs,), device=env.device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    state = env.initial_state(seed=0)
    state, obs_dict, _, _, _ = env.step(state, torch.zeros((n_envs, env.num_actions), device=env.device))
    obs = obs_dict["obs"]
    torch.cuda.synchronize()

    zero_launch_counts()
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        stats = stats.update(obs)
        mu, log_std, value = policy(stats.normalize(obs))
        actions = mu + torch.exp(log_std) * torch.randn(mu.shape, generator=gen, device=env.device)
        state, obs_dict, rew, done, extras = env.step(state, actions)
        obs = obs_dict["obs"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()

    want = {k: v * N_STEPS * env.control_freq_inv for k, v in expected.items()}
    if launches != want:
        raise AssertionError(f"{task}: kernel launches {launches} in {N_STEPS} acting steps, expected {want}")
    if tuple(obs.shape) != (n_envs, env.num_obs):
        raise AssertionError(f"{task}: obs shape {tuple(obs.shape)}")
    checked = [("obs", obs), ("rew", rew), ("mu", mu), ("value", value),
               ("q", state.sim.q), ("qd", state.sim.qd), ("contact_force", state.sim.contact_force)]
    if env.num_states:
        if tuple(obs_dict["states"].shape) != (n_envs, env.num_states):
            raise AssertionError(f"{task}: states shape {tuple(obs_dict['states'].shape)}")
        checked.append(("states", obs_dict["states"]))
    for label, t in checked:
        if not torch.isfinite(t).all():
            raise AssertionError(f"{task}: non-finite {label} after {N_STEPS} acting steps")
    forces = ""
    if "rb_force" in state.ts:  # ShadowHand's random object forces
        forces = f"; envs with an object force {int((state.ts['rb_force'] != 0).any(-1).sum())}"
    print(f"slice {task}: {N_STEPS} acting steps at {n_envs} envs in {seconds:.3f} s = "
          f"{N_STEPS * n_envs / seconds:.0f} env-steps/s (information only; {card}); "
          f"kernel launches {launches}; done this step {int(done.sum())}; mean reward {float(rew.mean()):.5f}{forces}")
    return launches


@torch.no_grad()
def phase_slice_vs_plain(task: str, tols: dict, n: int = 128, steps: int = 2, seed_state=None,
                         witness: bool = False) -> None:
    """The env step on the card (kernels) against the CPU (plain), same inputs.
    `seed_state(env, n)` -> (q, qd) replaces the initial q and qd when given.
    `tols` names the outputs held: obs, rew, done, q, contact_force, states
    or an entry of the task state.  With `witness` (a split scene), every
    `engine.step` call is recorded and `split_step_witness` excuses the envs
    whose live contact counts differ between the card and the CPU at some
    substep's start with a pair at its threshold, at most
    MAX_THRESHOLD_SHARE of them."""
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.physics import engine

    envs = {d: isaacgymenv_tpu_torch.make(task, num_envs=n, device=d) for d in ("cuda", "cpu")}
    cpu = envs["cpu"]
    gen = torch.Generator().manual_seed(3)
    reset_draws = [cpu.sample_reset_draws(gen, n) for _ in range(steps + 1)]
    step_draws = [cpu.sample_step_draws(gen, n) for _ in range(steps)]
    actions = [torch.rand((n, cpu.num_actions), generator=gen) * 2 - 1 for _ in range(steps)]
    seeded = seed_state(cpu, n) if seed_state else None
    to = lambda draws, dev: {k: v.to(dev) for k, v in draws.items()}  # noqa: E731
    outs, records, step = {}, {}, engine.step
    for d, env in envs.items():
        state = env.initial_state(reset_draws=to(reset_draws[0], env.device))
        if seeded is not None:
            sim = dataclasses.replace(state.sim, q=seeded[0].to(env.device), qd=seeded[1].to(env.device))
            state = dataclasses.replace(state, sim=sim)
        calls = records[d] = []

        def recording(model, terrain, sim, ctrl, dt, substeps=2, calls=calls):
            calls.append((sim, ctrl, dt, substeps))
            return step(model, terrain, sim, ctrl, dt, substeps)

        engine.step = recording if witness else step
        try:
            for i in range(steps):
                state, obs, rew, done, _ = env.step(
                    state, actions[i].to(env.device), reset_draws=to(reset_draws[i + 1], env.device),
                    step_draws=to(step_draws[i], env.device),
                )
        finally:
            engine.step = step
        outs[d] = {"obs": obs["obs"].cpu(), "rew": rew.cpu(), "done": done.cpu(), "q": state.sim.q.cpu(),
                   "contact_force": state.sim.contact_force.cpu()}
        if "states" in obs:
            outs[d]["states"] = obs["states"].cpu()
        # the task-state entries held (the object force, the dof targets, the thrusts)
        outs[d].update({k: state.ts[k].cpu() for k in tols if k in state.ts})
    contact = int((outs["cpu"]["contact_force"].abs().sum(-1) > 0).any(-1).sum())
    if "rb_force" in tols:
        forced = int((outs["cpu"]["rb_force"] != 0).any(-1).sum())
        print(f"{task} env.step cuda vs cpu: {forced} of {n} envs carry an object force after {steps} steps")
        if forced == 0:
            raise AssertionError(f"{task}: no object force fired; the wrench path is not exercised")
    keep = torch.ones(n, dtype=torch.bool)
    if witness:
        flips = split_step_witness(envs, records)
        keep = ~flips
        print(f"{task} env.step cuda vs cpu: count witness over {len(records['cpu'])} physics steps, {int(flips.sum())} "
              f"of {n} envs whose live contact counts differ at a substep's start (each with a pair within "
              f"{THRESHOLD_EPS} m of its threshold), left out of the comparison")
        if int(flips.sum()) > MAX_THRESHOLD_SHARE * n:
            raise AssertionError(f"{task}: {int(flips.sum())} envs with counts that differ; more than "
                                 f"{MAX_THRESHOLD_SHARE} of them")
    for label, (rtol, atol) in tols.items():
        a, b = outs["cuda"][label].float()[keep], outs["cpu"][label].float()[keep]
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{task}: env.step on the card disagrees with the CPU plain path: "
                                 f"{label} max abs err {err}")
        print(f"{task} env.step cuda vs cpu at {n} envs, {steps} steps: {label} max abs err {err}")
    print(f"{task} env.step cuda vs cpu: {contact} of {n} envs in contact at the last substep")


# The share of envs that the witness may excuse in each of the three env
# step checks, a few envs above the readings on an H100 (2, 7 and 23 of
# 128): the env's own start, run through the feet's touchdown, at 5%; the
# hard terrain standing still and moving, where feet cross cell edges
# within a control step, at 8% and 22%.
MAX_CELL_SHARE = {"spawned": 0.05, "standing": 0.08, "moving": 0.22}
# the pose spread and velocities of the standing state, as a share of those
# of the B1 check's state (terrain_standing_state's `motion`)
STANDING = 0.1


def _lookup_differs(a, b) -> torch.Tensor:
    """(N,) bool: envs where two ground samples (height (N, k), normal
    (N, k, 3) or None) differ: another cell was read.  The same cell gives the
    same height bit for bit; the normals of one cell agree to rounding."""
    h_a, n_a = a
    h_b, n_b = b
    differs = (h_a != h_b).any(-1)
    if n_a is not None:
        differs |= ((n_a - n_b).abs() > 1e-5).any(-1).any(-1)
    return differs


@torch.no_grad()
def phase_terrain_slice_vs_plain(tols: dict, motion, actions_scale: float, max_share: float, steps: int,
                                 n: int = 128) -> dict:
    """AnymalTerrain's env step on the card (B1 with the ground held per
    control step) against the CPU (the plain loop, the ground looked up every
    substep), same inputs, actions ~ U(-1, 1) x `actions_scale`.  The envs
    start from the env's own initial state (`motion` None: spawned above
    their platform at the initial levels) or from `terrain_standing_state(...,
    motion)` (every level and type of the grid, off the spawn platforms, feet
    in contact on slopes, stairs, obstacles and stones).  Excused only: an env
    in which, at a control step before which it agreed, a geom's ground
    lookup (its cell) differs between the two runs or changes inside the step
    on the CPU, a height-scan point reads another cell in the two runs, or a
    contact decision differs with its margin within rounding (the decision
    witness of B1's probe and the plain probe); at most `max_share` of the
    envs."""
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.physics import contact, engine, fused, kinematics

    envs = {d: isaacgymenv_tpu_torch.make("AnymalTerrain", num_envs=n, device=d, **TERRAIN_OVERRIDES)
            for d in ("cuda", "cpu")}
    cpu = envs["cpu"]
    gen = torch.Generator().manual_seed(3)
    seeded = motion is not None
    if seeded:
        q0, qd0, _, _, levels, kinds = terrain_standing_state(cpu, n, seed=2, motion=motion)
        initial = {"terrain_levels": levels, "terrain_types": kinds}
    else:
        initial = cpu.sample_initial_draws(gen, n)
    reset_draws = [cpu.sample_reset_draws(gen, n) for _ in range(steps + 1)]
    step_draws = [cpu.sample_step_draws(gen, n) for _ in range(steps)]
    actions = [(torch.rand((n, cpu.num_actions), generator=gen) * 2 - 1) * actions_scale for _ in range(steps)]
    to = lambda draws, dev: {k: v.to(dev) for k, v in draws.items()}  # noqa: E731
    step_fn, substep_fn, fused_fn = engine.step, engine._substep, fused.fused_substep
    outs, rec, plain_probe = {}, {}, PlainProbe()
    for d, env in envs.items():
        r = rec[d] = {"held": [], "substeps": [], "scan": [], "probe": []}

        def step_rec(model, terrain, state, ctrl, dt, substeps=2, r=r):
            held = contact.held_ground(model, terrain, state.body_pos, state.body_quat)
            r["held"].append((held.height.cpu(), held.normal.cpu()))
            return step_fn(model, terrain, state, ctrl, dt, substeps)

        def substep_rec(model, terrain, q, qd, *args, r=r):
            if isinstance(terrain, contact.Heightfield):  # the per-substep lookup of the plain loop
                gpos = engine._geom_world(model, kinematics.fk(model, q, qd))[4]
                x, y = gpos[..., 0], gpos[..., 1]
                r["substeps"].append((contact.height_at(terrain, x, y), contact.terrain_normal(terrain, x, y)))
            return substep_fn(model, terrain, q, qd, *args)

        def scan_rec(rs, r=r, scan_fn=env._measured_heights):
            heights = scan_fn(rs)
            r["scan"].append(heights.cpu())
            return heights

        def fused_rec(tables, q, *args, r=r, **kwargs):  # B1's probe on the card
            probe = torch.empty((q.shape[0], args[6], 2, tables.model.ng), device=q.device)
            out = fused_fn(tables, q, *args, probe=probe, **kwargs)
            r["probe"].append(probe.cpu())
            return out

        fused_rec.launches = 0  # fused_substep counts its launches on the name it is bound to in its module
        env._measured_heights = scan_rec
        engine.step, engine._substep, fused.fused_substep = step_rec, substep_rec, fused_rec
        try:
            with plain_probe if d == "cpu" else contextlib.nullcontext():
                state = env.initial_state(reset_draws=to(reset_draws[0], env.device),
                                          initial_draws=to(initial, env.device))
                if seeded:
                    sim = dataclasses.replace(state.sim, q=q0.to(env.device), qd=qd0.to(env.device))
                    state = dataclasses.replace(state, sim=engine.forward(env.model, env.terrain, sim))
                for i in range(steps):
                    r.setdefault("states", []).append((state.sim.q.cpu(), state.sim.qd.cpu()))
                    state, obs, rew, done, _ = env.step(
                        state, actions[i].to(env.device), reset_draws=to(reset_draws[i + 1], env.device),
                        step_draws=to(step_draws[i], env.device))
                    r.setdefault("obs", []).append(obs["obs"].cpu())
        finally:
            engine.step, engine._substep, fused.fused_substep = step_fn, substep_fn, fused_fn
        outs[d] = {"obs": obs["obs"].cpu(), "rew": rew.cpu(), "done": done.cpu(), "q": state.sim.q.cpu(),
                   "contact_force": state.sim.contact_force.cpu()}

    # the witness, step by step: an env is excused by the first event that
    # takes it apart from the other run, and an unexplained decision flip
    # before any such event is a fault whatever the env's error at the end
    if len(rec["cuda"]["probe"]) != steps or len(plain_probe.rows) != steps * cpu.substeps:
        raise AssertionError("AnymalTerrain env.step: B1 or the plain loop did not run once per control step")
    events = {k: torch.zeros(n, dtype=torch.bool) for k in
              ("geom_cell_differs_across_runs", "geom_cell_changes_in_step", "scan_cell_differs_across_runs",
               "decision_flip_explained", "decision_flip_unexplained", "activation_flip", "clamp_flip")}
    excused = torch.zeros(n, dtype=torch.bool)
    for k in range(steps):
        held_cpu = rec["cpu"]["held"][k]
        across = _lookup_differs(rec["cuda"]["held"][k], held_cpu)
        inside = torch.zeros(n, dtype=torch.bool)
        for sub in rec["cpu"]["substeps"][k * cpu.substeps:(k + 1) * cpu.substeps]:
            inside |= _lookup_differs(sub, held_cpu)
        scan = _lookup_differs((rec["cuda"]["scan"][k], None), (rec["cpu"]["scan"][k], None))
        w = decision_flips(rec["cuda"]["probe"][k], plain_probe.probe(k * cpu.substeps, cpu.substeps))
        lookup = across | inside | scan
        for key, hit in (("geom_cell_differs_across_runs", across), ("geom_cell_changes_in_step", inside),
                         ("scan_cell_differs_across_runs", scan), ("activation_flip", w["activation"]),
                         ("clamp_flip", w["clamp"])):
            events[key] |= hit & ~excused
        flip = w["flipped"] & ~lookup & ~excused
        events["decision_flip_explained"] |= flip & w["explained"]
        events["decision_flip_unexplained"] |= flip & ~w["explained"]
        excused |= lookup | flip
    diff = {label: (outs["cuda"][label].float() - outs["cpu"][label].float()).abs().reshape(n, -1) for label in tols}
    bad = torch.zeros(n, dtype=torch.bool)
    for label, (rtol, atol) in tols.items():
        bad |= (diff[label] > atol + rtol * outs["cpu"][label].float().abs().reshape(n, -1)).any(-1)
    errs = {label: float(d.max()) for label, d in diff.items()}
    errs.update({f"{label} (agreeing envs)": float(d[~bad].max()) for label, d in diff.items()})
    unexplained = bad & ~excused
    contact_envs = int((outs["cpu"]["contact_force"].abs().sum(-1) > 0).any(-1).sum())
    counts = {"envs": n, "outside_tolerance": int(bad.sum()), "unexplained": int(unexplained.sum()),
              **{key: int(v.sum()) for key, v in events.items()}, "contact_envs": contact_envs}
    print(f"AnymalTerrain env.step cuda (held ground) vs cpu (per-substep lookup) at {n} envs, {steps} steps, "
          f"{f'seeded, motion {motion}' if seeded else 'spawned'}, actions x {actions_scale}: max abs err {errs}; "
          f"witness {counts}")
    if int(unexplained.sum()) or int(events["decision_flip_unexplained"].sum()):
        _diagnose(cpu.model, rec, torch.nonzero(unexplained | events["decision_flip_unexplained"])[:, 0].tolist(),
                  tols)
        raise AssertionError(f"AnymalTerrain env.step: {int(unexplained.sum())} envs disagree with the CPU plain path "
                             f"without a witness, {int(events['decision_flip_unexplained'].sum())} with a contact "
                             f"decision that differs away from its threshold")
    if int(bad.sum()) > max_share * n:
        raise AssertionError(f"AnymalTerrain env.step: {int(bad.sum())} envs excused, more than {max_share}")
    if contact_envs < n // 4:
        raise AssertionError(f"only {contact_envs} of {n} envs in ground contact")
    return {"max_err": errs, **counts}


def _diagnose(model, rec, envs, tols) -> None:
    """Per step, for each env: max |q| and |qd| difference at the step's
    start, the obs error after it, the dofs within 0.01 rad of a limit and
    the smallest |ground depth| of a geom against the held ground."""
    from isaacgymenv_tpu_torch.physics import engine, kinematics

    for e in envs:
        for k, ((qa, qda), (qb, qdb)) in enumerate(zip(rec["cuda"]["states"], rec["cpu"]["states"])):
            dof = qb[e, list(model.dof_q_adr)]
            near = ((dof - model.dof_lower).abs() < 0.01) | ((dof - model.dof_upper).abs() < 0.01)
            gpos = engine._geom_world(model, kinematics.fk(model, qb[e:e + 1], qdb[e:e + 1]))[4][0]
            depth = rec["cpu"]["held"][k][0][e] + model.geom_radius - gpos[:, 2]
            obs_err = (rec["cuda"]["obs"][k][e] - rec["cpu"]["obs"][k][e]).abs()
            print(f"  env {e} step {k}: q err {float((qa[e] - qb[e]).abs().max()):.3g}, qd err "
                  f"{float((qda[e] - qdb[e]).abs().max()):.3g}, obs err after {float(obs_err.max()):.3g} at "
                  f"{int(obs_err.argmax())}, dofs at a limit {near.nonzero()[:, 0].tolist()}, min |depth| "
                  f"{float(depth.abs().min()):.3g} (geom {int(depth.abs().argmin())}), depths>0 "
                  f"{(depth > 0).nonzero()[:, 0].tolist()}")


def ant_contact_state(env, n: int, seed: int):
    """Ant q, qd (CPU tensors): the torso 0.28-0.33 m up, slightly tilted,
    the legs spread at random, so that most envs have feet on the ground."""
    rng = np.random.default_rng(seed)
    m = env.model
    q = np.zeros((n, m.nq), np.float32)
    q[:, 2] = 0.28 + 0.05 * rng.random(n)
    quat = rng.normal(size=(n, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = 0.3 * rng.normal(size=(n, m.nd))
    qd = 0.3 * rng.normal(size=(n, m.nv))
    return torch.tensor(q), torch.tensor(qd, dtype=torch.float32)


TRAIN_EPOCHS = 10       # Ant
HAND_TRAIN_EPOCHS = 3   # ShadowHandOpenAI_FF
SMALL_TRAIN_EPOCHS = 3  # Quadcopter, BallBalance


def phase_train(card: str, task: str = "Ant", n_envs: int = N_ENVS, epochs: int = TRAIN_EPOCHS,
                per_step=None) -> dict:
    """The training CLI in-process: `task=<task>` at `n_envs` envs for `epochs`
    epochs, then a resume from the checkpoint it wrote for one more.  Every
    logged loss (with a central value, `v_loss` is its loss) and the learning
    rate must be finite, the kernels launched exactly `per_step` times per
    rollout step (horizon_length steps per epoch), and the checkpoint's
    parameters (and central value) equal to the trained state's."""
    import math
    import os

    from isaacgymenv_tpu_torch import train
    from isaacgymenv_tpu_torch.learning import ppo
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    per_step = per_step or {"fused_substep": 1, "split_contacts": 0, "split_dynamics": 0}
    horizon = int(load_train_config(task)["params"]["config"]["horizon_length"])
    run = f"chip_smoke_{task.lower()}"
    run_dir = os.path.join("runs", run)
    metrics_path = os.path.join(run_dir, "summaries", "metrics.csv")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)
    times = {"_rollout": [], "_update": []}
    originals = {k: getattr(ppo.PPO, k) for k in times}

    def timed(name):
        def wrapper(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *a, **k)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    args = [f"task={task}", f"num_envs={n_envs}", f"experiment={run}", "seed=0"]
    for k in times:
        setattr(ppo.PPO, k, timed(k))
    try:
        zero_launch_counts()
        t0 = time.perf_counter()
        ts = train.main(args + [f"max_iterations={epochs}"])
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        with open(metrics_path) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        ckpt = os.path.join(run_dir, "nn", f"{run}.ckpt")
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]
        pairs = [("policy", saved["params"], ts.params)]
        if ts.cv is not None:
            pairs.append(("central value", saved["cv"]["params"], ts.cv.params))
        for what, kept, trained in pairs:
            if not all(torch.equal(kept[k], v.cpu()) for k, v in trained.items()):
                raise AssertionError(f"training {task}: the checkpoint's {what} differ from the trained state's")
        zero_launch_counts()
        resumed = train.main(args + ["max_iterations=1", f"checkpoint={ckpt}"])
        resume_launches = launch_counts()
    finally:
        for k, fn in originals.items():
            setattr(ppo.PPO, k, fn)
    want = {k: v * horizon * epochs for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"training {task}: kernel launches {launches} in {epochs} epochs, expected {want}")
    if resume_launches != {k: v * horizon for k, v in per_step.items()}:
        raise AssertionError(f"training {task}: {resume_launches} launches in the resumed epoch")
    if ts.epoch != epochs or resumed.epoch != epochs + 1:
        raise AssertionError(f"training {task}: epochs {ts.epoch}, then {resumed.epoch} after the resume")
    per_epoch = {}
    for frames, name, value in rows:
        per_epoch.setdefault(int(frames), {})[name] = float(value)
    watched = ("loss", "a_loss", "v_loss", "entropy", "kl", "lr")
    if len(per_epoch) != epochs:
        raise AssertionError(f"training {task}: {len(per_epoch)} epochs logged, expected {epochs}")
    for frames, vals in per_epoch.items():
        bad = [k for k in watched if not math.isfinite(vals.get(k, math.nan))]
        if bad:
            raise AssertionError(f"training {task}: non-finite {bad} at {frames} frames")
    for name, t in {**ts.params, **(ts.cv.params if ts.cv is not None else {})}.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"training {task}: non-finite parameter {name}")
    last = per_epoch[max(per_epoch)]
    steps = horizon * n_envs * epochs
    result = {"task": task, "envs": n_envs, "epochs": epochs, "env_steps": steps, "seconds": seconds,
              "env_steps_per_s": steps / seconds, "rollout_ms": times["_rollout"][:epochs],
              "update_ms": times["_update"][:epochs], "mean_return": last["mean_return"],
              "losses": {k: last[k] for k in watched}, "launches": launches,
              "central_value": ts.cv is not None}
    print(f"training {task} at {n_envs} envs, {epochs} epochs of {horizon * n_envs} env-steps: {seconds:.2f} s, "
          f"{steps / seconds:.0f} env-steps/s; rollout ms per epoch {[round(t, 2) for t in result['rollout_ms']]}, "
          f"update ms {[round(t, 2) for t in result['update_ms']]}; mean return {last['mean_return']:.4f}; last losses "
          f"{result['losses']} (information only; {card}); kernel launches {launches} ({per_step} per step, "
          f"{horizon} steps per epoch); central value {result['central_value']}; resumed from the checkpoint for "
          f"one epoch, {resume_launches}")
    return result


def cube_on_palm_state(env, n: int, seed: int):
    """ShadowHand q, qd, pos_target, slip_p: hand dofs near zero within their
    limits (wrist at zero), the cube 0.5-2 mm into the top face of the palm,
    2 cm off the palm's center toward the little finger (clear of the thumb),
    slightly tilted: pair contacts are active."""
    from isaacgymenv_tpu_torch.physics import kinematics

    rng = np.random.default_rng(seed)
    m = env.model.to("cpu")
    q = np.zeros((n, m.nq), np.float32)
    dq = np.clip(0.15 * rng.normal(size=(n, m.nd)), m.dof_lower.numpy(), m.dof_upper.numpy())
    dq[:, [m.dof_names.index("robot0:WRJ1"), m.dof_names.index("robot0:WRJ0")]] = 0.0
    q[:, list(m.dof_q_adr)] = dq
    kin = kinematics.fk(m, torch.zeros(1, m.nq), torch.zeros(1, m.nv))
    palm = m.body_names.index("robot0:palm")
    s = max((i for i, b in enumerate(m.surf_body) if b == palm), key=lambda i: float(m.surf_size[i].prod()))
    R, p = kin.R_w[palm][0].numpy(), kin.p_w[palm][0].numpy()
    off, half = m.surf_offset[s].numpy(), m.surf_size[s].numpy()
    signs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
    top = (p + (off + signs * half) @ R.T)[:, 2].max()
    center = p + R @ off
    qa = m.q_adr[env.object_body]
    q[:, qa] = center[0] + 0.02 + 0.003 * rng.uniform(-1, 1, n)
    q[:, qa + 1] = center[1] + 0.008 * rng.uniform(-1, 1, n)
    q[:, qa + 2] = top + 0.025 - rng.uniform(0.0005, 0.002, n)  # cube half extent 0.025
    quat = rng.normal(size=(n, 4)) * 0.01 + [0.0, 0.0, 0.0, 1.0]
    q[:, qa + 3:qa + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qd = 0.2 * rng.normal(size=(n, m.nv))
    tgt = dq + 0.2 * rng.normal(size=(n, m.nd))
    slip = 1e-4 * rng.normal(size=(n, m.n_pairs, 3))
    return [torch.tensor(a, dtype=torch.float32) for a in (q, qd, tgt, slip)]


def _compare(label: str, outs, refs, tols: dict, skip=None) -> dict:
    """Max abs error per output over the envs not in `skip` (N,) bool; raises
    when one of their elements lies outside its tolerance or is not finite."""
    keep = slice(None) if skip is None else ~skip
    max_err, failures = {}, []
    for (name, tol), a, b in zip(tols.items(), outs, refs):
        if tol is None:
            continue
        rtol, atol = tol
        if not torch.isfinite(a).all():
            failures.append(f"{name}: not finite")
        err = (a[keep] - b[keep]).abs()
        max_err[name] = float(err.max())
        bad = int((err > atol + rtol * b[keep].abs()).sum())
        if bad:
            failures.append(f"{name}: {bad} elements outside rtol={rtol} atol={atol}, max abs err {max_err[name]}")
    if failures:
        raise AssertionError(f"{label} disagrees with its plain version:\n" + "\n".join(failures))
    return max_err


# A pair whose depth lies within this distance of zero (about 16 ulps of the
# 0.5 m world coordinates) may be active in the kernel and inactive in the
# plain version, whose FK rounds differently.  Its activation changes its
# bodies' live contact counts, and with them every budget-capped contact
# force on those bodies (the cube's are capped: m / h^2 < kn), so the two
# legitimately diverge.  The kernel's own counts are the witness: B2 writes
# the live contacts per body of its first pass (`counts=`), and an env is
# held to finiteness only where those differ from the plain version's counts
# at a substep's start.  Such an env must have a pair within THRESHOLD_EPS of
# its threshold (else the kernel is at fault), and such envs must stay few.
THRESHOLD_EPS = 1e-6
MAX_THRESHOLD_SHARE = 0.01


def near_threshold(model, q, qd) -> torch.Tensor:
    """(N,) bool: envs with a pair within THRESHOLD_EPS of its activation."""
    from isaacgymenv_tpu_torch.physics import contact, engine, kinematics

    body_pos, R_w, _, _, geom_pos, _ = engine._geom_world(model, kinematics.fk(model, q, qd))
    return (contact.pair_depth(model, geom_pos, body_pos, R_w).abs() < THRESHOLD_EPS).any(-1)


def counts_plain(model, q, qd) -> torch.Tensor:
    """(N, nb) live contacts per body (at least 1), as the plain version counts them."""
    from isaacgymenv_tpu_torch.physics import contact, engine, kinematics

    body_pos, R_w, _, _, geom_pos, _ = engine._geom_world(model, kinematics.fk(model, q, qd))
    act_g = None if model.no_ground else contact.ground_active(model, None, geom_pos)
    act_p = contact.pair_active(model, geom_pos, body_pos, R_w)
    return contact.body_active_counts(model, act_g, act_p, geom_pos.shape[:-2], device=q.device)


def contacts_kernel(tables, q, qd, slip_g, slip_p, h, body_wrench=None):
    """One launch of B2 alone on env-major inputs (left untouched), in its
    wrench mode when `body_wrench` (N, nb, 6) is given: (f_ext,
    contact_force, contact_torque, slip_g, slip_p, counts), env-major, counts
    (N, nb) being the kernel's own live contacts per body (at least 1)."""
    from isaacgymenv_tpu_torch.physics import fused_split
    from isaacgymenv_tpu_torch.physics.fused import from_minor, to_minor

    model, n, dev = tables.model, q.shape[0], q.device
    ground = model.ng and not model.no_ground
    s_gT = to_minor(slip_g, n) if ground else None
    s_pT = to_minor(slip_p, n) if model.n_pairs else None
    empty = lambda k: torch.empty((k, n), device=dev)  # noqa: E731
    fext, cf, ct, counts = empty(6 * model.nb), empty(3 * model.nb), empty(3 * model.nb), empty(model.nb)
    bwT = None if body_wrench is None else to_minor(body_wrench, n)
    fused_split.launch_contacts(tables, to_minor(q, n), to_minor(qd, n), s_gT, s_pT, fext, cf, ct, h, counts, bwT)
    return (from_minor(fext, n, model.nb, 6), from_minor(cf, n, model.nb, 3), from_minor(ct, n, model.nb, 3),
            from_minor(s_gT, n, model.ng, 3) if ground else slip_g,
            from_minor(s_pT, n, model.n_pairs, 3) if model.n_pairs else slip_p,
            from_minor(counts, n, model.nb).clamp(min=1.0))


def count_flips(tables, kernel_state, plain_state, h) -> torch.Tensor:
    """(N,) bool: envs where B2's live counts at `kernel_state` (q, qd, slip_g,
    slip_p) differ from the plain version's at `plain_state` (q, qd)."""
    k = contacts_kernel(tables, *kernel_state, h)[-1]
    return (k != counts_plain(tables.model, *plain_state)).any(-1)


def _check_flips(label: str, flips: torch.Tensor, at_threshold: torch.Tensor) -> None:
    unexplained = int((flips & ~at_threshold).sum())
    if unexplained:
        raise AssertionError(f"{label}: {unexplained} envs where B2's live contact counts differ from the plain "
                             f"version's without a pair within {THRESHOLD_EPS} m of its threshold")


def task_wrench(env, q, seed: int):
    """(N, nb, 6) world [moment, force] body wrenches in every env: on the
    cube the force of ShadowHandOpenAI_FF's random forces (N(0, 1) x mass x
    forceScale in the cube's frame, rotated by its pose into the world) and a
    N(0, 2e-3) N m moment; N(0, 1e-2) N and N(0, 1e-3) N m on the hand's
    moving bodies; 3 N and 1 N m of random sign on the two fixed bodies at
    the root, welded to the world, where they move nothing and where a
    wrench that leaked into the contact torque would show at 20x the
    tolerance.  `check_wrench_mode` holds each of the 162 entries."""
    from isaacgymenv_tpu_torch.ops import maths
    from isaacgymenv_tpu_torch.physics import engine, types

    n, model, dev = q.shape[0], env.model, q.device
    if not (model.body_names[0] == "robot0:hand mount" and model.jtype[0] == model.jtype[1] == types.JT_FIXED):
        raise AssertionError("ShadowHand's first two bodies are not the fixed root")
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = lambda m, f: torch.tensor([m] * 3 + [f] * 3, device=dev)  # noqa: E731
    w = torch.randn((n, model.nb, 6), generator=gen, device=dev) * scale(1e-3, 1e-2)
    sign = torch.randint(0, 2, (n, 2, 6), generator=gen, device=dev) * 2.0 - 1.0
    w[:, :2] = sign * scale(1.0, 3.0)
    state = dataclasses.replace(types.make_zero_state(model, n), q=q, qd=torch.zeros((n, model.nv), device=dev))
    quat = engine.forward(model, None, state).body_quat[:, env.object_body]
    force = torch.randn((n, 3), generator=gen, device=dev) * env.object_mass * env.force_scale
    w[:, env.object_body, :3] = torch.randn((n, 3), generator=gen, device=dev) * 2e-3
    w[:, env.object_body, 3:] = maths.quat_rotate(quat, force)
    return w


# f_ext - [contact torque, contact force] against the body wrench: one fp32
# add and one subtract, each within an ulp of |contacts| + |wrench|
WRENCH_RTOL = 1e-6


def check_wrench_mode(label: str, out, bw) -> float:
    """B2's wrench mode held to its contract on its own outputs `out`
    (f_ext, contact force, contact torque, ...) for the body wrenches `bw`:
    in every env and each of the nb x 6 entries, f_ext is the contacts'
    wrench [contact torque, contact force] plus `bw`, to WRENCH_RTOL of
    their size; the welded root bodies have no contact, so their contact
    force and torque are exactly 0 whatever their wrench.  A wrench added to
    the contact torque, or an entry dropped or misplaced, fails.  Returns the
    largest error relative to the entry's size."""
    f_ext, cf, ct = out[:3]
    contacts = torch.cat([ct, cf], -1)
    err = (f_ext - contacts - bw).abs()
    size = contacts.abs() + bw.abs()
    bad = int((err > WRENCH_RTOL * size).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} wrench entries where f_ext != contacts + body wrench within "
                             f"{WRENCH_RTOL} of their size (max abs err {float(err.max()):.4g})")
    if float(contacts[:, :2].abs().max()) != 0.0:
        raise AssertionError(f"{label}: a contact force or torque on the welded root bodies, which carry "
                             f"{float(bw[:, :2].abs().max()):.4g} of body wrench and have no contact")
    return float((err / size.clamp(min=1e-30)).max())


def phase_split_vs_plain(env, wrench: bool = False, state=cube_on_palm_state, sensor_tol=None,
                         contacts_alone: bool = True, name: str = "") -> dict:
    """B2 + B3 against `split_substep_plain` at the slice's width from
    `state(env, n, seed)` -> (q, qd, pos_target, slip_p[, effort]), and each kernel
    alone against its own plain version; timings and bounds.  With `wrench`,
    every call carries the task-like body wrenches of `task_wrench` (B2's
    wrench mode) and B3 alone is not repeated.  A model with force sensors
    has its sensor wrenches (B3's sensor output) held at `sensor_tol`;
    without `contacts_alone`, B2 alone is not repeated.  `name` goes into
    the labels."""
    from isaacgymenv_tpu_torch.physics import contact, engine, fused_split, kinematics
    from isaacgymenv_tpu_torch.physics.fused import from_minor, to_minor

    dev, model = env.device, env.model
    n, h = env.num_envs, env.dt / env.substeps
    tables = fused_split.tables_for(model, dev)
    q, qd, tgt, slip_p, *eff = (t.to(dev) for t in state(env, n, seed=1))
    bw = task_wrench(env, q, seed=5) if wrench else None
    b2 = "B2 (wrench mode)" if wrench else "B2"
    label = f"{b2} + B3{name}"
    ns = len(model.sensor_body)
    tols = {**SPLIT_TOLS, "joint_wrench": sensor_tol if ns else None}
    zero = torch.zeros_like(tgt)
    slip_g = torch.zeros((n, model.ng, 3), device=dev)
    ctl = (tgt, zero, eff[0] if eff else zero)
    args = (q, qd, *ctl, slip_g, slip_p, h, env.substeps)
    if wrench:
        carrying = int((bw != 0).any(-1).any(-1).sum())
        print(f"{label}: {carrying} of {n} envs carry a nonzero body wrench, max |force| on the cube "
              f"{float(bw[:, env.object_body, 3:].norm(dim=-1).max()):.4g} N")
        if carrying == 0:
            raise AssertionError("no env carries a body wrench; the wrench mode is not exercised")

    kin = kinematics.fk(model, q, qd)
    body_pos, R_w, _, _, geom_pos, _ = engine._geom_world(model, kin)
    active = int(contact.pair_active(model, geom_pos, body_pos, R_w).any(-1).sum())
    out = fused_split.split_substep(tables, *args, body_wrench=bw)
    # both one substep at a time (the same arithmetic as `substeps` in one
    # call), to read each one's state at every substep's start
    k_states, p_states = [(q, qd, slip_g, slip_p)], [(q, qd, slip_g, slip_p)]
    for _ in range(env.substeps - 1):
        (kq, kqd, ksg, ksp), (pq, pqd, psg, psp) = k_states[-1], p_states[-1]
        k = fused_split.split_substep(tables, kq, kqd, *ctl, ksg, ksp, h, 1, body_wrench=bw)
        p = fused_split.split_substep_plain(tables, pq, pqd, *ctl, psg, psp, h, 1, body_wrench=bw)
        k_states.append((k[0], k[1], k[5], k[6]))
        p_states.append((p[0], p[1], p[5], p[6]))
    kl, pl = k_states[-1], p_states[-1]
    ref = fused_split.split_substep_plain(tables, pl[0], pl[1], *ctl, pl[2], pl[3], h, 1, body_wrench=bw)
    # the plain last substep from the kernel's own state
    ref_k = fused_split.split_substep_plain(tables, kl[0], kl[1], *ctl, kl[2], kl[3], h, 1, body_wrench=bw)
    if not all(torch.equal(a, b) for a, b in zip(out[:2], fused_split.split_substep(
            tables, kl[0], kl[1], *ctl, kl[2], kl[3], h, 1, body_wrench=bw)[:2])):
        raise AssertionError("split_substep: its substeps differ from chained single substeps")
    if wrench:  # the wrench moves the cube: the kernel pair without it ends elsewhere
        qa = model.q_adr[env.object_body]
        moved = float((out[0] - fused_split.split_substep(tables, *args)[0])[:, qa:qa + 3].abs().max())
        print(f"{label}: the wrench moves the cube by up to {moved:.4g} m in one control step")
        if moved < 1e-5:
            raise AssertionError("the body wrench does not move the cube")

    # the witness: B2's own live counts at each substep's start
    flips = [count_flips(tables, ks, ps[:2], h) for ks, ps in zip(k_states, p_states)]
    flip_k = count_flips(tables, kl, kl[:2], h)
    at_k = [near_threshold(model, *ks[:2]) for ks in k_states]
    at_p = [near_threshold(model, *ps[:2]) for ps in p_states]
    skip = torch.zeros(n, dtype=torch.bool, device=dev)
    witness = {}
    for i, flip in enumerate(flips):
        witness[f"flip_substep{i + 1}"] = int((flip & ~skip).sum())
        _check_flips(f"substep {i + 1}", flip & ~skip, at_k[i] | at_p[i])
        skip |= flip
    n_skip = int(skip.sum())
    witness.update({"flip_from_kernel_state": int(flip_k.sum()), "pair_at_threshold_substep1": int(at_k[0].sum()),
                    "pair_at_threshold_kernel_state": int(at_k[-1].sum())})
    print(f"count witness (envs): {witness}")
    # envs outside the tolerances, whatever the witness says
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for (key, tol), a, b in zip(tols.items(), out, ref):
        if tol is not None:
            bad |= ((a - b).abs() > tol[1] + tol[0] * b.abs()).reshape(n, -1).any(-1)
    at_any = torch.stack(at_k + at_p).any(0)
    print(f"envs outside the tolerances over all envs: {int(bad.sum())}, of them with a count flip "
          f"{int((bad & skip).sum())}, with a pair at its threshold {int((bad & at_any).sum())}")
    _check_flips("the last substep from the kernel's state", flip_k, at_k[-1])
    all_err = {key: float((a - b).abs().max()) for key, a, b in zip(tols, out, ref) if tols[key] is not None}
    pair_err = _compare(f"split_substep ({label})", out, ref, tols, skip)
    last_err = _compare(f"split_substep ({label}), the last substep from the kernel's state", out, ref_k,
                        tols, flip_k)
    if ns:
        print(f"{label}: sensor wrenches on bodies {model.sensor_body} (tolerance {sensor_tol}), max |wrench| "
              f"{float(ref[7].abs().max()):.4g}")
    last = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"{label} vs plain at {n} envs, {env.substeps} substeps: max abs err {pair_err} over the {n - n_skip} envs "
          f"whose live contact counts agree with B2's at every substep's start ({n_skip} whose do not: max abs err "
          f"over all envs {all_err}); envs with an active pair contact: {active} at the start, {last} at the "
          f"last substep")
    print(f"count witness: every env whose counts differ has a pair within {THRESHOLD_EPS} m of its threshold")
    print(f"last substep from the kernel's own state vs plain: max abs err {last_err} over the "
          f"{n - int(flip_k.sum())} envs whose counts agree there")
    if last < n // 4:
        raise AssertionError(f"only {last} envs have a pair contact; the pair path is not exercised")
    if n_skip > MAX_THRESHOLD_SHARE * n:
        raise AssertionError(f"{n_skip} envs have counts that differ; more than {MAX_THRESHOLD_SHARE} of them")

    # each kernel alone: B2 at the start and at the kernel's own state after
    # one substep, B3 from the plain f_ext
    c_tols = {"f_ext": (2e-3, 5e-2), "contact_force": (2e-3, 5e-2), "contact_torque": (2e-3, 5e-2),
              "slip_g": None, "slip_p": (2e-3, 1e-5)}
    c_ref = fused_split.contacts_plain(tables, q, qd, slip_g, slip_p, h, body_wrench=bw)
    result, kernels = {}, []
    if contacts_alone:
        # the kernel's state after one substep: its counts against the plain counts there
        flip_k1 = flip_k if len(k_states) == 2 else count_flips(tables, k_states[1], k_states[1][:2], h)
        _check_flips("substep 2 from the kernel's state", flip_k1, at_k[1])
        c_err, c_ms, c_plain, cb = contacts_alone_vs_plain(tables, q, qd, slip_g, slip_p, h, bw, c_ref, c_tols,
                                                           flips[0], k_states[1], flip_k1, b2, wrench)
        result["split_contacts"] = {"max_abs_err": max(c_err.values()), "max_err": c_err, "ms": c_ms,
                                    "plain_ms": c_plain, **cb}
        kernels.append(("split_contacts" + (" (wrench mode)" if wrench else "") + name, c_ms, c_plain, cb))
    if not wrench:  # B3 alone, from the plain f_ext (it takes no wrench input)
        f_ext = c_ref[0]
        d_ref = fused_split.dynamics_plain(tables, q, qd, *ctl, f_ext, h)
        qT, qdT = to_minor(q, n), to_minor(qd, n)
        tgtT, zT, effT, fextT = (to_minor(t, n) for t in (tgt, zero, ctl[2], f_ext))
        dof_force = torch.empty((model.nd, n), device=dev)
        jwT = torch.empty((6 * ns, n), device=dev) if ns else None
        q2, qd2 = qT.clone(), qdT.clone()
        fused_split.launch_dynamics(tables, q2, qd2, tgtT, zT, effT, fextT, dof_force, h, jwT)
        d_out = (from_minor(q2, n, model.nq), from_minor(qd2, n, model.nv), from_minor(dof_force, n, model.nd),
                 None if jwT is None else from_minor(jwT, n, ns, 6))
        d_tols = {"q": SPLIT_TOLS["q"], "qd": SPLIT_TOLS["qd"], "dof_force": SPLIT_TOLS["dof_force"],
                  "joint_wrench": tols["joint_wrench"]}
        d_err = _compare(f"split_dynamics (B3{name})", d_out, d_ref, d_tols)
        print(f"B3{name} alone vs dynamics_plain: max abs err {d_err}")
        d_ms = cuda_ms(lambda: fused_split.launch_dynamics(tables, q2, qd2, tgtT, zT, effT, fextT, dof_force, h, jwT))
        d_plain = cuda_ms(lambda: fused_split.dynamics_plain(tables, q, qd, *ctl, f_ext, h), warmup=1, runs=5)
        d_bytes = tables.table.numel() + 4 * n * (
            2 * (model.nq + model.nv)              # q, qd in and out
            + 3 * model.nd + 6 * model.nb          # targets, effort, f_ext in
            + model.nd + 6 * ns                    # dof_force, sensor wrenches out
        )
        db = bound(d_bytes, split_dynamics_flops(model, n) + sensor_flops(model) * n)
        result["split_dynamics"] = {"max_abs_err": max(d_err.values()), "max_err": d_err, "ms": d_ms,
                                    "plain_ms": d_plain, **db}
        kernels.append(("split_dynamics" + (" (sensor output)" if ns else "") + name, d_ms, d_plain, db))
    for kname, ms, pms, b in kernels:
        print(f"{kname}: kernel {ms:.4f} ms per launch, plain {pms:.4f} ms; bound: {b['bytes']} bytes "
              f"-> {b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    wrap_ms = cuda_ms(lambda: fused_split.split_substep(tables, *args, body_wrench=bw))
    plain_ms = cuda_ms(lambda: fused_split.split_substep_plain(tables, *args, body_wrench=bw), warmup=1, runs=5)
    print(f"split_substep wrapper ({env.substeps} x ({label}) with the env-minor copies): {wrap_ms:.4f} ms; "
          f"split_substep_plain {plain_ms:.4f} ms")
    return {
        **result,
        "pair": {"max_err": pair_err, "max_err_all_envs": all_err, "count_flip_envs": n_skip, "witness": witness,
                 "max_err_last_substep_from_kernel_state": last_err,
                 "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "active_envs": active,
                 "contact_envs_last_substep": last},
    }


def contacts_alone_vs_plain(tables, q, qd, slip_g, slip_p, h, bw, c_ref, c_tols, flip1, k_state, flip_k, b2,
                            wrench):
    """B2 alone against `contacts_plain` at the start and at the kernel's own
    state `k_state` (q, qd, slip_g, slip_p) after one substep (envs excused
    by the count witness: `flip1` at the start, `flip_k` there), B2's own
    outputs held to the wrench mode's contract when `wrench`; B2 and its
    plain version timed.  Returns (max_err, ms, plain_ms, bound)."""
    from isaacgymenv_tpu_torch.physics import fused_split
    from isaacgymenv_tpu_torch.physics.fused import to_minor

    model, n, dev = tables.model, q.shape[0], q.device
    c_out = contacts_kernel(tables, q, qd, slip_g, slip_p, h, bw)
    c_err = _compare(f"split_contacts ({b2})", c_out[:5], c_ref, c_tols, flip1)
    c_out_k = contacts_kernel(tables, *k_state, h, bw)
    c_err_k = _compare(f"split_contacts ({b2}) at the kernel's state", c_out_k[:5],
                       fused_split.contacts_plain(tables, *k_state, h, body_wrench=bw), c_tols, flip_k)
    print(f"{b2} alone vs contacts_plain: max abs err {c_err} at the start (over the {n - int(flip1.sum())} envs "
          f"whose counts agree), {c_err_k} at the kernel's state after one substep")
    if wrench:
        w_err = [check_wrench_mode(f"{b2}{at}", o, bw) for at, o in (("", c_out), (" at the kernel's state", c_out_k))]
        print(f"{b2}: f_ext = contacts + body wrench in all {n} envs x {model.nb * 6} entries, largest error "
              f"{max(w_err):.3g} of the entry's size (limit {WRENCH_RTOL}); contact force and torque exactly 0 on "
              f"the welded root under its 3 N and 1 N m of body wrench")

    # timed in place: each call advances its own copy of the state by one substep
    ground = model.ng and not model.no_ground
    qT, qdT, slip_pT = (to_minor(t, n) for t in (q, qd, slip_p))
    slip_gT = to_minor(slip_g, n) if ground else None
    bwT = None if bw is None else to_minor(bw, n)
    fext, cf, ct = (torch.empty((k * model.nb, n), device=dev) for k in (6, 3, 3))
    c_ms = cuda_ms(lambda: fused_split.launch_contacts(tables, qT, qdT, slip_gT, slip_pT, fext, cf, ct, h, bwT=bwT))
    c_plain = cuda_ms(lambda: fused_split.contacts_plain(tables, q, qd, slip_g, slip_p, h, body_wrench=bw),
                      warmup=1, runs=5)
    cb = bound(split_contacts_bytes(tables, n, wrench), split_contacts_flops(model, n, wrench))
    max_err = {k: max(c_err[k], c_err_k[k]) for k in c_err}
    return max_err, c_ms, c_plain, cb


def phase_split_ground(env) -> dict:
    """B2 + B3 on a flat-ground scene: Anymal's model through the split
    tables, from the states of the B1 check, against `split_substep_plain`."""
    from isaacgymenv_tpu_torch.physics import fused_split

    dev, model = env.device, env.model
    tables = fused_split.tables_for(model, dev)
    q, qd, tgt, slip = (t.to(dev) for t in near_standing_state(env, N_ENVS, seed=1))
    zero = torch.zeros_like(tgt)
    args = (q, qd, tgt, zero, zero, slip, None, env.dt / env.substeps, env.substeps)
    out = fused_split.split_substep(tables, *args)
    ref = fused_split.split_substep_plain(tables, *args)
    torch.cuda.synchronize()
    # the ground slip as B1's (tests/test_fused.py); no pairs
    err = _compare("split_substep (B2 + B3) on flat ground", out, ref,
                   {**SPLIT_TOLS, "slip_g": TOLS["slip_g"], "slip_p": None})
    contact = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"B2 + B3 vs plain on flat ground (Anymal) at {N_ENVS} envs, {env.substeps} substeps: max abs err {err}; "
          f"envs with ground contact {contact}")
    if contact < N_ENVS // 4:
        raise AssertionError(f"only {contact} envs have ground contact; the ground path is not exercised")
    return {"max_err": err, "contact_envs": contact}


def quad_flight_state(env, n: int, seed: int):
    """Quadcopter q, qd, pos_target and body wrenches (CPU tensors) in flight:
    the chassis tilted up to about 20 degrees and moving at up to 1 m/s and
    2 rad/s, the rotor hinges anywhere within their limits and turning;
    thrusts of 0-2 N along each rotor's axis (its local +z turned into the
    world by its pose), N(0, 1e-2) N and N(0, 1e-3) N m on every body."""
    from isaacgymenv_tpu_torch.ops import maths
    from isaacgymenv_tpu_torch.physics import engine, types

    rng = np.random.default_rng(seed)
    m = env.model
    lo, hi = m.dof_lower.cpu().numpy(), m.dof_upper.cpu().numpy()
    q = np.zeros((n, m.nq), np.float32)
    q[:, 0:3] = rng.uniform(-1.0, 1.0, (n, 3)) + [0.0, 0.0, 1.0]
    quat = rng.normal(size=(n, 4)) * 0.1 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(lo, hi, (n, m.nd))
    qd = np.zeros((n, m.nv), np.float32)
    qd[:, 0:3] = rng.uniform(-2.0, 2.0, (n, 3))
    qd[:, 3:6] = rng.uniform(-1.0, 1.0, (n, 3))
    qd[:, 6:] = rng.uniform(-3.0, 3.0, (n, m.nd))
    tgt = rng.uniform(lo, hi, (n, m.nd))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    q, qd, tgt = f(q), f(qd), f(tgt)
    state = dataclasses.replace(types.make_zero_state(m.to("cpu"), n), q=q, qd=qd)
    quat_w = engine.forward(m.to("cpu"), None, state).body_quat
    bw = f(np.concatenate([rng.normal(size=(n, m.nb, 3)) * 1e-3, rng.normal(size=(n, m.nb, 3)) * 1e-2], -1))
    thrust = torch.zeros((n, 3))
    for b in env.rotor_bodies:
        thrust[:, 2] = f(rng.uniform(0.0, env.thrust_max, n))
        bw[:, b, 3:] += maths.quat_rotate(quat_w[:, b], thrust)
    return q, qd, tgt, bw


def phase_wrench_kernel_vs_plain(env, fused) -> dict:
    """B1 in its wrench mode on Quadcopter's scene (no geoms) at the slice's
    width, against `fused_substep_plain` with the same body wrenches, at the
    tolerances of tests/test_fused.py; with no contact, the contact force and
    torque must be exactly 0 (the torque holds no wrench); B1 with an all-zero
    wrench must equal B1 without one, bit for bit; both timed."""
    dev, model = env.device, env.model
    n, h, substeps = env.num_envs, env.dt / env.substeps, env.substeps
    tables = fused.tables_for(model, dev)
    q, qd, tgt, bw = (t.to(dev) for t in quad_flight_state(env, n, seed=1))
    zero = torch.zeros_like(tgt)
    args = (q, qd, tgt, zero, zero, None, h, substeps)
    out = fused.fused_substep(tables, *args, body_wrench=bw)
    ref = fused.fused_substep_plain(tables, *args, body_wrench=bw)
    torch.cuda.synchronize()
    tols = {k: v for k, v in TOLS.items() if k != "slip_g"}
    max_err = _compare("fused_substep (B1, wrench mode)", out, ref, tols)
    if out[5] is not None or out[6] is not None:
        raise AssertionError("B1 on a scene without geoms or sensors returned a slip state or sensor wrenches")
    contact = max(float(out[3].abs().max()), float(out[4].abs().max()))
    if contact != 0.0:
        raise AssertionError(f"B1 wrench mode: a contact force or torque of {contact:.4g} on a scene without "
                             f"contacts; the body wrench leaked into the contact outputs")
    unforced = fused.fused_substep(tables, *args)
    zero_wrench = fused.fused_substep(tables, *args, body_wrench=torch.zeros_like(bw))
    if not all(torch.equal(a, b) for a, b in zip(unforced[:5], zero_wrench[:5])):
        raise AssertionError("B1 with an all-zero body wrench differs from B1 without one")
    moved = float((out[0] - unforced[0])[:, 0:3].abs().max())
    print(f"B1 wrench mode vs plain at {n} Quadcopter envs, {substeps} substeps, every env carrying thrusts of "
          f"0-{env.thrust_max} N on its {len(env.rotor_bodies)} rotors: max abs err {max_err}; contact force and "
          f"torque exactly 0; the wrench moves the chassis by up to {moved:.4g} m; a zero wrench equals none, "
          f"bit for bit")
    if moved < 1e-4:
        raise AssertionError("the body wrenches do not move the quadcopter")
    ms = cuda_ms(lambda: fused.fused_substep(tables, *args, body_wrench=bw))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(tables, *args, body_wrench=bw), warmup=1, runs=5)
    b = bound(fused_substep_bytes(model, n, wrench=True), fused_substep_flops(model, n, substeps, wrench=True))
    print(f"fused_substep (wrench mode): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} bytes -> "
          f"{b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}


def ball_on_tray_state(env, n: int, seed: int):
    """BallBalance q, qd, pos_target, slip_p (CPU tensors): the bot near its
    default pose (dofs within 0.02 rad, so the feet sit near their anchors,
    the tray within 2 mm and about 0.6 degrees), the ball 0.5-2 mm into the
    tray's top face within 0.3 m of its center, rolling at up to 1.4 m/s and
    sinking at up to 5 cm/s: the tray pair is live in most envs, at its
    threshold in some."""
    rng = np.random.default_rng(seed)
    m = env.model
    ball = m.actor_root[env.ball_actor]
    tq, bq, bv = m.q_adr[env.tray_body], m.q_adr[ball], m.v_adr[ball]
    q = np.zeros((n, m.nq), np.float32)
    q[:, tq + 2] = env.tray_height + 0.002 * rng.uniform(-1, 1, n)
    quat = rng.normal(size=(n, 4)) * 0.005 + [0.0, 0.0, 0.0, 1.0]
    q[:, tq + 3:tq + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, list(m.dof_q_adr)] = 0.02 * rng.uniform(-1, 1, (n, m.nd))
    r, th = 0.3 * np.sqrt(rng.random(n)), rng.uniform(-np.pi, np.pi, n)
    q[:, bq], q[:, bq + 1] = r * np.cos(th), r * np.sin(th)
    q[:, bq + 2] = env.tray_height + 0.01 + env.ball_radius - rng.uniform(0.0005, 0.002, n)
    q[:, bq + 6] = 1.0
    qd = np.zeros((n, m.nv), np.float32)
    qd[:, :bv] = 0.05 * rng.normal(size=(n, bv))
    qd[:, bv + 3:bv + 5] = rng.uniform(-1.0, 1.0, (n, 2))  # the ball's frame is the world's (identity pose)
    qd[:, bv + 5] = -0.05 * rng.random(n)
    tgt = 0.02 * rng.uniform(-1, 1, (n, m.nd))
    slip = 1e-4 * rng.normal(size=(n, m.n_pairs, 3))
    return [torch.tensor(a, dtype=torch.float32) for a in (q, qd, tgt, slip)]


# The tray's free joint transmits no wrench in exact arithmetic: its sensor
# reads rounding noise (a few 1e-5 N), so it is held to an absolute tolerance
TRAY_SENSOR_TOL = (0.0, 1e-3)
# ShadowHand's revolute finger bodies that chip_smoke declares as force-sensor
# bodies, for B3's sensor output on real joint wrenches
HAND_SENSOR_BODIES = ("robot0:ffproximal", "robot0:mfproximal", "robot0:rfproximal", "robot0:lfproximal",
                      "robot0:thproximal", "robot0:ffmiddle")


def phase_hand_sensors_vs_plain(env) -> dict:
    """B3's sensor output on ShadowHand's model with force sensors declared on
    six revolute finger bodies, the cube on the palm, at the slice's width:
    B2 + B3 and B3 alone against their plain versions, the sensor wrenches at
    tests/test_fused.py's tolerance, with the count witness."""
    from isaacgymenv_tpu_torch.physics import types

    model = env.model
    bodies = tuple(model.body_names.index(b) for b in HAND_SENSOR_BODIES)
    if any(model.jtype[b] != types.JT_REVOLUTE for b in bodies):
        raise AssertionError(f"the hand's sensor bodies {HAND_SENSOR_BODIES} are not all revolute")
    env.model = dataclasses.replace(model, sensor_body=bodies)
    out = phase_split_vs_plain(env, sensor_tol=SENSOR_TOLS["joint_wrench"], contacts_alone=False,
                               name=" (ShadowHand)")
    env.model = model
    return out


FRANKA_ENVS = 8192     # FrankaCubeStack (cfg/task/FrankaCubeStack.yaml)
FRANKA_REACH_STEPS = 40
# B2's f_ext on a compensated body without contact is its gravcomp wrench:
# within this share of the body's largest entry (a few fp32 roundings of
# R com, the cross product and the scaling, in another order than torch's)
GRAVCOMP_RTOL = 1e-6


def franka_reach_actions(env, state, grasp: bool = False) -> torch.Tensor:
    """(N, 7) OSC actions toward 3 cm above cube A's center (the grip site
    0.5 cm above its top face): a proportional position command, saturated
    at the action limit, no turn; the gripper open, or closing with `grasp`."""
    cube_a, _, eef_pos, _ = env._scene_state(state)
    target = cube_a[:, 0:3] + torch.tensor([0.0, 0.0, 0.03], device=env.device)
    actions = torch.zeros((env.num_envs, env.num_actions), device=env.device)
    actions[:, 0:3] = torch.clamp(10.0 * (target - eef_pos), -1.0, 1.0)
    actions[:, -1] = -1.0 if grasp else 1.0
    return actions


@torch.no_grad()
def franka_reach_state(env, n: int, seed: int, steps: int = FRANKA_REACH_STEPS):
    """FrankaCubeStack q, qd, finger targets, slip_p and arm efforts on the
    env's device after `steps` acting steps from its own start (`seed`), the
    grip site driven toward cube A by `franka_reach_actions` with the gripper
    open: the cubes have settled onto the table (cube B out of its 1 cm spawn
    depth) and the fingers straddle cube A.  The targets and efforts are
    those of the next step, the grasp: the OSC torques and the fingers
    closing at their drives' effort limit.  The rollout runs on the env's
    own path (the kernels on the card)."""
    if env.num_envs != n:
        raise ValueError(f"franka_reach_state: the env has {env.num_envs} envs, not {n}")
    state = env.initial_state(seed=seed)
    for _ in range(steps):
        state, *_ = env.step(state, franka_reach_actions(env, state))
    ctrl, _ = env._make_control(state, franka_reach_actions(env, state, grasp=True), {})
    return state.sim.q, state.sim.qd, ctrl.pos_target, state.sim.slip_p, ctrl.effort


def contact_free_bodies(model, q, qd) -> torch.Tensor:
    """(N, nb) bool: bodies with no live ground or pair contact at (q, qd),
    as the plain version decides them."""
    from isaacgymenv_tpu_torch.physics import contact, engine, kinematics

    body_pos, R_w, _, _, geom_pos, _ = engine._geom_world(model, kinematics.fk(model, q, qd))
    live = torch.zeros((q.shape[0], model.nb), device=q.device)
    index = lambda t: torch.as_tensor(t, device=q.device)  # noqa: E731
    gb = index(model.geom_body)
    if not model.no_ground:
        live.index_add_(1, gb, contact.ground_active(model, None, geom_pos).to(live.dtype))
    act_p = contact.pair_active(model, geom_pos, body_pos, R_w).to(live.dtype)
    live.index_add_(1, gb[index(model.pair_geom)], act_p)
    live.index_add_(1, index(model.surf_body)[index(model.pair_surf)], act_p)
    return live == 0


def check_gravcomp_free_bodies(env, reach) -> dict:
    """B2 alone at the reach state: on every gravity-compensated body without
    contact its f_ext must be the compensation alone, -gravcomp m g at the
    world COM (`engine.gravcomp_wrench` on the same poses), within
    GRAVCOMP_RTOL of the body's largest entry; and its contact torque the
    same moment."""
    from isaacgymenv_tpu_torch.physics import engine, fused_split, kinematics

    model, dev, n = env.model, env.device, env.num_envs
    q, qd, _, slip_p = reach[:4]
    h = env.dt / env.substeps
    tables = fused_split.tables_for(model, dev)
    f_ext, _, ct, *_ = contacts_kernel(tables, q, qd, torch.zeros((n, model.ng, 3), device=dev), slip_p, h)
    want = engine.gravcomp_wrench(model, torch.stack(kinematics.fk(model, q, qd).R_w, dim=-3))
    free = contact_free_bodies(model, q, qd)
    # the compensated bodies with mass; the massless ones (frames of the URDF) get nothing
    held = free & (model.body_gravcomp * model.body_mass != 0)
    massless = free & (model.body_gravcomp * model.body_mass == 0)
    size = want.abs().amax(-1, keepdim=True)
    err = ((f_ext - want).abs()[held] / size[held])
    ct_err = ((ct - want[..., :3]).abs()[held] / size[held])
    if held.sum() < n:
        raise AssertionError(f"only {int(held.sum())} compensated bodies without contact; the check needs one per env")
    if f_ext[massless].any() or ct[massless].any():
        raise AssertionError("B2 gravcomp mode: a wrench on a contact-free body without compensated mass")
    worst = max(float(err.max()), float(ct_err.max()))
    print(f"B2 gravcomp mode alone: f_ext and contact torque of {int(held.sum())} compensated bodies without contact "
          f"equal -gravcomp m g at the world COM within {worst:.3g} of each body's largest entry "
          f"(limit {GRAVCOMP_RTOL}); |f_ext| up to {float(size.max()):.4g}; exactly 0 on {int(massless.sum())} "
          f"contact-free bodies without compensated mass")
    if not worst <= GRAVCOMP_RTOL:
        raise AssertionError(f"B2's f_ext on contact-free compensated bodies is not their gravcomp wrench: "
                             f"{worst:.3g} of the body's largest entry")
    return {"bodies_held": int(held.sum()), "max_rel_err": worst}


def franka_arm_model(device, gravcomp: bool = True):
    """The Franka of FrankaCubeStack alone (its URDF, stand pose, drives and
    gravity compensation; no table, stand or cubes, so no pairs: B1's
    scene); without `gravcomp` its `body_gravcomp` is None."""
    from isaacgymenv_tpu_torch.envs import franka_cube_stack as fcs
    from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses

    fb, _ = fcs.franka_builder()
    if not gravcomp:
        for b in fb.bodies:
            b.gravcomp = 0.0
    return attach_effective_masses(fb.finalize()).to(device)


def phase_gravcomp_kernel_vs_plain(dev, fused, n: int = FRANKA_ENVS) -> dict:
    """B1's gravcomp mode on `franka_arm_model` at `n` envs, 2 substeps of
    FrankaCubeStack's dt, the arm on random efforts and the fingers on
    position targets, against `fused_substep_plain` at the tolerances of
    tests/test_fused.py; nothing touches the ground, so the contact force
    must be exactly 0 and the contact torque is the gravcomp moment; the
    scene without gravity compensation (`body_gravcomp` None) bit for bit
    equal to one with all-zero gravcomp, and apart from the compensated
    one; both timed."""
    from isaacgymenv_tpu_torch.envs import franka_cube_stack as fcs
    from isaacgymenv_tpu_torch.physics import engine

    model = franka_arm_model(dev)
    if engine._use_fused(model, torch.zeros((n, model.nq), device=dev)) != "mono":
        raise AssertionError("the Franka alone does not go to B1")
    engine._check_supported(model, None, "mono", "cuda")
    rng = np.random.default_rng(3)
    lo, hi = model.dof_lower.cpu().numpy(), model.dof_upper.cpu().numpy()
    q = np.clip(np.asarray(fcs.FRANKA_DEFAULT) + 0.25 * rng.uniform(-1, 1, (n, model.nd)), lo, hi)
    q[:, 7:] = rng.uniform(0.0, 0.04, (n, 2))
    qd = 0.5 * rng.normal(size=(n, model.nv))
    tgt = np.zeros((n, model.nd))
    tgt[:, 7:] = rng.uniform(0.0, 0.04, (n, 2))
    eff = np.zeros((n, model.nd))
    eff[:, :7] = 0.5 * model.dof_effort[:7].cpu().numpy() * rng.uniform(-1, 1, (n, 7))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    q, qd, tgt, eff = f(q), f(qd), f(tgt), f(eff)
    substeps, h = 2, 0.01667 / 2  # cfg/task/FrankaCubeStack.yaml
    zero = torch.zeros_like(tgt)
    args = (q, qd, tgt, zero, eff, torch.zeros((n, model.ng, 3), device=dev), h, substeps)
    tables = fused.tables_for(model, dev)
    out = fused.fused_substep(tables, *args)
    ref = fused.fused_substep_plain(tables, *args)
    torch.cuda.synchronize()
    max_err = _compare("fused_substep (B1, gravcomp mode)", out, ref, TOLS)
    if float(out[3].abs().max()) != 0.0:
        raise AssertionError("B1 gravcomp mode: a contact force on the Franka alone, which touches nothing")
    moment = float(out[4].abs().max())
    bare = franka_arm_model(dev, gravcomp=False)
    if bare.body_gravcomp is not None:
        raise AssertionError("the Franka without gravity compensation still has body_gravcomp")
    unforced = fused.fused_substep(fused.tables_for(bare, dev), *args)
    zeroed = dataclasses.replace(bare, body_gravcomp=torch.zeros(bare.nb, device=dev))
    zero_gc = fused.fused_substep(fused.build_tables(zeroed, dev), *args)
    if not all(torch.equal(a, b) for a, b in zip(unforced[:6], zero_gc[:6])):
        raise AssertionError("B1 with an all-zero gravcomp differs from B1 without gravity compensation")
    sag = float((unforced[0] - out[0]).abs().max())
    print(f"B1 gravcomp mode vs plain at {n} envs on the Franka alone ({gravcomp_bodies(model)} compensated bodies, "
          f"{substeps} substeps): max abs err {max_err}; contact force exactly 0, contact torque (the gravcomp "
          f"moment) up to {moment:.4g} N m; gravity compensation moves q by up to {sag:.4g} rad; all-zero gravcomp "
          f"equals none, bit for bit")
    if sag < 1e-5 or moment < 1e-3:
        raise AssertionError("the gravity compensation does not act on B1's scene")
    ms = cuda_ms(lambda: fused.fused_substep(tables, *args))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(tables, *args), warmup=1, runs=5)
    b = bound(fused_substep_bytes(model, n), fused_substep_flops(model, n, substeps))
    print(f"fused_substep (gravcomp mode): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} bytes -> "
          f"{b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}


def split_step_witness(envs: dict, records: dict) -> torch.Tensor:
    """The count witness of an env step of a split scene on the card against
    the CPU: every `engine.step` call recorded on each device, replayed one
    substep at a time (the card's by the kernels, the CPU's by the plain
    version: the same arithmetic as the step's own), B2's live counts at each
    substep's start on the card against the plain counts on the CPU.  Raises
    where counts differ without a pair within THRESHOLD_EPS of its threshold
    on either side.  Returns (n,) bool on the CPU: the envs whose counts
    differed at some substep's start."""
    from isaacgymenv_tpu_torch.physics import fused_split

    card, cpu = envs["cuda"], envs["cpu"]
    t_card, t_cpu = fused_split.tables_for(card.model, card.device), fused_split.tables_for(cpu.model, "cpu")
    n = cpu.num_envs
    flips = torch.zeros(n, dtype=torch.bool)
    for i, ((ks, kc, dt, subs), (ps, pc, _, _)) in enumerate(zip(records["cuda"], records["cpu"])):
        h = dt / subs
        states = []
        for st, m in ((ks, card.model), (ps, cpu.model)):
            slip_g = st.slip_g if st.slip_g is not None else torch.zeros((n, m.ng, 3), device=st.q.device)
            states.append((st.q, st.qd, slip_g, st.slip_p))
        ctl = [tuple(t.expand(n, cpu.model.nd) for t in (c.pos_target, c.vel_target, c.effort)) for c in (kc, pc)]
        k, p = states
        for s in range(subs):
            flip = (contacts_kernel(t_card, *k, h)[-1].cpu() != counts_plain(cpu.model, *p[:2])).any(-1)
            near = near_threshold(card.model, *k[:2]).cpu() | near_threshold(cpu.model, *p[:2])
            _check_flips(f"env step {i + 1}, substep {s + 1}", flip, near)
            flips |= flip
            ko = fused_split.split_substep(t_card, k[0], k[1], *ctl[0], k[2], k[3], h, 1, body_wrench=kc.body_wrench)
            po = fused_split.split_substep_plain(t_cpu, p[0], p[1], *ctl[1], p[2], p[3], h, 1,
                                                 body_wrench=pc.body_wrench)
            k, p = (ko[0], ko[1], ko[5], ko[6]), (po[0], po[1], po[5], po[6])
    return flips



def build_all() -> None:
    """Both kernel libraries, one nvcc call each, started together."""
    from isaacgymenv_tpu_torch.physics import fused, fused_split

    sources = (fused.SOURCE, fused_split.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for src, (lib_path, build_s, log) in zip(sources, pool.map(fused.build_library, sources)):
            print(f"build: {lib_path} in {build_s:.2f} s (one nvcc call)")
            for line in log.splitlines():
                if any(w in line for w in ("Function properties", "registers", "spill")):
                    print("  ptxas:", line.strip())


def kernel_entry(name: str, source: str, replaces: str, launches: int, k: dict, modes: str = "") -> dict:
    return {
        "name": name, "modes": modes, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": k["max_abs_err"], "max_err": k["max_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "bound_bytes": k["bytes"],
        "bound_flops": k["flops"], "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.physics import fused

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()

    env = isaacgymenv_tpu_torch.make("Anymal", num_envs=N_ENVS)
    k1 = phase_kernel_vs_plain(env, fused)
    ground = phase_split_ground(env)
    del env
    env = isaacgymenv_tpu_torch.make("AnymalTerrain", num_envs=N_ENVS, **TERRAIN_OVERRIDES)
    k1t = phase_terrain_kernel_vs_plain(env, fused)
    del env
    mono = {"fused_substep": 1, "split_contacts": 0, "split_dynamics": 0}
    anymal_tols = {"obs": (1e-3, 1e-2), "rew": (1e-3, 1e-4), "done": (0, 0), "q": (2e-4, 2e-4)}
    anymal = phase_slice("Anymal", N_ENVS, mono, card)
    phase_slice_vs_plain("Anymal", anymal_tols)
    terrain = phase_slice("AnymalTerrain", N_ENVS, mono, card, TERRAIN_OVERRIDES)
    # the env's own start through touchdown; the hard terrain standing still and moving
    runs = {"spawned": (None, 1.0, 8), "standing": (STANDING, 0.0, 2), "moving": (1.0, 1.0, 2)}
    terrain_env_step = {k: phase_terrain_slice_vs_plain(anymal_tols, motion, scale, MAX_CELL_SHARE[k], steps)
                        for k, (motion, scale, steps) in runs.items()}
    torch.cuda.empty_cache()

    env = isaacgymenv_tpu_torch.make("ShadowHand", num_envs=HAND_ENVS)
    k23 = phase_split_vs_plain(env)
    del env
    torch.cuda.empty_cache()
    split = {"fused_substep": 0, "split_contacts": 2, "split_dynamics": 2}
    hand = phase_slice("ShadowHand", HAND_ENVS, split, card)
    # obs as tests/test_torch_shadow_hand.py
    hand_tols = {"obs": (2e-3, 5e-3), "rew": (1e-3, 1e-3), "done": (0, 0), "q": (5e-4, 5e-4)}
    on_palm = lambda env, n: cube_on_palm_state(env, n, seed=2)[:2]  # noqa: E731
    phase_slice_vs_plain("ShadowHand", hand_tols, seed_state=on_palm)

    # ShadowHandOpenAI_FF: B2's wrench mode, the acting step with random object
    # forces, the env step against the CPU, training with the central value
    env = isaacgymenv_tpu_torch.make("ShadowHandOpenAI_FF", num_envs=HAND_ENVS)
    k2w = phase_split_vs_plain(env, wrench=True)
    del env
    torch.cuda.empty_cache()
    openai = phase_slice("ShadowHandOpenAI_FF", HAND_ENVS, split, card)
    # states as the obs (tests/test_torch_shadow_hand.py), the object force elementwise
    phase_slice_vs_plain("ShadowHandOpenAI_FF", {**hand_tols, "states": (2e-3, 5e-3), "rb_force": (1e-6, 1e-7)},
                         seed_state=on_palm)
    hand_training = phase_train(card, "ShadowHandOpenAI_FF", HAND_ENVS, HAND_TRAIN_EPOCHS, split)
    torch.cuda.empty_cache()

    # Ant: B1's sensor mode, the acting step, the env step against the CPU, training
    env = isaacgymenv_tpu_torch.make("Ant", num_envs=N_ENVS)
    k1s = phase_sensor_kernel_vs_plain(env, fused)
    del env
    k1q = phase_fixed_sensor_kernel_vs_plain(torch.device("cuda"), fused)
    ant = phase_slice("Ant", N_ENVS, mono, card)
    # rew: the progress term is a difference of two potentials of about 6e4
    # (-|to_target| / dt), whose fp32 spacing is 0.0039
    phase_slice_vs_plain("Ant", {"obs": (1e-3, 1e-2), "rew": (1e-3, 1e-2), "done": (0, 0), "q": (2e-4, 2e-4)},
                         seed_state=lambda env, n: ant_contact_state(env, n, seed=2))
    training = phase_train(card)  # Ant at N_ENVS, B1 once per step
    torch.cuda.empty_cache()

    # Quadcopter: B1's wrench mode on a scene without geoms, the acting step,
    # the env step against the CPU, training
    env = isaacgymenv_tpu_torch.make("Quadcopter", num_envs=QUAD_ENVS)
    k1w = phase_wrench_kernel_vs_plain(env, fused)
    del env
    quad = phase_slice("Quadcopter", QUAD_ENVS, mono, card)
    phase_slice_vs_plain("Quadcopter", {"obs": (1e-3, 1e-3), "rew": (1e-3, 1e-3), "done": (0, 0),
                                        "q": (2e-4, 2e-4), "dof_targets": (0, 0), "thrusts": (0, 0)})
    quad_training = phase_train(card, "Quadcopter", QUAD_ENVS, SMALL_TRAIN_EPOCHS, mono)
    torch.cuda.empty_cache()

    # BallBalance: B2 with the world anchors and B3 with the tray's sensor
    # output, the sensor output on real wrenches (the hand's fingers), the
    # acting step, the env step against the CPU, training
    env = isaacgymenv_tpu_torch.make("BallBalance", num_envs=BALL_ENVS)
    k23a = phase_split_vs_plain(env, state=ball_on_tray_state, sensor_tol=TRAY_SENSOR_TOL, name=" (BallBalance)")
    del env
    env = isaacgymenv_tpu_torch.make("ShadowHand", num_envs=HAND_ENVS)
    k3h = phase_hand_sensors_vs_plain(env)
    del env
    torch.cuda.empty_cache()
    split4 = {"fused_substep": 0, "split_contacts": 4, "split_dynamics": 4}
    ball = phase_slice("BallBalance", BALL_ENVS, split4, card)
    # obs held absolutely (its 12 sensor entries read rounding noise, which a relative tolerance would not bound)
    on_tray = lambda env, n: ball_on_tray_state(env, n, seed=2)[:2]  # noqa: E731
    phase_slice_vs_plain("BallBalance", {"obs": (0, 1e-3), "rew": (1e-3, 1e-4), "done": (0, 0), "q": (5e-4, 5e-4),
                                         "dof_targets": (0, 0)}, seed_state=on_tray)
    ball_training = phase_train(card, "BallBalance", BALL_ENVS, SMALL_TRAIN_EPOCHS, split4)
    torch.cuda.empty_cache()

    # FrankaCubeStack: B2's gravcomp mode + B3 (the arm on effort drive) from
    # the cubes settled on the table and the fingers closing on cube A, B2 alone on
    # the contact-free compensated bodies, B1's gravcomp mode on the Franka
    # alone, the acting step, the env step against the CPU with the count
    # witness, training
    env = isaacgymenv_tpu_torch.make("FrankaCubeStack", num_envs=FRANKA_ENVS)
    reach = franka_reach_state(env, FRANKA_ENVS, seed=1)
    k23g = phase_split_vs_plain(env, state=lambda env, n, seed: reach, name=" (FrankaCubeStack)")
    gravcomp_free = check_gravcomp_free_bodies(env, reach)
    del env, reach
    k1g = phase_gravcomp_kernel_vs_plain(torch.device("cuda"), fused)
    torch.cuda.empty_cache()
    franka = phase_slice("FrankaCubeStack", FRANKA_ENVS, split, card)
    phase_slice_vs_plain("FrankaCubeStack", {"obs": (2e-3, 5e-3), "rew": (1e-3, 1e-4), "done": (0, 0),
                                             "q": (5e-4, 5e-4), "gripper_targets": (0, 0)}, witness=True)
    franka_training = phase_train(card, "FrankaCubeStack", FRANKA_ENVS, SMALL_TRAIN_EPOCHS, split)

    kernels = [
        kernel_entry("fused_substep", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", anymal["fused_substep"], k1, "flat (Anymal)"),
        kernel_entry("fused_substep_sensors", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", ant["fused_substep"], k1s,
                     "sensor output, flat (Ant: 4 revolute feet)"),
        kernel_entry("fused_substep_terrain", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", terrain["fused_substep"], k1t,
                     "terrain_mode + fric_mode (AnymalTerrain)"),
        kernel_entry("split_contacts", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:350", hand["split_contacts"], k23["split_contacts"],
                     "flat or no_ground, pairs (ShadowHand)"),
        kernel_entry("split_contacts_wrench", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:350", openai["split_contacts"], k2w["split_contacts"],
                     "wrench_mode, no_ground, pairs (ShadowHandOpenAI_FF)"),
        kernel_entry("split_dynamics", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:755", hand["split_dynamics"], k23["split_dynamics"],
                     "joints, drives, tendons (ShadowHand)"),
        kernel_entry("fused_substep_wrench", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", quad["fused_substep"], k1w,
                     "wrench_mode, no geoms (Quadcopter)"),
        kernel_entry("split_contacts_anchors", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:350", ball["split_contacts"], k23a["split_contacts"],
                     "world anchors, flat ground, pairs (BallBalance)"),
        kernel_entry("split_dynamics_sensors", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:755", ball["split_dynamics"], k23a["split_dynamics"],
                     "sensor output (BallBalance: the tray)"),
        kernel_entry("split_contacts_gravcomp", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:350", franka["split_contacts"], k23g["split_contacts"],
                     "gravity compensation, flat ground, pairs (FrankaCubeStack: 16 compensated bodies)"),
        # no task sends a compensated scene to B1 (every one has pairs): its
        # main path launches it no time, the witness scene does
        kernel_entry("fused_substep_gravcomp", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", 0, k1g,
                     "gravity compensation (the Franka alone, a witness scene)"),
    ]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s of wall time, the builds "
          f"included")
    print(json.dumps({"kernels": kernels, "split_pair": k23["pair"], "split_pair_wrench": k2w["pair"],
                      "split_pair_ground": ground, "terrain_env_step": terrain_env_step,
                      "sensors_fixed_joint_scene": k1q, "split_pair_anchors": k23a["pair"],
                      "split_sensors_hand": {"pair": k3h["pair"], "split_dynamics": k3h["split_dynamics"]},
                      "training": training, "training_hand": hand_training, "training_quadcopter": quad_training,
                      "training_ball_balance": ball_training, "split_pair_gravcomp": k23g["pair"],
                      "split_dynamics_franka": k23g["split_dynamics"], "gravcomp_free_bodies": gravcomp_free,
                      "training_franka": franka_training}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
