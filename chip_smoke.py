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
4. the Anymal slice: `make("Anymal", num_envs=4096)` on cuda, then 100
   acting steps (normalize obs -> ActorCritic -> sample actions -> env.step)
   with random weights from a seed; checks finiteness, the obs shape and the
   launch counts (B1 once per step, no split kernel); then 2 steps at 128
   envs held against the plain version on the CPU with the same draws;
   before that, B2 + B3 on the same flat-ground states as phase 3 (Anymal's
   model through the split tables) against `split_substep_plain`;
5. B2 + B3 vs plain: ShadowHand at 16384 envs, numpy-seeded states with the
   cube resting on the palm (pair contacts active), one control step through
   the split kernels and through `split_substep_plain`, compared at the
   tolerances of tests/test_fused_split.py, envs excused only where B2's own
   live contact counts (its `counts=` output) differ from the plain
   version's; the plain second substep from the kernel's own state; each
   kernel alone against its own plain version (`contacts_plain`,
   `dynamics_plain`); each kernel, the wrapper and the plain versions timed
   with CUDA events;
6. the ShadowHand slice: `make("ShadowHand", num_envs=16384)` on cuda, 100
   acting steps with the [512, 512, 256, 128] policy; launch counts (each
   split kernel twice per step, no B1); then 2 steps at 128 envs from the
   resting state held against the CPU plain path;
7. the `kernels` JSON line, the card line, and the final ok line.
"""

from __future__ import annotations

import concurrent.futures
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
N_STEPS = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
# (rtol, atol) per output, those of tests/test_fused.py for q, qd, dof_force,
# contact_force; contact torque as contact force; slip as a position
TOLS = {
    "q": (2e-4, 2e-4), "qd": (2e-3, 2e-3), "dof_force": (2e-3, 2e-3),
    "contact_force": (2e-3, 2e-2), "contact_torque": (2e-3, 2e-2), "slip_g": (2e-4, 2e-4),
}
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


def fused_substep_flops(model, n: int, substeps: int) -> int:
    """fp32 operations that csrc/fused_substep.cu performs for one launch."""
    return sum(_stage_flops(model).values()) * substeps * n


# surface_closest per kind (sphere, box from outside, capsule, cylinder from outside)
CLOSEST_FLOPS = {0: 11, 1: 26, 2: 15, 3: 30}
PAIR_QUERY_FLOPS = 2 * MV3 + 3 + MM3 + 3 + 3 + MV3 + MV3 + 1   # c, R_s, p_s, d, local, n, depth
PAIR_FORCE_FLOPS = 170                                            # lever .. accumulation


def split_contacts_flops(model, n: int) -> int:
    """fp32 operations that one launch of B2 (split_contacts_kernel) performs:
    FK, the ground passes unless `no_ground`, and two surface queries plus one
    force evaluation per pair (box queries counted on their outside branch)."""
    st = _stage_flops(model)
    pairs = sum(2 * (PAIR_QUERY_FLOPS + CLOSEST_FLOPS[model.surf_kind[s]]) + 3 + PAIR_FORCE_FLOPS
                for s in model.pair_surf)
    ground = model.nb * 2 if model.no_ground else st["ground"]
    return (st["fk"] + ground + pairs) * n


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
    n_bytes = 4 * N_ENVS * (
        2 * (model.nq + model.nv + 3 * model.ng)   # q, qd, slip in and out
        + 3 * model.nd                             # targets + effort in
        + model.nd + 6 * model.nb                  # dof_force, contact force + torque out
    )
    b = bound(n_bytes, fused_substep_flops(model, N_ENVS, env.substeps))
    print(f"fused_substep: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {b['bytes']} bytes "
          f"-> {b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    return {"max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}


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
def phase_slice(task: str, n_envs: int, expected: dict, card: str) -> dict:
    """`make(task)` on the card and N_STEPS acting steps; the kernels'
    launch counts in that run must be `expected` (per acting step)."""
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.networks import ActorCritic
    from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    env = isaacgymenv_tpu_torch.make(task, num_envs=n_envs)
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
    for label, t in (("obs", obs), ("rew", rew), ("mu", mu), ("value", value),
                     ("q", state.sim.q), ("qd", state.sim.qd), ("contact_force", state.sim.contact_force)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{task}: non-finite {label} after {N_STEPS} acting steps")
    print(f"slice {task}: {N_STEPS} acting steps at {n_envs} envs in {seconds:.3f} s = "
          f"{N_STEPS * n_envs / seconds:.0f} env-steps/s (information only; {card}); "
          f"kernel launches {launches}; done this step {int(done.sum())}; mean reward {float(rew.mean()):.5f}")
    return launches


@torch.no_grad()
def phase_slice_vs_plain(task: str, tols: dict, n: int = 128, steps: int = 2, seed_state=None) -> None:
    """The env step on the card (kernels) against the CPU (plain), same inputs.
    `seed_state(env, n)` -> (q, qd) replaces the initial q and qd when given."""
    import isaacgymenv_tpu_torch

    envs = {d: isaacgymenv_tpu_torch.make(task, num_envs=n, device=d) for d in ("cuda", "cpu")}
    cpu = envs["cpu"]
    gen = torch.Generator().manual_seed(3)
    reset_draws = [cpu.sample_reset_draws(gen, n) for _ in range(steps + 1)]
    step_draws = [cpu.sample_step_draws(gen, n) for _ in range(steps)]
    actions = [torch.rand((n, cpu.num_actions), generator=gen) * 2 - 1 for _ in range(steps)]
    seeded = seed_state(cpu, n) if seed_state else None
    to = lambda draws, dev: {k: v.to(dev) for k, v in draws.items()}  # noqa: E731
    outs = {}
    for d, env in envs.items():
        state = env.initial_state(reset_draws=to(reset_draws[0], env.device))
        if seeded is not None:
            sim = dataclasses.replace(state.sim, q=seeded[0].to(env.device), qd=seeded[1].to(env.device))
            state = dataclasses.replace(state, sim=sim)
        for i in range(steps):
            state, obs, rew, done, _ = env.step(
                state, actions[i].to(env.device), reset_draws=to(reset_draws[i + 1], env.device),
                step_draws=to(step_draws[i], env.device),
            )
        outs[d] = {"obs": obs["obs"].cpu(), "rew": rew.cpu(), "done": done.cpu(), "q": state.sim.q.cpu(),
                   "contact_force": state.sim.contact_force.cpu()}
    contact = int((outs["cpu"]["contact_force"].abs().sum(-1) > 0).any(-1).sum())
    for label, (rtol, atol) in tols.items():
        a, b = outs["cuda"][label].float(), outs["cpu"][label].float()
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{task}: env.step on the card disagrees with the CPU plain path: "
                                 f"{label} max abs err {err}")
        print(f"{task} env.step cuda vs cpu at {n} envs, {steps} steps: {label} max abs err {err}")
    print(f"{task} env.step cuda vs cpu: {contact} of {n} envs in contact at the last substep")


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


def contacts_kernel(tables, q, qd, slip_g, slip_p, h):
    """One launch of B2 alone on env-major inputs (left untouched):
    (f_ext, contact_force, contact_torque, slip_g, slip_p, counts), env-major,
    counts (N, nb) being the kernel's own live contacts per body (at least 1)."""
    from isaacgymenv_tpu_torch.physics import fused_split
    from isaacgymenv_tpu_torch.physics.fused import from_minor, to_minor

    model, n, dev = tables.model, q.shape[0], q.device
    ground = model.ng and not model.no_ground
    s_gT = to_minor(slip_g, n) if ground else None
    s_pT = to_minor(slip_p, n) if model.n_pairs else None
    empty = lambda k: torch.empty((k, n), device=dev)  # noqa: E731
    fext, cf, ct, counts = empty(6 * model.nb), empty(3 * model.nb), empty(3 * model.nb), empty(model.nb)
    fused_split.launch_contacts(tables, to_minor(q, n), to_minor(qd, n), s_gT, s_pT, fext, cf, ct, h, counts)
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


def phase_split_vs_plain(env) -> dict:
    """B2 + B3 against `split_substep_plain` at the slice's width, and each
    kernel alone against its own plain version; timings and bounds."""
    from isaacgymenv_tpu_torch.physics import contact, engine, fused_split, kinematics
    from isaacgymenv_tpu_torch.physics.fused import from_minor, to_minor

    dev, model = env.device, env.model
    n, h = env.num_envs, env.dt / env.substeps
    tables = fused_split.tables_for(model, dev)
    q, qd, tgt, slip_p = (t.to(dev) for t in cube_on_palm_state(env, n, seed=1))
    zero = torch.zeros_like(tgt)
    slip_g = torch.zeros((n, model.ng, 3), device=dev)
    ctl = (tgt, zero, zero)
    args = (q, qd, *ctl, slip_g, slip_p, h, env.substeps)

    kin = kinematics.fk(model, q, qd)
    body_pos, R_w, _, _, geom_pos, _ = engine._geom_world(model, kin)
    active = int(contact.pair_active(model, geom_pos, body_pos, R_w).any(-1).sum())
    out = fused_split.split_substep(tables, *args)
    # both one substep at a time (the same arithmetic as substeps=2), to
    # read each one's state at the second substep's start
    k1 = fused_split.split_substep(tables, q, qd, *ctl, slip_g, slip_p, h, 1)
    mid = fused_split.split_substep_plain(tables, q, qd, *ctl, slip_g, slip_p, h, 1)
    ref = fused_split.split_substep_plain(tables, mid[0], mid[1], *ctl, mid[5], mid[6], h, 1)
    # the plain second substep from the kernel's own state
    ref_k = fused_split.split_substep_plain(tables, k1[0], k1[1], *ctl, k1[5], k1[6], h, 1)
    if not all(torch.equal(a, b) for a, b in zip(out[:2], fused_split.split_substep(
            tables, k1[0], k1[1], *ctl, k1[5], k1[6], h, 1)[:2])):
        raise AssertionError("split_substep: two substeps differ from two chained single substeps")

    # the witness: B2's own live counts at each substep's start
    flip1 = count_flips(tables, (q, qd, slip_g, slip_p), (q, qd), h)
    flip2 = count_flips(tables, (k1[0], k1[1], k1[5], k1[6]), (mid[0], mid[1]), h)
    flip_k = count_flips(tables, (k1[0], k1[1], k1[5], k1[6]), (k1[0], k1[1]), h)
    at0, at_k, at_mid = (near_threshold(model, a, b) for a, b in ((q, qd), (k1[0], k1[1]), (mid[0], mid[1])))
    skip = flip1 | flip2
    n_skip = int(skip.sum())
    witness = {"flip_substep1": int(flip1.sum()), "flip_substep2": int((flip2 & ~flip1).sum()),
               "flip_from_kernel_state": int(flip_k.sum()), "pair_at_threshold_substep1": int(at0.sum()),
               "pair_at_threshold_kernel_state": int(at_k.sum())}
    print(f"count witness (envs): {witness}")
    # envs outside the tolerances, whatever the witness says
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for (name, tol), a, b in zip(SPLIT_TOLS.items(), out, ref):
        if tol is not None:
            bad |= ((a - b).abs() > tol[1] + tol[0] * b.abs()).reshape(n, -1).any(-1)
    print(f"envs outside the tolerances over all envs: {int(bad.sum())}, of them with a count flip "
          f"{int((bad & skip).sum())}, with a pair at its threshold {int((bad & (at0 | at_k | at_mid)).sum())}")
    _check_flips("substep 1", flip1, at0)
    _check_flips("substep 2", flip2 & ~flip1, at_k | at_mid)
    _check_flips("substep 2 from the kernel's state", flip_k, at_k)
    all_err = {name: float((a - b).abs().max()) for name, a, b in zip(SPLIT_TOLS, out, ref)
               if SPLIT_TOLS[name] is not None}
    pair_err = _compare("split_substep (B2 + B3)", out, ref, SPLIT_TOLS, skip)
    second_err = _compare("split_substep (B2 + B3), second substep from the kernel's state", out, ref_k,
                          SPLIT_TOLS, flip_k)
    last = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"B2 + B3 vs plain at {n} envs, {env.substeps} substeps: max abs err {pair_err} over the {n - n_skip} envs "
          f"whose live contact counts agree with B2's at both substeps' starts ({n_skip} whose do not: max abs err "
          f"over all envs {all_err}); envs with an active pair contact: {active} at the start, {last} at the "
          f"last substep")
    print(f"count witness: every env whose counts differ has a pair within {THRESHOLD_EPS} m of its threshold")
    print(f"second substep from the kernel's own state vs plain: max abs err {second_err} over the "
          f"{n - int(flip_k.sum())} envs whose counts agree there")
    if last < n // 4:
        raise AssertionError(f"only {last} envs have a pair contact; the pair path is not exercised")
    if n_skip > MAX_THRESHOLD_SHARE * n:
        raise AssertionError(f"{n_skip} envs have counts that differ; more than {MAX_THRESHOLD_SHARE} of them")

    # each kernel alone: B2 at the start and at the kernel's own state after
    # one substep, B3 from the plain f_ext
    c_tols = {"f_ext": (2e-3, 5e-2), "contact_force": (2e-3, 5e-2), "contact_torque": (2e-3, 5e-2),
              "slip_g": None, "slip_p": (2e-3, 1e-5)}
    c_ref = fused_split.contacts_plain(tables, q, qd, slip_g, slip_p, h)
    c_err = _compare("split_contacts (B2)", contacts_kernel(tables, q, qd, slip_g, slip_p, h)[:5], c_ref,
                     c_tols, flip1)
    k_state = (k1[0], k1[1], k1[5], k1[6])
    c_err_k = _compare("split_contacts (B2) at the kernel's state", contacts_kernel(tables, *k_state, h)[:5],
                       fused_split.contacts_plain(tables, *k_state, h), c_tols, flip_k)
    f_ext = c_ref[0]
    d_ref = fused_split.dynamics_plain(tables, q, qd, *ctl, f_ext, h)
    qT, qdT, tgtT, zT, fextT, slip_pT = (to_minor(t, n) for t in (q, qd, tgt, zero, f_ext, slip_p))
    dof_force = torch.empty((model.nd, n), device=dev)
    q2, qd2 = qT.clone(), qdT.clone()
    fused_split.launch_dynamics(tables, q2, qd2, tgtT, zT, zT, fextT, dof_force, h)
    d_out = (from_minor(q2, n, model.nq), from_minor(qd2, n, model.nv), from_minor(dof_force, n, model.nd))
    d_err = _compare("split_dynamics (B3)", d_out, d_ref,
                     {"q": SPLIT_TOLS["q"], "qd": SPLIT_TOLS["qd"], "dof_force": SPLIT_TOLS["dof_force"]})
    print(f"B2 alone vs contacts_plain: max abs err {c_err} at the start (over the {n - int(flip1.sum())} envs "
          f"whose counts agree), {c_err_k} at the kernel's state after one substep; B3 alone vs dynamics_plain: "
          f"max abs err {d_err}")

    # timed in place: each call advances its own copy of the state by one substep
    fext, cf, ct = torch.empty_like(fextT), torch.empty((3 * model.nb, n), device=dev), \
        torch.empty((3 * model.nb, n), device=dev)
    c_ms = cuda_ms(lambda: fused_split.launch_contacts(tables, qT, qdT, None, slip_pT, fext, cf, ct, h))
    d_ms = cuda_ms(lambda: fused_split.launch_dynamics(tables, q2, qd2, tgtT, zT, zT, fextT, dof_force, h))
    c_plain = cuda_ms(lambda: fused_split.contacts_plain(tables, q, qd, slip_g, slip_p, h), warmup=1, runs=5)
    d_plain = cuda_ms(lambda: fused_split.dynamics_plain(tables, q, qd, *ctl, f_ext, h), warmup=1, runs=5)
    wrap_ms = cuda_ms(lambda: fused_split.split_substep(tables, *args))
    plain_ms = cuda_ms(lambda: fused_split.split_substep_plain(tables, *args), warmup=1, runs=5)

    table_bytes = tables.table.numel() + 4 * (tables.pint.numel() + tables.pflt.numel())
    c_bytes = table_bytes + 4 * n * (
        model.nq + model.nv                    # q, qd in
        + 6 * model.n_pairs                    # slip_p in and out
        + (0 if model.no_ground else 6 * model.ng)
        + 12 * model.nb                        # f_ext, contact force and torque out
    )
    d_bytes = tables.table.numel() + 4 * n * (
        2 * (model.nq + model.nv)              # q, qd in and out
        + 3 * model.nd + 6 * model.nb          # targets, effort, f_ext in
        + model.nd                             # dof_force out
    )
    cb = bound(c_bytes, split_contacts_flops(model, n))
    db = bound(d_bytes, split_dynamics_flops(model, n))
    for label, ms, pms, b in (("split_contacts", c_ms, c_plain, cb), ("split_dynamics", d_ms, d_plain, db)):
        print(f"{label}: kernel {ms:.4f} ms per launch, plain {pms:.4f} ms; bound: {b['bytes']} bytes "
              f"-> {b['bytes_ms']:.5f} ms, {b['flops']} fp32 ops -> {b['ops_ms']:.5f} ms")
    print(f"split_substep wrapper ({env.substeps} x (B2 -> B3) with the env-minor copies): {wrap_ms:.4f} ms; "
          f"split_substep_plain {plain_ms:.4f} ms")
    return {
        "split_contacts": {"max_abs_err": max(max(c_err.values()), max(c_err_k.values())),
                           "max_err": c_err, "ms": c_ms, "plain_ms": c_plain, **cb},
        "split_dynamics": {"max_abs_err": max(d_err.values()), "max_err": d_err, "ms": d_ms, "plain_ms": d_plain,
                           **db},
        "pair": {"max_err": pair_err, "max_err_all_envs": all_err, "count_flip_envs": n_skip, "witness": witness,
                 "max_err_second_substep_from_kernel_state": second_err,
                 "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "active_envs": active,
                 "contact_envs_last_substep": last},
    }


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


def kernel_entry(name: str, source: str, replaces: str, launches: int, k: dict) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
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

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()

    env = isaacgymenv_tpu_torch.make("Anymal", num_envs=N_ENVS)
    k1 = phase_kernel_vs_plain(env, fused)
    ground = phase_split_ground(env)
    del env
    anymal = phase_slice("Anymal", N_ENVS, {"fused_substep": 1, "split_contacts": 0, "split_dynamics": 0}, card)
    phase_slice_vs_plain("Anymal", {"obs": (1e-3, 1e-2), "rew": (1e-3, 1e-4), "done": (0, 0), "q": (2e-4, 2e-4)})

    env = isaacgymenv_tpu_torch.make("ShadowHand", num_envs=HAND_ENVS)
    k23 = phase_split_vs_plain(env)
    del env
    torch.cuda.empty_cache()
    hand = phase_slice("ShadowHand", HAND_ENVS, {"fused_substep": 0, "split_contacts": 2, "split_dynamics": 2}, card)
    # obs as tests/test_torch_shadow_hand.py
    phase_slice_vs_plain(
        "ShadowHand", {"obs": (2e-3, 5e-3), "rew": (1e-3, 1e-3), "done": (0, 0), "q": (5e-4, 5e-4)},
        seed_state=lambda env, n: cube_on_palm_state(env, n, seed=2)[:2],
    )

    kernels = [
        kernel_entry("fused_substep", "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
                     "isaacgymenv_tpu/physics/fused.py:430", anymal["fused_substep"], k1),
        kernel_entry("split_contacts", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:350", hand["split_contacts"], k23["split_contacts"]),
        kernel_entry("split_dynamics", "isaacgymenv_tpu_torch/csrc/split_substep.cu",
                     "isaacgymenv_tpu/physics/fused_split.py:755", hand["split_dynamics"], k23["split_dynamics"]),
    ]
    print(json.dumps({"kernels": kernels, "split_pair": k23["pair"], "split_pair_ground": ground}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
