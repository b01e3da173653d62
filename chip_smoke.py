"""Chip smoke test of the PyTorch + CUDA port (isaacgymenv_tpu_torch) on one GPU.

Run from the repo root on a machine with an NVIDIA H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. device: the card's name and power limit (nvidia-smi);
2. build: the fused-substep kernel from isaacgymenv_tpu_torch/csrc/ with one
   nvcc call, as `make()` would at first use;
3. kernel vs plain: Anymal at 4096 envs, numpy-seeded states near the standing
   pose with feet in contact, one control step through the kernel and through
   `fused_substep_plain` on the card, compared at the tolerances of
   tests/test_fused.py; both timed with CUDA events (median of several runs);
4. the slice: `make("Anymal", num_envs=4096)` on cuda, then 100 acting steps
   (normalize obs -> ActorCritic -> sample actions -> env.step) with random
   weights from a seed; checks finiteness, the obs shape and that the kernel
   ran once per physics step; then 2 steps at 128 envs held against the
   plain version on the CPU with the same draws and actions;
5. the `kernels` JSON line, the card line, and the final ok line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 4096
N_STEPS = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
# (rtol, atol) per output, those of tests/test_fused.py for q, qd, dof_force,
# contact_force; contact torque as contact force; slip as a position
TOLS = {
    "q": (2e-4, 2e-4), "qd": (2e-3, 2e-3), "dof_force": (2e-3, 2e-3),
    "contact_force": (2e-3, 2e-2), "contact_torque": (2e-3, 2e-2), "slip_g": (2e-4, 2e-4),
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


def fused_substep_flops(model, n: int, substeps: int) -> int:
    """fp32 operations (an add or a multiply is one; an FMA two) that
    csrc/fused_substep.cu performs for one launch, counted per stage from its
    code for this model's topology."""
    from isaacgymenv_tpu_torch.physics.types import JT_FIXED, JT_FREE, JT_PRISMATIC, JT_REVOLUTE

    mm3, mv3, cross3, mv6 = 45, 15, 9, 72
    mot_to_child = frc_to_parent = 2 * mv3 + cross3 + 3
    inertia_to_parent = 13 * mm3 + 81
    chol6 = 150
    local = {JT_FREE: 30 + mm3 + mv3 + 3, JT_REVOLUTE: 48 + mm3, JT_PRISMATIC: mv3 + 9, JT_FIXED: 0}
    per = 0
    for i, jt in enumerate(model.jtype):
        has_par = model.parent[i] >= 0
        per += local[jt] + (mm3 + mv3 + 3 + mot_to_child + 6 if has_par else 0) + 30 + 2 * mv3  # FK
        per += mv6 + 30 + 2 * mv3 + 6                                                          # ABA setup
        if jt in (JT_REVOLUTE, JT_PRISMATIC):
            per += 2 * mv6 + 24 + 4 + 3 * 36 + 24                                              # ABA inward
        elif jt == JT_FIXED:
            per += mv6 + 6
        if has_par:
            per += inertia_to_parent + frc_to_parent + 6
        per += mot_to_child + 6 + (mv6 + 12 + chol6 + 12 if jt == JT_FREE else 17)             # ABA outward
        per += 130 if jt == JT_FREE else 0                                                     # integrate root
    per += model.ng * (7 + mv3 + 2 + 2 * (cross3 + 3) + 47 + 1 + cross3 + 9)                 # contacts
    per += model.nb * 2 + model.nd * (30 + 4) + model.nv * 2                                  # dofs, integrate
    return per * substeps * n


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
    max_err, failures = {}, []
    for (name, (rtol, atol)), a, b in zip(TOLS.items(), out, ref):
        err = (a - b).abs()
        max_err[name] = float(err.max())
        bad = int((err > atol + rtol * b.abs()).sum())
        if not torch.isfinite(a).all() or bad:
            failures.append(f"{name}: {bad} elements outside rtol={rtol} atol={atol}, max abs err {max_err[name]}")
    active = int((ref[3].abs().sum(-1) > 0).any(-1).sum())
    print(f"kernel vs plain at {N_ENVS} envs, {env.substeps} substeps: max abs err {max_err}; "
          f"envs with ground contact {active}")
    if failures:
        raise AssertionError("fused_substep kernel disagrees with its plain version:\n" + "\n".join(failures))
    if active < N_ENVS // 4:
        raise AssertionError(f"only {active} envs have ground contact; the contact path is not exercised")

    ms = cuda_ms(lambda: fused.fused_substep(tables, *args))
    plain_ms = cuda_ms(lambda: fused.fused_substep_plain(tables, *args), warmup=1, runs=5)
    n_bytes = 4 * N_ENVS * (
        2 * (model.nq + model.nv + 3 * model.ng)   # q, qd, slip in and out
        + 3 * model.nd                             # targets + effort in
        + model.nd + 6 * model.nb                  # dof_force, contact force + torque out
    )
    flops = fused_substep_flops(model, N_ENVS, env.substeps)
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S
    print(f"fused_substep: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {n_bytes} bytes "
          f"-> {bytes_ms:.5f} ms, {flops} fp32 ops -> {ops_ms:.5f} ms")
    return {
        "max_abs_err": max(max_err.values()), "max_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "flops": flops,
    }


@torch.no_grad()
def phase_slice(fused, card: str) -> int:
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.networks import ActorCritic
    from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    env = isaacgymenv_tpu_torch.make("Anymal", num_envs=N_ENVS)
    if env.device.type != "cuda":
        raise AssertionError(f"make() chose {env.device}, not the card")
    torch.manual_seed(0)
    policy = ActorCritic.from_train_config(load_train_config("Anymal"), env.num_obs, env.num_actions).to(env.device)
    stats = RunningStats.create((env.num_obs,), device=env.device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    state = env.initial_state(seed=0)
    state, obs_dict, _, _, _ = env.step(state, torch.zeros((N_ENVS, env.num_actions), device=env.device))
    obs = obs_dict["obs"]
    torch.cuda.synchronize()

    fused.fused_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        stats = stats.update(obs)
        mu, log_std, value = policy(stats.normalize(obs))
        actions = mu + torch.exp(log_std) * torch.randn(mu.shape, generator=gen, device=env.device)
        state, obs_dict, rew, done, extras = env.step(state, actions)
        obs = obs_dict["obs"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused.fused_substep.launches

    expected = N_STEPS * env.control_freq_inv
    if launches != expected:
        raise AssertionError(f"fused_substep launched {launches} times in {N_STEPS} steps, expected {expected}")
    if tuple(obs.shape) != (N_ENVS, env.num_obs):
        raise AssertionError(f"obs shape {tuple(obs.shape)}")
    for label, t in (("obs", obs), ("rew", rew), ("mu", mu), ("value", value),
                     ("q", state.sim.q), ("qd", state.sim.qd), ("contact_force", state.sim.contact_force)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {label} after {N_STEPS} acting steps")
    print(f"slice: {N_STEPS} acting steps at {N_ENVS} envs in {seconds:.3f} s = "
          f"{N_STEPS * N_ENVS / seconds:.0f} env-steps/s (information only; {card}); "
          f"kernel launches {launches}; done this step {int(done.sum())}; mean reward {float(rew.mean()):.5f}")
    return launches


@torch.no_grad()
def phase_slice_vs_plain(n: int = 128, steps: int = 2) -> None:
    """The env step on the card (kernel) against the CPU (plain), same inputs."""
    import isaacgymenv_tpu_torch

    envs = {d: isaacgymenv_tpu_torch.make("Anymal", num_envs=n, device=d) for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(3)
    draws = [envs["cpu"].sample_reset_draws(gen, n) for _ in range(steps + 1)]
    actions = [torch.rand((n, 12), generator=gen) * 2 - 1 for _ in range(steps)]
    outs = {}
    for d, env in envs.items():
        state = env.initial_state(reset_draws={k: v.to(env.device) for k, v in draws[0].items()})
        for i in range(steps):
            state, obs, rew, done, _ = env.step(
                state, actions[i].to(env.device), reset_draws={k: v.to(env.device) for k, v in draws[i + 1].items()}
            )
        outs[d] = (obs["obs"].cpu(), rew.cpu(), done.cpu(), state.sim.q.cpu())
    for label, a, b, (rtol, atol) in zip(
        ("obs", "rew", "done", "q"), outs["cuda"], outs["cpu"],
        ((1e-3, 1e-2), (1e-3, 1e-4), (0, 0), (2e-4, 2e-4)),
    ):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"env.step on the card disagrees with the CPU plain path: {label} max abs err {err}")
        print(f"env.step cuda vs cpu at {n} envs, {steps} steps: {label} max abs err {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.physics import fused

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    lib_path, build_s, log = fused.build_library()
    print(f"build: {lib_path} in {build_s:.2f} s (one nvcc call)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            print("  ptxas:", line.strip())

    env = isaacgymenv_tpu_torch.make("Anymal", num_envs=N_ENVS)
    k = phase_kernel_vs_plain(env, fused)
    del env
    launches = phase_slice(fused, card)
    phase_slice_vs_plain()

    kernels = [{
        "name": "fused_substep", "route": "cuda",
        "source": "isaacgymenv_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgymenv_tpu/physics/fused.py:430",
        "launches": launches, "max_abs_err": k["max_abs_err"], "max_err": k["max_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "bound_bytes": k["bytes"], "bound_flops": k["flops"], "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
