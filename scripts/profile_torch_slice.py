"""Where the time of one acting step of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_slice.py

For each ported slice (Anymal at 4096 envs, ShadowHand at 16384, the widths
chip_smoke.py drives), runs the chip_smoke.py acting step (normalize obs ->
ActorCritic -> sample actions -> env.step) for N_STEPS timed steps and
reports, with the card's name and power limit:
1. synchronized phase times: every phase ends in torch.cuda.synchronize(),
   inclusive host wall ms per acting step of the policy, `env.step`,
   `engine.step` (kernels + FK refresh) and `engine.forward` (FK refresh;
   twice per env step);
2. a torch.profiler window without synchronization: wall ms per step,
   device-busy ms per step (sum of kernel times), the idle share, CUDA
   kernel launches per step, and the kernels with the most device time.
The last line is one JSON object with the same numbers per slice.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLICES = (("Anymal", 4096), ("ShadowHand", 16384))  # as chip_smoke.py
N_STEPS = 20


def profile(task: str, n_envs: int) -> dict:
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.networks import ActorCritic
    from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
    from isaacgymenv_tpu_torch.physics import engine
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    env = isaacgymenv_tpu_torch.make(task, num_envs=n_envs)
    torch.manual_seed(0)
    policy = ActorCritic.from_train_config(load_train_config(task), env.num_obs, env.num_actions).to(env.device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    box = {"stats": RunningStats.create((env.num_obs,), device=env.device)}
    state = env.initial_state(seed=0)
    state, obs_dict, *_ = env.step(state, torch.zeros((n_envs, env.num_actions), device=env.device))

    def act(obs):
        box["stats"] = box["stats"].update(obs)
        mu, log_std, _ = policy(box["stats"].normalize(obs))
        return mu + torch.exp(log_std) * torch.randn(mu.shape, generator=gen, device=env.device)

    # ---- 1. synchronized phase times (inclusive), by wrapping the entry points
    totals = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return wrapper

    originals = (engine.step, engine.forward)
    engine.step = timed("engine.step", engine.step)
    engine.forward = timed("engine.forward", engine.forward)
    timed_act, timed_env_step = timed("policy", act), timed("env.step", env.step)
    obs = obs_dict["obs"]
    with torch.no_grad():
        for i in range(3 + N_STEPS):
            if i == 3:  # after 3 warm-up steps
                totals.clear()
            state, obs_dict, *_r = timed_env_step(state, timed_act(obs))
            obs = obs_dict["obs"]
    engine.step, engine.forward = originals
    phases = {k: 1e3 * v / N_STEPS for k, v in totals.items()}
    for k, v in phases.items():
        print(f"{task} synchronized {k}: {v:.3f} ms per acting step")

    # ---- 2. profiler window, no synchronization inside
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_STEPS):
            state, obs_dict, *_r = env.step(state, act(obs))
            obs = obs_dict["obs"]
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / N_STEPS
    # (name, microseconds) per kernel run: device events where the profiler
    # lists them, else the kernels it attaches to their launching CPU events
    events = prof.events()
    kernels = [(e.name, e.device_time_total) for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        kernels = [(k.name, k.duration) for e in events for k in e.kernels]
    busy_ms = sum(us for _, us in kernels) / 1e3 / N_STEPS
    by_name = collections.Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3 / N_STEPS
    top = [{"kernel": n[:80], "ms_per_step": round(v, 4)} for n, v in by_name.most_common(8)]
    print(f"{task} profiler: wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels) / N_STEPS:.0f} kernel launches/step")
    for t in top:
        print(f"  {t['ms_per_step']:.4f} ms/step  {t['kernel']}")
    return {
        "envs": n_envs, "steps": N_STEPS, "synchronized_ms": phases,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "launches_per_step": len(kernels) / N_STEPS, "top_kernels": top,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"card": card}
    for task, n_envs in SLICES:
        out[task] = profile(task, n_envs)
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
