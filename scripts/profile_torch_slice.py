"""Where the time of one acting step of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_slice.py [Task ...]

For each ported slice (Anymal at 4096 envs, AnymalTerrain at 4096 on the
full trimesh grid, ShadowHand at 16384, ShadowHandOpenAI_FF at 16384, Ant
at 4096, Quadcopter at 8192, BallBalance at 4096, the widths chip_smoke.py
drives; or only the tasks named), runs the chip_smoke.py acting step (normalize obs ->
ActorCritic -> sample actions -> env.step) for N_STEPS timed steps and
reports, with the card's name and power limit:
1. synchronized phase times: every phase ends in torch.cuda.synchronize(),
   inclusive host wall ms per acting step of the policy, `env.step`,
   `engine.step` (kernels + FK refresh) and `engine.forward` (FK refresh;
   twice per env step, three times for AnymalTerrain, whose pushes refresh
   the caches every step), with the calls per step;
2. a torch.profiler window without synchronization: wall ms per step,
   device-busy ms per step (sum of kernel times), the idle share, CUDA
   kernel launches per step, and the kernels with the most device time.
Then the training epoch of each trained slice, after one warm-up epoch:
Ant at 4096 envs (`learning/ppo.py`, the configured horizon of 16 steps, 2
minibatches x 4 mini-epochs), ShadowHandOpenAI_FF at 16384 (horizon 8, 8
minibatches x 8 mini-epochs for the actor and again for the central
value), Quadcopter at 8192 (horizon 8, 4 minibatches x 8 mini-epochs) and
BallBalance at 4096 (horizon 16, 4 minibatches x 8 mini-epochs);
synchronized ms per epoch of the rollout, GAE and update over
TRAIN_EPOCHS epochs, and a profiler window over one epoch (device busy,
idle share, kernel launches).
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

# (task, envs, make() overrides), as chip_smoke.py
SLICES = (("Anymal", 4096, {}), ("AnymalTerrain", 4096, {"env.terrain.terrainType": "trimesh"}),
          ("ShadowHand", 16384, {}), ("ShadowHandOpenAI_FF", 16384, {}), ("Ant", 4096, {}),
          ("Quadcopter", 8192, {}), ("BallBalance", 4096, {}))
TRAINED = (("Ant", 4096), ("ShadowHandOpenAI_FF", 16384), ("Quadcopter", 8192), ("BallBalance", 4096))
N_STEPS = 20
TRAIN_EPOCHS = 5


def profile(task: str, n_envs: int, overrides: dict) -> dict:
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.networks import ActorCritic
    from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
    from isaacgymenv_tpu_torch.physics import engine
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    env = isaacgymenv_tpu_torch.make(task, num_envs=n_envs, **overrides)
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
    calls = collections.Counter()

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            calls[name] += 1
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
                calls.clear()
            state, obs_dict, *_r = timed_env_step(state, timed_act(obs))
            obs = obs_dict["obs"]
    engine.step, engine.forward = originals
    phases = {k: 1e3 * v / N_STEPS for k, v in totals.items()}
    for k, v in phases.items():
        print(f"{task} synchronized {k}: {v:.3f} ms per acting step ({calls[k] / N_STEPS:g} calls per step)")

    # ---- 2. profiler window, no synchronization inside
    def window():
        for _ in range(N_STEPS):
            box["state"], obs_dict, *_r = env.step(box["state"], act(box["obs"]))
            box["obs"] = obs_dict["obs"]

    box.update(state=state, obs=obs)
    with torch.no_grad():
        trace = profiler_window(window, N_STEPS, task, "step")
    return {"envs": n_envs, "steps": N_STEPS, "synchronized_ms": phases,
            "calls_per_step": {k: v / N_STEPS for k, v in calls.items()}, **trace}


def profiler_window(fn, count: int, label: str, unit: str) -> dict:
    """fn() under torch.profiler, no synchronization inside: wall ms, device
    busy ms (the sum of kernel times), idle share and kernel launches, per
    `count` units."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / count
    # (name, microseconds) per kernel run: device events where the profiler
    # lists them, else the kernels it attaches to their launching CPU events
    events = prof.events()
    kernels = [(e.name, e.device_time_total) for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        kernels = [(k.name, k.duration) for e in events for k in e.kernels]
    busy_ms = sum(us for _, us in kernels) / 1e3 / count
    by_name = collections.Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3 / count
    top = [{"kernel": n[:80], f"ms_per_{unit}": round(v, 4)} for n, v in by_name.most_common(8)]
    print(f"{label} profiler: wall {wall_ms:.3f} ms/{unit}, device busy {busy_ms:.3f} ms/{unit}, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels) / count:.0f} kernel launches/{unit}")
    for t in top:
        print(f"  {t[f'ms_per_{unit}']:.4f} ms/{unit}  {t['kernel']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            f"launches_per_{unit}": len(kernels) / count, "top_kernels": top}


def profile_training(task: str = "Ant", n_envs: int = 4096) -> dict:
    """The PPO epoch's split: synchronized rollout, GAE and update ms per
    epoch over TRAIN_EPOCHS epochs after one warm-up, then one profiled epoch."""
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.learning.ppo import PPO
    from isaacgymenv_tpu_torch.utils.config import load_train_config

    agent = PPO(isaacgymenv_tpu_torch.make(task, num_envs=n_envs), load_train_config(task))
    box = {"ts": agent.init(0)}
    box["ts"], _ = agent.train_epoch(box["ts"])  # warm-up
    totals = collections.defaultdict(list)

    def timed(name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name].append(1e3 * (time.perf_counter() - t0))
        return out

    for _ in range(TRAIN_EPOCHS):
        ts, batch, _m = timed("rollout", agent._rollout, box["ts"])
        advs, returns = timed("gae", agent._gae, ts, batch)
        box["ts"], _i = timed("update", agent._update, ts, batch, advs, returns)
    steps = agent.cfg.horizon_length * n_envs
    mean = {k: sum(v) / len(v) for k, v in totals.items()}
    print(f"{task} training at {n_envs} envs, {steps} env-steps per epoch: synchronized ms per epoch "
          + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
          + f"; {steps / (sum(mean.values()) / 1e3):.0f} env-steps/s")

    def epoch():
        box["ts"], _i = agent.train_epoch(box["ts"])

    trace = profiler_window(epoch, 1, f"{task} training", "epoch")
    return {"envs": n_envs, "env_steps_per_epoch": steps, "epochs": TRAIN_EPOCHS,
            "synchronized_ms_per_epoch": mean, "synchronized_ms_all": dict(totals), **trace}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tasks = sys.argv[1:] or [t for t, _, _ in SLICES]
    out = {"card": card}
    for task, n_envs, overrides in SLICES:
        if task in tasks:
            out[task] = profile(task, n_envs, overrides)
            torch.cuda.empty_cache()
    for task, n_envs in TRAINED:
        if task in tasks:
            out[f"{task} training"] = profile_training(task, n_envs)
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
