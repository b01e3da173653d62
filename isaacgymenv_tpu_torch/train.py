"""Training CLI: `python -m isaacgymenv_tpu_torch.train task=Ant ...`.

Counterpart of the single-device PPO branch of `isaacgymenv_tpu/train.py`:
hydra-style `key=value` arguments, `task=<T>` selecting cfg/task/<T>.yaml
and cfg/train/<T>PPO.yaml (or `train=<name>`), `num_envs=N`,
`max_iterations=N` (epochs), `seed=S` (-1: random), `experiment=<name>`
(run directory `runs/<name>/`, relative to the working directory),
`checkpoint=<path>` to resume, `sigma=<float>` for the policy's action std,
`sim_device=cuda|cpu` (default cuda; without CUDA it raises unless cpu is
asked for), and dotted overrides: `train.params.config.X=...` for the train
config, `env.X=...` or `task.env.X=...` for the task config.  A train config
with a `central_value_config` (`task=ShadowHandOpenAI_FF`, through
ShadowHandOpenAI_FFPPO -> ShadowHandPPOAsymm) trains the asymmetric critic
on the env's `states` beside the policy.

It writes `runs/<experiment>/nn/<experiment>.ckpt` at the end,
`last_<experiment>.ckpt` every `save_frequency` epochs, a slim
`<experiment>_best.ckpt` on each better return after `save_best_after`
epochs, and the per-epoch scalars to `runs/<experiment>/summaries/
metrics.csv`.  Not ported: `test=True` (the player), `multi_gpu`, `pbt`,
`capture_video` (they raise NotImplementedError) and the SAC, AMP and LSTM
learners.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import List, Optional

import torch

_NOT_PORTED = {
    "test": "the player (test=True) is not ported (ROADMAP Queue A item 6: learning/player.py)",
    "multi_gpu": "multi-GPU training is not ported (ROADMAP Queue A item 6: data parallelism)",
    "pbt": "population-based training is not ported (ROADMAP Queue A item 10)",
    "capture_video": "capture_video is not ported (it needs the player, ROADMAP Queue A item 6)",
}


def _truthy(v: str) -> bool:
    return v.lower() in ("true", "1")


def _override_sigma(ts, sigma: float):
    """The policy's state-independent action std set to `sigma`."""
    params = {**ts.params, "log_std": torch.full_like(ts.params["log_std"], math.log(sigma))}
    print(f"sigma override: policy std set to {sigma}")
    return dataclasses.replace(ts, params=params)


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict((a.split("=", 1)[0].lstrip("+"), a.split("=", 1)[1]) for a in argv if "=" in a)

    task = kv.pop("task", "Ant")
    seed = int(kv.pop("seed", 42))
    if seed < 0:
        seed = int.from_bytes(os.urandom(4), "little") % (2**31)
    for key, why in _NOT_PORTED.items():
        v = kv.pop(key, "")
        if v and (key == "pbt" or _truthy(v)):
            raise NotImplementedError(why)
    checkpoint = kv.pop("checkpoint", "")
    sigma = kv.pop("sigma", "")
    max_iterations = kv.pop("max_iterations", "")
    num_envs = kv.pop("num_envs", "")
    experiment = kv.pop("experiment", task)
    kv.pop("headless", None)  # accepted for the reference's CLI; there is no viewer
    train_name = kv.pop("train", "")
    sim_device = kv.pop("sim_device", "cuda")

    from isaacgymenv_tpu_torch.api import resolve_device
    from isaacgymenv_tpu_torch.envs import registry
    from isaacgymenv_tpu_torch.learning.checkpoint import load_train_state, refill_slim, save_train_state
    from isaacgymenv_tpu_torch.learning.ppo import PPO
    from isaacgymenv_tpu_torch.utils.config import apply_cli_overrides, load_task_config, load_train_config
    from isaacgymenv_tpu_torch.utils.observers import CSVObserver, _scalars

    device = resolve_device(sim_device)
    task_cfg = load_task_config(task)
    train_cfg = load_train_config(task, train_name or None)
    apply_cli_overrides(task_cfg, [f"{k[5:] if k.startswith('task.') else k}={v}" for k, v in kv.items()
                                   if not k.startswith("train.")])
    apply_cli_overrides(train_cfg, [f"{k[6:]}={v}" for k, v in kv.items() if k.startswith("train.")])
    if num_envs:
        task_cfg["env"]["numEnvs"] = int(num_envs)
    algo = train_cfg["params"].get("algo", {}).get("name", "a2c_continuous")
    if algo != "a2c_continuous":
        raise NotImplementedError(f"the {algo} learner is not ported (ROADMAP Queue A items 6-7)")

    env = registry.get_task(task_cfg.get("name", task))(task_cfg, device)
    agent = PPO(env, train_cfg)
    run_dir = os.path.join("runs", experiment)
    os.makedirs(os.path.join(run_dir, "nn"), exist_ok=True)

    init_ts = None
    if checkpoint:
        init_ts = refill_slim(agent, load_train_state(agent, checkpoint), seed)
        print(f"resumed from {checkpoint} at epoch {init_ts.epoch}")
    if sigma:
        init_ts = _override_sigma(init_ts if init_ts is not None else agent.init(seed), float(sigma))

    observer = CSVObserver(run_dir)
    steps_per_epoch = agent.cfg.horizon_length * env.num_envs
    tc = train_cfg["params"].get("config", {})
    save_frequency = int(tc.get("save_frequency", 0) or 0)
    save_best_after = int(tc.get("save_best_after", 100) or 100)
    best = {"return": float("-inf")}
    start_epoch = init_ts.epoch if init_ts is not None else 0

    def callback(ep, ts, info):
        scalars = _scalars(info)  # one host read of the epoch's metrics
        observer.after_epoch(start_epoch + ep, ts.epoch * steps_per_epoch, scalars)
        if save_frequency and ts.epoch % save_frequency == 0:
            save_train_state(ts, os.path.join(run_dir, "nn", f"last_{experiment}.ckpt"))
        if ts.epoch > save_best_after and scalars["mean_return"] > best["return"]:
            best["return"] = scalars["mean_return"]
            save_train_state(ts, os.path.join(run_dir, "nn", f"{experiment}_best.ckpt"), slim=True)

    t0 = time.time()
    epochs = int(max_iterations) if max_iterations else None
    try:
        ts = agent.train(seed=seed, max_epochs=epochs, callback=callback, init_ts=init_ts)
    finally:
        observer.close()
    path = os.path.join(run_dir, "nn", f"{experiment}.ckpt")
    save_train_state(ts, path)
    steps = steps_per_epoch * (ts.epoch - start_epoch)
    dt = time.time() - t0
    print(f"saved {path}; {steps:,} env steps in {dt:.1f}s ({steps / dt:,.0f} steps/s)")
    return ts


if __name__ == "__main__":
    main()
