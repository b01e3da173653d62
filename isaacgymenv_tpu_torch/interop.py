"""Carry weights and state over from the JAX package, numpy arrays only.

Nothing here imports JAX: the caller flattens the JAX side to numpy
(`jax.device_get`) and hands the arrays over.  Tensors land on `device`,
"cuda" when it is None (raises without CUDA), as everywhere in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from isaacgymenv_tpu_torch.api import resolve_device
from isaacgymenv_tpu_torch.envs.base import EnvState
from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
from isaacgymenv_tpu_torch.physics.types import SimState


def policy_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax `ActorCritic` params -> the port's `ActorCritic.state_dict()`.

    Dense `kernel` (in, out) becomes `nn.Linear.weight` (out, in):
    `a_dense_i` -> `a_dense.i`, `mu` -> `mu`, `value` -> `value`; `log_std` as is.
    """
    p = params_np.get("params", params_np)
    out = {}
    for name, leaf in p.items():
        if name == "log_std":
            out["log_std"] = torch.tensor(np.asarray(leaf, np.float32))
            continue
        key = name.replace("a_dense_", "a_dense.") if name.startswith("a_dense_") else name
        if key not in ("mu", "value") and not key.startswith("a_dense."):
            raise KeyError(f"unexpected ActorCritic parameter '{name}'")
        out[f"{key}.weight"] = torch.tensor(np.asarray(leaf["kernel"], np.float32).T)
        out[f"{key}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
    return out


def running_stats_from_jax(mean, var, count, device=None) -> RunningStats:
    device = resolve_device(device)
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return RunningStats(mean=f(mean), var=f(var), count=f(count))


def env_state_from_jax(leaves: Mapping, device=None, seed: int = 0) -> EnvState:
    """JAX `EnvState` leaves -> the port's `EnvState`.

    leaves: {"sim": {SimState field: array}, "progress": (N,), "reset": (N,),
    "ts": {name: array}}.  JAX's PRNG key has no torch counterpart: the port's
    generator is seeded with `seed`.
    """
    device = resolve_device(device)
    t = lambda x: torch.tensor(np.asarray(x), device=device)  # noqa: E731
    sim = SimState(**{k: t(v) for k, v in leaves["sim"].items() if v is not None})
    return EnvState(
        sim=sim,
        progress=t(leaves["progress"]).to(torch.int32),
        reset=t(leaves["reset"]).to(torch.bool),
        rng=torch.Generator(device=device).manual_seed(seed),
        ts={k: t(v) for k, v in leaves["ts"].items()},
    )
