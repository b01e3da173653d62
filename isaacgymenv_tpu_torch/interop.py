"""Carry weights and state over from the JAX package, numpy arrays only.

Nothing here imports JAX: the caller flattens the JAX side to numpy
(`jax.device_get`) and hands the arrays over.  Tensors land on `device`,
"cuda" when it is None (raises without CUDA), as everywhere in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from isaacgymenv_tpu_torch.api import resolve_device
from isaacgymenv_tpu_torch.envs.base import EnvState
from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
from isaacgymenv_tpu_torch.physics.contact import Heightfield
from isaacgymenv_tpu_torch.physics.types import SimModel, SimState


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


def heightfield_from_jax(heights, hscale: float, border_x: float, border_y: float, device=None) -> Heightfield:
    """A JAX `contact.Heightfield` (its `heights` as numpy, its static
    fields as floats) -> the port's `Heightfield`."""
    device = resolve_device(device)
    return Heightfield(torch.tensor(np.asarray(heights, np.float32), device=device),
                       float(hscale), float(border_x), float(border_y))


def with_geom_friction(model: SimModel, geom_friction) -> SimModel:
    """`model` with the JAX model's `geom_friction`: (ng,) shared, or
    (N, ng) per env (AnymalTerrain's friction buckets)."""
    gf = torch.tensor(np.asarray(geom_friction, np.float32), device=model.device)
    return dataclasses.replace(model, geom_friction=gf)


def train_state_from_jax(agent, params_np: Mapping, obs_stats, value_stats, lr, seed: int = 0):
    """A JAX `PPO` train state -> the port's `TrainState` for `agent` (a
    `learning.ppo.PPO`): the policy (through `policy_from_jax`), both running
    normalizers as (mean, var, count) and the learning rate, as numpy; the
    env state, Adam's moments and the episode statistics are fresh, from
    `agent.init(seed)`."""
    dev = agent.device
    params = {k: v.to(dev) for k, v in policy_from_jax(params_np).items()}
    ts = agent.init(seed, params=params)
    return dataclasses.replace(
        ts, obs_stats=running_stats_from_jax(*obs_stats, device=dev),
        value_stats=running_stats_from_jax(*value_stats, device=dev),
        lr=torch.tensor(np.asarray(lr, np.float32), device=dev),
    )
