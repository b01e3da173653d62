"""Carry weights and state over from the JAX package, numpy arrays only.

Nothing here imports JAX: the caller flattens the JAX side to numpy
(`jax.device_get`) and hands the arrays over.  Tensors land on `device`,
"cuda" when it is None (raises without CUDA), as everywhere in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from isaacgymenv_tpu_torch.api import resolve_device
from isaacgymenv_tpu_torch.envs.base import EnvState
from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
from isaacgymenv_tpu_torch.physics.contact import Heightfield
from isaacgymenv_tpu_torch.physics.types import SimModel, SimState


def _dense(out: Dict[str, torch.Tensor], key: str, leaf) -> None:
    """A flax Dense leaf: its `kernel` (in, out) as `nn.Linear.weight` (out, in), its bias."""
    out[f"{key}.weight"] = torch.tensor(np.asarray(leaf["kernel"], np.float32).T)
    out[f"{key}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))


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
        _dense(out, key, leaf)
    return out


def central_value_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax `CentralValueNet` params (or an Adam moment of that shape) -> the
    port's `CentralValueNet.state_dict()`: `cv_dense_i` -> `cv_dense.i`,
    `cv_value` -> `cv_value`."""
    p = params_np.get("params", params_np)
    out = {}
    for name, leaf in p.items():
        key = name.replace("cv_dense_", "cv_dense.") if name.startswith("cv_dense_") else name
        if key != "cv_value" and not key.startswith("cv_dense."):
            raise KeyError(f"unexpected CentralValueNet parameter '{name}'")
        _dense(out, key, leaf)
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


def train_state_from_jax(agent, params_np: Mapping, obs_stats, value_stats, lr, seed: int = 0, adam=None,
                         cv_params_np: Optional[Mapping] = None, cv_adam=None, states_stats=None):
    """A JAX `PPO` train state -> the port's `TrainState` for `agent` (a
    `learning.ppo.PPO`), all as numpy: the policy (through `policy_from_jax`),
    both running normalizers as (mean, var, count), the learning rate and,
    when given, Adam's state `adam` = (mu, nu, count), the moments in the
    parameters' flax tree; with a central value also its parameters
    (`central_value_from_jax`), its Adam state `cv_adam` as `adam`, and
    `states_stats` as (mean, var, count).  The env state, the episode
    statistics and whatever is not given are fresh, from `agent.init(seed)`."""
    dev = agent.device
    on = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    params = on(policy_from_jax(params_np))
    cv_params = None if cv_params_np is None else on(central_value_from_jax(cv_params_np))
    ts = agent.init(seed, params=params, cv_params=cv_params)

    def adam_state(state, convert):
        mu, nu, count = state
        return {"mu": on(convert(mu)), "nu": on(convert(nu)), "count": torch.tensor(np.asarray(count, np.int32),
                                                                                     device=dev)}

    extra = {}
    if adam is not None:
        extra["opt_state"] = adam_state(adam, policy_from_jax)
    if ts.cv is not None:
        cv = {}
        if cv_adam is not None:
            cv["opt_state"] = adam_state(cv_adam, central_value_from_jax)
        if states_stats is not None:
            cv["stats"] = running_stats_from_jax(*states_stats, device=dev)
        extra["cv"] = dataclasses.replace(ts.cv, **cv)
    return dataclasses.replace(
        ts, obs_stats=running_stats_from_jax(*obs_stats, device=dev),
        value_stats=running_stats_from_jax(*value_stats, device=dev),
        lr=torch.tensor(np.asarray(lr, np.float32), device=dev), **extra,
    )
