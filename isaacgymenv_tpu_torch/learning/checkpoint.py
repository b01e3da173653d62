"""Checkpoint save and restore of the port's PPO training state.

Counterpart of `isaacgymenv_tpu/learning/checkpoint.py`, in the port's own
format: `torch.save` of a versioned dict of plain tensors (no pickled
classes, so `torch.load(weights_only=True)` reads it).  Everything a run
needs to continue is in it: the policy parameters, Adam's moments, both
normalizers, the learning rate, the generators' states, the epoch, the
episode statistics and the env state; with a central value also its
parameters, its Adam state, the states' normalizer and the last states.

On load the model-defining entries (parameter names and shapes, Adam's
moments, the normalizers, whether there is a central value) are checked
against the agent, so a checkpoint of another network fails at the boundary
with a clear message.  The entries sized by the env count (env state, last
obs and states, episode returns) are exempt: a policy trained at 4096 envs
loads for a run at 8.  So is the device: a checkpoint written on the card
resumes on the CPU and the other way round.  A slim checkpoint (the
best-return snapshots) drops the env state, last obs and last states;
`refill_slim` takes them from a fresh `agent.init` before training resumes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional

import torch

from isaacgymenv_tpu_torch.envs.base import EnvState
from isaacgymenv_tpu_torch.learning.ppo import CVState, TrainState
from isaacgymenv_tpu_torch.learning.running_stats import RunningStats
from isaacgymenv_tpu_torch.physics.types import SimState

FORMAT = "isaacgymenv_tpu_torch.ckpt"
VERSION = 1


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x


def _stats(s: RunningStats) -> Dict[str, torch.Tensor]:
    return {"mean": s.mean, "var": s.var, "count": s.count}


def state_dict(ts: TrainState, slim: bool = False) -> Dict[str, Any]:
    """The train state as nested dicts of CPU tensors and numbers."""
    env = None
    if ts.env_state is not None and not slim:
        es = ts.env_state
        env = {"sim": {f.name: getattr(es.sim, f.name) for f in dataclasses.fields(es.sim)},
               "progress": es.progress, "reset": es.reset, "rng": es.rng.get_state(), "ts": es.ts}
    return _cpu({
        "params": ts.params, "opt_state": ts.opt_state,
        "obs_stats": _stats(ts.obs_stats), "value_stats": _stats(ts.value_stats),
        "lr": ts.lr, "rng": ts.rng.get_state(), "epoch": int(ts.epoch),
        "ep_return": ts.ep_return, "ep_length": ts.ep_length,
        "mean_return": ts.mean_return, "mean_length": ts.mean_length,
        "env_state": env, "last_obs": None if slim else ts.last_obs,
        "cv": None if ts.cv is None else {
            "params": ts.cv.params, "opt_state": ts.cv.opt_state, "stats": _stats(ts.cv.stats),
            "last_states": None if slim else ts.cv.last_states},
    })


def save_train_state(ts: TrainState, path: str, slim: bool = False) -> None:
    """Write the state to `path` (atomically: a reader never sees a partial file)."""
    payload = {"format": FORMAT, "version": VERSION, "slim": slim, "state": state_dict(ts, slim)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _validate_net(what: str, network, params, opt_state) -> None:
    want = {k: tuple(v.shape) for k, v in network.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise ValueError(f"checkpoint {what} parameters {got} != this agent's {want}: the checkpoint was saved "
                         f"with another network or task (check the train config)")
    for moment in ("mu", "nu"):
        if {k: tuple(v.shape) for k, v in opt_state[moment].items()} != want:
            raise ValueError(f"checkpoint {what} Adam moment '{moment}' does not match its parameters")


def _validate(agent, st: Dict[str, Any]) -> None:
    _validate_net("policy", agent.network, st["params"], st["opt_state"])
    stats = [("obs_stats", st["obs_stats"], (agent.env.num_obs,)), ("value_stats", st["value_stats"], ())]
    cv = st.get("cv")
    if agent.central_value != (cv is not None):
        raise ValueError(f"the checkpoint {'has' if cv is not None else 'lacks'} a central value and this agent "
                         f"{'does' if agent.central_value else 'does not'} (check the train config)")
    if cv is not None:
        _validate_net("central value", agent.cv_network, cv["params"], cv["opt_state"])
        stats.append(("central value stats", cv["stats"], (agent.env.num_states,)))
    for name, s, shape in stats:
        if tuple(s["mean"].shape) != shape:
            raise ValueError(f"checkpoint {name} has shape {tuple(s['mean'].shape)}, expected {shape}")


def _generator(state: torch.Tensor, device) -> torch.Generator:
    """A generator on `device` that continues the saved one.  A CPU and a
    CUDA generator keep states of different kinds (about 5 KB against a
    16-byte seed and offset), so a state saved on the other kind of device
    seeds the generator instead, from a hash of its bytes: the resumed run
    then draws a stream of its own, the same on every load."""
    g = torch.Generator(device=device)
    if state.numel() == g.get_state().numel():
        g.set_state(state)
    else:
        g.manual_seed(int.from_bytes(hashlib.sha256(state.numpy().tobytes()).digest()[:8], "little"))
    return g


def load_train_state(agent, path: str) -> TrainState:
    """Read a state saved by `save_train_state` onto the agent's device."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} checkpoint")
    if payload["version"] > VERSION:
        raise ValueError(f"checkpoint {path} has format version {payload['version']} > supported {VERSION}")
    st = payload["state"]
    _validate(agent, st)
    dev = agent.device
    t = lambda x: None if x is None else x.to(dev)  # noqa: E731
    tree = lambda d: {k: tree(v) if isinstance(v, dict) else t(v) for k, v in d.items()}  # noqa: E731
    env_state: Optional[EnvState] = None
    if st["env_state"] is not None:
        es = st["env_state"]
        env_state = EnvState(sim=SimState(**tree(es["sim"])), progress=t(es["progress"]), reset=t(es["reset"]),
                             rng=_generator(es["rng"], dev), ts=tree(es["ts"]))
    cv = st.get("cv")
    if cv is not None:
        cv = CVState(params=tree(cv["params"]), opt_state=tree(cv["opt_state"]),
                     stats=RunningStats(**tree(cv["stats"])), last_states=t(cv["last_states"]))
    return TrainState(
        params=tree(st["params"]), opt_state=tree(st["opt_state"]),
        obs_stats=RunningStats(**tree(st["obs_stats"])), value_stats=RunningStats(**tree(st["value_stats"])),
        lr=t(st["lr"]), env_state=env_state, last_obs=t(st["last_obs"]), rng=_generator(st["rng"], dev),
        epoch=int(st["epoch"]), ep_return=t(st["ep_return"]), ep_length=t(st["ep_length"]),
        mean_return=t(st["mean_return"]), mean_length=t(st["mean_length"]), cv=cv,
    )


def refill_slim(agent, ts: TrainState, seed: int = 0) -> TrainState:
    """Before resuming training from a slim checkpoint: the env state, last
    obs and last states of a fresh `agent.init(seed)`, everything else as
    loaded.  A full checkpoint is returned as it is.  The episode statistics
    restart when the env count changed."""
    if ts.env_state is not None and ts.ep_return.shape[0] == agent.env.num_envs:
        return ts
    fresh = agent.init(seed, params=ts.params, cv_params=None if ts.cv is None else ts.cv.params)
    keep = {"env_state": fresh.env_state, "last_obs": fresh.last_obs}
    if ts.cv is not None:
        keep["cv"] = dataclasses.replace(ts.cv, last_states=fresh.cv.last_states)
    if ts.ep_return.shape[0] != agent.env.num_envs:
        keep.update(ep_return=fresh.ep_return, ep_length=fresh.ep_length)
    return dataclasses.replace(ts, **keep)
