"""Task registry: name -> TaskEnv class, for the ported tasks."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# (module, registry name) of the ported tasks
_TASKS = [("anymal", "Anymal"), ("anymal_terrain", "AnymalTerrain"), ("shadow_hand", "ShadowHand"),
          ("shadow_hand", "ShadowHandOpenAI_LSTM"), ("ant", "Ant"), ("ball_balance", "BallBalance"),
          ("quadcopter", "Quadcopter")]


def register(*names: str):
    def deco(cls):
        for name in names:
            _REGISTRY[name] = cls
        return cls

    return deco


def get_task(name: str):
    for mod, task in _TASKS:
        if task == name and name not in _REGISTRY:
            importlib.import_module(f"isaacgymenv_tpu_torch.envs.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"Unknown or unported task '{name}'. Ported: {[t for _, t in _TASKS]}")
    return _REGISTRY[name]
