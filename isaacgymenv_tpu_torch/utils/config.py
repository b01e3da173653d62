"""YAML config loading: task/train split, `defaults:` inheritance, overrides.

Counterpart of `isaacgymenv_tpu/utils/config.py`; reads the port's own
copies under `isaacgymenv_tpu_torch/cfg/` (`cfg/task/<T>.yaml`,
`cfg/train/<T>PPO.yaml`) and the robot files under the repo-root `assets/`.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

CFG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")


def _parse_value(v: str) -> Any:
    """A CLI value as YAML reads it; "3e-4" (a string to YAML 1.1) as a float."""
    try:
        out = yaml.safe_load(v)
    except yaml.YAMLError:
        return v
    if isinstance(out, str):
        try:
            return float(out)
        except ValueError:
            return out
    return out


def set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def get_dotted(cfg: Dict, dotted: str, default=None):
    d = cfg
    for k in dotted.split("."):
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def deep_update(base: Dict, override: Dict) -> Dict:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml(path: str) -> Dict:
    """Load a yaml config, resolving hydra-style `defaults:` inheritance.

    A top-level `defaults: [Base, _self_]` list merges cfg/<dir>/Base.yaml
    (recursively resolved) under the file's own keys — the thin variant
    files mirror the reference's (e.g. ref cfg/task/AllegroHandFF.yaml,
    cfg/train/ShadowHandOpenAI_FFPPO.yaml)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    defaults = cfg.pop("defaults", None)
    if defaults:
        base: Dict = {}
        for d in defaults:
            if d == "_self_":
                continue
            deep_update(
                base, load_yaml(os.path.join(os.path.dirname(path), f"{d}.yaml"))
            )
        cfg = deep_update(base, cfg)
    return cfg


def load_task_config(
    task: str,
    cfg_override: Optional[Dict] = None,
    num_envs: Optional[int] = None,
    **overrides: Any,
) -> Dict:
    """Load cfg/task/<task>.yaml with overrides applied."""
    path = os.path.join(CFG_ROOT, "task", f"{task}.yaml")
    cfg = load_yaml(path)
    if cfg_override:
        deep_update(cfg, copy.deepcopy(cfg_override))
    if num_envs is not None:
        cfg["env"]["numEnvs"] = int(num_envs)
    for k, v in overrides.items():
        set_dotted(cfg, k, v)
    return cfg


def load_train_config(task: str, name: Optional[str] = None) -> Dict:
    """Load cfg/train/<task>PPO.yaml (the `${task}PPO` convention,
    ref: cfg/config.yaml:61-65)."""
    name = name or f"{task}PPO"
    path = os.path.join(CFG_ROOT, "train", f"{name}.yaml")
    return load_yaml(path)


def apply_cli_overrides(cfg: Dict, argv) -> Dict:
    """hydra-style `key.path=value` overrides (`+`/`++` prefixes tolerated)."""
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        set_dotted(cfg, k.lstrip("+"), _parse_value(v))
    return cfg


def asset_root() -> str:
    """Robot asset directory: the repo-root `assets/` (override with
    ISAACGYMENV_TPU_ASSET_ROOT)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.environ.get(
        "ISAACGYMENV_TPU_ASSET_ROOT", os.path.join(here, "assets")
    )
