"""Library entry point: `make(task, num_envs)` -> a ready-to-step TaskEnv.

Counterpart of `isaacgymenv_tpu/api.py:make`.  The env runs on the card
unless the caller asks for another device; without CUDA and without an
explicit device it raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when None.  Raises when CUDA is needed and absent.

    On CUDA it keeps fp32 matmuls and convolutions in full fp32 (no TF32):
    the physics runs on world coordinates and stays strict fp32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "isaacgymenv_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain version on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make(task: str = "Anymal", num_envs: int = 4096, device=None, cfg: Optional[dict] = None, **overrides: Any):
    """Create a vectorized task env on `device` (default "cuda")."""
    from isaacgymenv_tpu_torch.envs import registry
    from isaacgymenv_tpu_torch.utils.config import load_task_config

    dev = resolve_device(device)
    task_cfg = load_task_config(task, cfg_override=cfg, num_envs=num_envs, **overrides)
    return registry.get_task(task_cfg.get("name", task))(task_cfg, dev)
