"""Training observers: the per-epoch metrics as scalars in a CSV file.

Counterpart of `isaacgymenv_tpu/utils/observers.py`.  TensorBoard and
Weights & Biases are not ported (ROADMAP Queue A item 1); the CSV file is
the JAX package's TensorBoard fallback, `runs/<experiment>/summaries/
metrics.csv`, one (frames, name, value) row per scalar.  The console line
is `PPO.train`'s.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict


def _scalars(info: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """Flatten an info dict (nested dicts as `a/b`) to floats; entries that
    are not one number are left out."""
    out = {}
    for k, v in info.items():
        if isinstance(v, dict):
            out.update(_scalars(v, f"{prefix}{k}/"))
            continue
        try:
            out[f"{prefix}{k}"] = float(v)
        except (TypeError, ValueError, RuntimeError):
            pass
    return out


class CSVObserver:
    """Every scalar of each epoch's info as a (frames, name, value) row."""

    def __init__(self, run_dir: str):
        self.dir = os.path.join(run_dir, "summaries")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._file = open(self.path, "a", newline="")
        self._writer = csv.writer(self._file)

    def after_epoch(self, epoch: int, frames: int, scalars: Dict[str, float]) -> None:
        for k, v in scalars.items():
            self._writer.writerow([frames, k, v])
        self._file.flush()

    def close(self) -> None:
        self._file.close()

