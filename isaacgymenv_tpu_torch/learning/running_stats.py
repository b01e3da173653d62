"""Running mean/std normalizer (rl_games RunningMeanStd semantics).

Counterpart of `isaacgymenv_tpu/learning/running_stats.py`: a parallel
(Welford-style) variance merge per batch, clamped normalized output.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RunningStats:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, shape, device=None) -> "RunningStats":
        """Fresh stats on `device` (default "cuda"; raises without CUDA)."""
        from isaacgymenv_tpu_torch.api import resolve_device

        device = resolve_device(device)
        return cls(
            mean=torch.zeros(shape, device=device),
            var=torch.ones(shape, device=device),
            count=torch.tensor(1e-4, device=device),
        )

    def update(self, batch: torch.Tensor) -> "RunningStats":
        """Merge the moments of batch (B, *shape)."""
        b_mean = batch.mean(0)
        b_var = batch.var(0, unbiased=False)
        b_count = float(batch.shape[0])
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = self.var * self.count + b_var * b_count + delta**2 * self.count * b_count / tot
        return RunningStats(mean=self.mean + delta * b_count / tot, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + 1e-5), -clip, clip)
