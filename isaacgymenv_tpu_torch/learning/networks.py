"""Actor-critic network matching the rl_games builder (shared trunk).

Counterpart of `ActorCritic` in `isaacgymenv_tpu/learning/networks.py`: an
MLP trunk (`a_dense.{i}`) with ELU activations, a linear mu head, a linear
value head on the same trunk (`separate: False`) and a state-independent
log-std (`fixed_sigma: True`).  The layers are `nn.Linear`; the products are
plain `torch` matmuls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

_ACT = {"elu": nn.ELU}  # the activation of the ported train configs


class ActorCritic(nn.Module):
    """Shared-trunk gaussian actor + value head: obs -> (mu, log_std, value)."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (256, 128, 64),
                 activation: str = "elu", sigma_init: float = 0.0):
        super().__init__()
        widths = [num_obs, *units]
        self.a_dense = nn.ModuleList(nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.act = _ACT[activation]()
        self.mu = nn.Linear(widths[-1], num_actions)
        self.value = nn.Linear(widths[-1], 1)
        self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))

    @classmethod
    def from_train_config(cls, train_cfg: dict, num_obs: int, num_actions: int) -> "ActorCritic":
        net = train_cfg["params"]["network"]
        if net.get("separate", False) or not net["space"]["continuous"].get("fixed_sigma", True):
            raise NotImplementedError("only the shared-trunk fixed-sigma network is ported")
        return cls(
            num_obs, num_actions, units=tuple(net["mlp"]["units"]),
            activation=net["mlp"]["activation"],
            sigma_init=float(net["space"]["continuous"].get("sigma_init", 0.0)),
        )

    def forward(self, obs: torch.Tensor):
        h = obs
        for layer in self.a_dense:
            h = self.act(layer(h))
        mu = self.mu(h)
        return mu, self.log_std.expand_as(mu), self.value(h)[..., 0]
