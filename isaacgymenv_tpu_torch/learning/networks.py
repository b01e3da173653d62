"""Actor-critic and central-value networks matching the rl_games builder.

Counterpart of `ActorCritic` and `CentralValueNet` in
`isaacgymenv_tpu/learning/networks.py`: an MLP trunk (`a_dense.{i}`) with ELU
activations, a linear mu head, a linear value head on the same trunk
(`separate: False`) and a state-independent log-std (`fixed_sigma: True`);
and the asymmetric critic, an MLP (`cv_dense.{i}`) over the env's privileged
`states` with a scalar head (`cv_value`).  The layers are `nn.Linear`; the
products are plain `torch` matmuls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

_ACT = {"elu": nn.ELU}  # the activation of the ported train configs


def _flax_dense_init_(layer: nn.Linear, orthogonal_gain=None) -> None:
    """A flax `Dense` draw into `layer`: a LeCun-normal kernel (truncated at
    two standard deviations) or, with a gain, an orthogonal one; zero bias."""
    w = torch.empty(layer.weight.shape[::-1])  # flax's (in, out) kernel
    if orthogonal_gain is not None:
        nn.init.orthogonal_(w, gain=orthogonal_gain)
    else:
        std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)
    layer.weight.copy_(w.t())
    layer.bias.zero_()


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

    def reference_init_(self, seed: int) -> "ActorCritic":
        """Re-draw the weights as the JAX package's flax layers draw theirs
        (from a torch seed, not the same numbers): LeCun-normal kernels
        (truncated at two standard deviations) and zero biases, the mu
        kernel orthogonal with gain 0.01, log_std at its initial value."""
        with torch.random.fork_rng(devices=[]), torch.no_grad():
            torch.manual_seed(seed)
            for layer in (*self.a_dense, self.mu, self.value):
                _flax_dense_init_(layer, 0.01 if layer is self.mu else None)
        return self

    def forward(self, obs: torch.Tensor):
        h = obs
        for layer in self.a_dense:
            h = self.act(layer(h))
        mu = self.mu(h)
        return mu, self.log_std.expand_as(mu), self.value(h)[..., 0]


class CentralValueNet(nn.Module):
    """The asymmetric critic: states -> value (normalized), an MLP with ELU
    activations and a scalar head."""

    def __init__(self, num_states: int, units: Sequence[int], activation: str):
        super().__init__()
        widths = [num_states, *units]
        self.cv_dense = nn.ModuleList(nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.act = _ACT[activation]()
        self.cv_value = nn.Linear(widths[-1], 1)

    @classmethod
    def from_train_config(cls, train_cfg: dict, num_states: int) -> "CentralValueNet":
        mlp = train_cfg["params"]["config"]["central_value_config"].get("network", {}).get("mlp", {})
        return cls(num_states, units=tuple(mlp.get("units", [512, 256, 128])), activation=mlp.get("activation", "elu"))

    def reference_init_(self, seed: int) -> "CentralValueNet":
        """Re-draw the weights as flax's `Dense` layers draw theirs (from a
        torch seed): LeCun-normal kernels, zero biases."""
        with torch.random.fork_rng(devices=[]), torch.no_grad():
            torch.manual_seed(seed)
            for layer in (*self.cv_dense, self.cv_value):
                _flax_dense_init_(layer)
        return self

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        h = states
        for layer in self.cv_dense:
            h = self.act(layer(h))
        return self.cv_value(h)[..., 0]


def gaussian_logp(mu, log_std, action):
    """Diagonal gaussian log-density, summed over the action axis."""
    var = torch.exp(2.0 * log_std)
    return (-0.5 * (action - mu) ** 2 / var - log_std - 0.5 * math.log(2.0 * math.pi)).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)


def gaussian_kl(mu0, log_std0, mu1, log_std1):
    """KL(old || new) of diagonal gaussians (the adaptive learning rate's metric)."""
    var0, var1 = torch.exp(2 * log_std0), torch.exp(2 * log_std1)
    return (log_std1 - log_std0 + (var0 + (mu0 - mu1) ** 2) / (2.0 * var1) - 0.5).sum(-1)
