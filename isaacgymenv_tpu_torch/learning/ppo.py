"""PPO on the device: rollout, GAE and minibatch updates with no host loop
over envs.

Counterpart of `isaacgymenv_tpu/learning/ppo.py` (rl_games a2c_continuous
semantics): clipped surrogate and clipped value loss, the bounds loss on mu,
a fixed-sigma gaussian policy, running obs and value normalization, the
global-norm gradient clip, Adam (eps 1e-8) and the adaptive-KL learning
rate.  Config keys are those of cfg/train/<Task>PPO.yaml.

The policy is the port's `ActorCritic`, applied functionally to the
parameters held in `TrainState.params`; Adam's moments live beside them, so
a state carries over from the JAX learner (`interop.train_state_from_jax`)
and checkpoints as plain tensors.  Random numbers come from the
`torch.Generator` in `TrainState.rng` (policy noise, minibatch permutations)
and in the env state; a test injects its own (`noise=`, `perms=`,
`reset_draws=`).  Nothing here moves a tensor to the host inside an epoch.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.func import functional_call

from isaacgymenv_tpu_torch.envs.base import EnvState, TaskEnv
from isaacgymenv_tpu_torch.learning.networks import ActorCritic, gaussian_entropy, gaussian_kl, gaussian_logp
from isaacgymenv_tpu_torch.learning.running_stats import RunningStats

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BOUNDS_SOFT = 1.1  # |mu| beyond this is penalized by the bounds loss
LOG_EVERY = 10  # epochs between console lines (and the last epoch)


@dataclass
class PPOConfig:
    gamma: float = 0.99
    tau: float = 0.95                 # GAE lambda
    e_clip: float = 0.2
    entropy_coef: float = 0.0
    critic_coef: float = 4.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    horizon_length: int = 16
    minibatch_size: int = 8192
    mini_epochs: int = 8
    learning_rate: float = 3e-4
    kl_threshold: float = 0.008
    lr_schedule: str = "adaptive"
    clip_value: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = False
    reward_scale: float = 1.0         # reward_shaper.scale_value
    max_epochs: int = 100

    @classmethod
    def from_train_cfg(cls, train_cfg: Dict[str, Any]) -> "PPOConfig":
        c = train_cfg["params"]["config"]
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            e_clip=float(c.get("e_clip", 0.2)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            critic_coef=float(c.get("critic_coef", 4.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 0.0) or 0.0),
            grad_norm=float(c.get("grad_norm", 1.0)),
            horizon_length=int(c.get("horizon_length", 16)),
            minibatch_size=int(c.get("minibatch_size", 8192)),
            mini_epochs=int(c.get("mini_epochs", 8)),
            learning_rate=float(c.get("learning_rate", 3e-4)),
            kl_threshold=float(c.get("kl_threshold", 0.008)),
            lr_schedule=str(c.get("lr_schedule", "adaptive")),
            clip_value=bool(c.get("clip_value", True)),
            normalize_input=bool(c.get("normalize_input", True)),
            normalize_value=bool(c.get("normalize_value", True)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            value_bootstrap=bool(c.get("value_bootstrap", False)),
            reward_scale=float(c.get("reward_shaper", {}).get("scale_value", 1.0)),
            max_epochs=int(c.get("max_epochs", 100)),
        )


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # the ActorCritic's parameters, by name
    opt_state: Dict[str, Any]         # Adam: {"mu": {name: t}, "nu": {name: t}, "count": int32 ()}
    obs_stats: RunningStats
    value_stats: RunningStats
    lr: torch.Tensor                  # () the adaptive learning rate
    env_state: Optional[EnvState]
    last_obs: Optional[torch.Tensor]
    rng: torch.Generator              # policy noise and minibatch permutations
    epoch: int
    ep_return: torch.Tensor           # (N,) running return of the current episodes
    ep_length: torch.Tensor
    mean_return: torch.Tensor         # count-weighted EMA of finished episodes' returns
    mean_length: torch.Tensor


def adam_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(), "count": torch.zeros((), dtype=torch.int32, device=device)}


class PPO:
    """PPO learner bound to a TaskEnv."""

    def __init__(self, env: TaskEnv, train_cfg: Dict[str, Any]):
        self.env = env
        p = train_cfg["params"]
        if p.get("config", {}).get("central_value_config") and getattr(env, "num_states", 0) > 0:
            raise NotImplementedError("the central value (asymmetric critic) is not ported (ROADMAP Queue A item 5)")
        if "rnn" in p.get("network", {}):
            raise NotImplementedError("the LSTM learner is not ported (ROADMAP Queue A item 6)")
        self.cfg = PPOConfig.from_train_cfg(train_cfg)
        self.train_cfg = train_cfg
        self.network = ActorCritic.from_train_config(train_cfg, env.num_obs, env.num_actions).to(env.device)
        self.device = env.device
        n_steps = self.cfg.horizon_length * env.num_envs
        if n_steps % self.cfg.minibatch_size:
            raise ValueError(f"batch {n_steps} not divisible by minibatch {self.cfg.minibatch_size}")
        self.num_minibatches = n_steps // self.cfg.minibatch_size

    # ------------------------------------------------------------------
    def init(self, seed: int, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: the env reset from `seed`, the policy drawn from
        `seed` (or `params`), fresh normalizers and Adam moments."""
        env_state = self.env.initial_state(seed=seed)
        obs = self.env.observations(env_state)["obs"]
        if params is None:
            net = ActorCritic.from_train_config(self.train_cfg, self.env.num_obs, self.env.num_actions)
            params = {k: v.to(self.device) for k, v in net.reference_init_(seed).state_dict().items()}
        n, dev = self.env.num_envs, self.device
        zero = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        return TrainState(
            params=params, opt_state=adam_init(params),
            obs_stats=RunningStats.create((self.env.num_obs,), device=dev),
            value_stats=RunningStats.create((), device=dev),
            lr=torch.tensor(self.cfg.learning_rate, device=dev),
            env_state=env_state, last_obs=obs,
            rng=torch.Generator(device=dev).manual_seed(seed + 1),
            epoch=0, ep_return=zero(n), ep_length=zero(n), mean_return=zero(), mean_length=zero(),
        )

    def apply(self, params: Dict[str, torch.Tensor], obs: torch.Tensor):
        """The policy on `params`: (mu, log_std, value normalized)."""
        return functional_call(self.network, params, (obs,))

    def _norm_obs(self, stats: RunningStats, obs):
        return stats.normalize(obs) if self.cfg.normalize_input else obs

    @staticmethod
    def _policy_noise(rng: torch.Generator, mu: torch.Tensor) -> torch.Tensor:
        """Standard normal exploration noise of mu's shape."""
        return torch.randn(mu.shape, generator=rng, device=mu.device)

    @staticmethod
    def _minibatch_perm(rng: torch.Generator, B: int, M: int) -> torch.Tensor:
        """(M, B // M) minibatch index partition of the flat (time-major) batch."""
        mb = B // M
        return torch.randperm(B, generator=rng, device=rng.device)[: M * mb].reshape(M, mb)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout(self, ts: TrainState, noise: Optional[List[torch.Tensor]] = None,
                 reset_draws: Optional[List[Dict[str, torch.Tensor]]] = None):
        """`horizon_length` acting steps.  Returns (ts', batch of (H, N, ...)
        tensors, env metrics of (H,) per step).  `noise[t]` (N, A) replaces
        the policy noise and `reset_draws[t]` the env's reset draws of step t."""
        cfg = self.cfg
        env_state, obs = ts.env_state, ts.last_obs
        ep_ret, ep_len, m_ret, m_len = ts.ep_return, ts.ep_length, ts.mean_return, ts.mean_length
        keys = ("obs", "action", "logp", "value", "reward", "done", "mu", "log_std")
        batch: Dict[str, list] = {k: [] for k in keys}
        metrics: Dict[str, list] = {}
        for t in range(cfg.horizon_length):
            mu, log_std, value_n = self.apply(ts.params, self._norm_obs(ts.obs_stats, obs))
            eps = noise[t] if noise is not None else self._policy_noise(ts.rng, mu)
            action = mu + torch.exp(log_std) * eps
            logp = gaussian_logp(mu, log_std, action)
            value = ts.value_stats.denormalize(value_n) if cfg.normalize_value else value_n
            env_state, obs_dict, rew_raw, done, extras = self.env.step(
                env_state, action, reset_draws=None if reset_draws is None else reset_draws[t])
            rew = rew_raw * cfg.reward_scale
            if cfg.value_bootstrap:  # the time-out bootstrap of a truncated episode
                rew = rew + cfg.gamma * value * extras["time_outs"].to(rew.dtype)
            # episode statistics of the unshaped reward; one 0.99 decay per
            # finished episode (rl_games' window of the last 100 episodes)
            ep_ret = ep_ret + rew_raw
            ep_len = ep_len + 1.0
            d = done.to(torch.float32)
            n_done = torch.clamp(d.sum(), min=1.0)
            a = torch.pow(torch.tensor(0.99, device=d.device), d.sum())
            m_ret = a * m_ret + (1.0 - a) * (ep_ret * d).sum() / n_done
            m_len = a * m_len + (1.0 - a) * (ep_len * d).sum() / n_done
            ep_ret, ep_len = ep_ret * (1.0 - d), ep_len * (1.0 - d)
            for k, v in zip(keys, (obs, action, logp, value, rew, done, mu, log_std)):
                batch[k].append(v)
            for k in ("true_objective", "consecutive_successes"):
                if k in extras:
                    metrics.setdefault(k, []).append(extras[k].to(torch.float32).mean())
            obs = obs_dict["obs"]
        ts = dataclasses.replace(ts, env_state=env_state, last_obs=obs, ep_return=ep_ret, ep_length=ep_len,
                                 mean_return=m_ret, mean_length=m_len)
        return ts, {k: torch.stack(v) for k, v in batch.items()}, {k: torch.stack(v) for k, v in metrics.items()}

    @torch.no_grad()
    def _gae(self, ts: TrainState, batch):
        """(advantages, returns), each (H, N)."""
        cfg = self.cfg
        _, _, v_last_n = self.apply(ts.params, self._norm_obs(ts.obs_stats, ts.last_obs))
        v_next = ts.value_stats.denormalize(v_last_n) if cfg.normalize_value else v_last_n
        adv_next = torch.zeros_like(v_next)
        advs = torch.empty_like(batch["value"])
        for t in reversed(range(batch["reward"].shape[0])):
            not_done = 1.0 - batch["done"][t].to(torch.float32)
            delta = batch["reward"][t] + cfg.gamma * v_next * not_done - batch["value"][t]
            adv_next = delta + cfg.gamma * cfg.tau * not_done * adv_next
            advs[t] = adv_next
            v_next = batch["value"][t]
        return advs, advs + batch["value"]

    def _loss(self, params, obs_stats: RunningStats, mb):
        cfg = self.cfg
        mu, log_std, value_n = self.apply(params, self._norm_obs(obs_stats, mb["obs"]))
        logp = gaussian_logp(mu, log_std, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        surr1 = mb["adv"] * ratio
        surr2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -torch.minimum(surr1, surr2).mean()
        if cfg.clip_value:
            v_clipped = mb["value_n"] + torch.clamp(value_n - mb["value_n"], -cfg.e_clip, cfg.e_clip)
            v_loss = torch.maximum((value_n - mb["ret_n"]) ** 2, (v_clipped - mb["ret_n"]) ** 2).mean()
        else:
            v_loss = ((value_n - mb["ret_n"]) ** 2).mean()
        entropy = gaussian_entropy(log_std).mean()
        b_loss = (torch.clamp(mu - BOUNDS_SOFT, min=0.0) ** 2 + torch.clamp(mu + BOUNDS_SOFT, max=0.0) ** 2).sum(-1).mean()
        loss = a_loss + 0.5 * cfg.critic_coef * v_loss - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss
        kl = gaussian_kl(mb["mu"], mb["log_std"], mu, log_std).mean()
        return loss, {"a_loss": a_loss, "v_loss": v_loss, "entropy": entropy, "kl": kl}

    def _adam_step(self, params, grads, opt, lr):
        """optax.chain(clip_by_global_norm(grad_norm), adam(lr, eps=1e-8)) on
        one minibatch's gradients; returns (params', opt')."""
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        keep = g_norm < self.cfg.grad_norm
        count = opt["count"] + 1
        c = count.to(torch.float32)
        bc1, bc2 = 1.0 - ADAM_B1 ** c, 1.0 - ADAM_B2 ** c
        new_p, mu_s, nu_s = {}, {}, {}
        for k, p in params.items():
            g = torch.where(keep, grads[k], grads[k] / g_norm * self.cfg.grad_norm)
            mu = (1.0 - ADAM_B1) * g + ADAM_B1 * opt["mu"][k]
            nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * opt["nu"][k]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            new_p[k], mu_s[k], nu_s[k] = p + update * -lr, mu, nu
        return new_p, {"mu": mu_s, "nu": nu_s, "count": count}

    def _update(self, ts: TrainState, batch, advs, returns, perms: Optional[torch.Tensor] = None):
        """`mini_epochs` passes of minibatch updates over the rollout.  `perms`
        (mini_epochs, M, mb) replaces the minibatch permutations."""
        cfg = self.cfg
        H, N = batch["reward"].shape[:2]
        B = H * N
        flat = {k: v.reshape((B,) + v.shape[2:]) for k, v in batch.items()}
        flat["adv"], flat["ret"] = advs.reshape(B), returns.reshape(B)
        obs_stats = ts.obs_stats.update(flat["obs"]) if cfg.normalize_input else ts.obs_stats
        value_stats = ts.value_stats.update(flat["ret"]) if cfg.normalize_value else ts.value_stats
        if cfg.normalize_advantage:
            a = flat["adv"]
            mean = a.mean()
            var = ((a - mean) ** 2).mean()
            flat["adv"] = (a - mean) / (torch.sqrt(var) + 1e-8)
        if cfg.normalize_value:
            flat["ret_n"] = value_stats.normalize(flat["ret"], clip=math.inf)
            flat["value_n"] = value_stats.normalize(flat["value"], clip=math.inf)
        else:
            flat["ret_n"], flat["value_n"] = flat["ret"], flat["value"]

        M = self.num_minibatches
        params, opt, lr = ts.params, ts.opt_state, ts.lr
        logs: Dict[str, list] = {k: [] for k in ("loss", "kl", "a_loss", "v_loss", "entropy")}
        for e in range(cfg.mini_epochs):
            perm = perms[e] if perms is not None else self._minibatch_perm(ts.rng, B, M)
            for idx in perm:
                mbd = {k: v[idx] for k, v in flat.items()}
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss, aux = self._loss(leaves, obs_stats, mbd)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                with torch.no_grad():
                    params, opt = self._adam_step(params, grads, opt, lr)
                    if cfg.lr_schedule == "adaptive":  # rl_games' AdaptiveScheduler
                        kl = aux["kl"]
                        lr = torch.where(kl > 2.0 * cfg.kl_threshold, lr / 1.5, lr)
                        lr = torch.where(kl < 0.5 * cfg.kl_threshold, lr * 1.5, lr)
                        lr = torch.clamp(lr, 1e-6, 1e-2)
                for k, v in (("loss", loss), *aux.items()):
                    logs[k].append(v.detach())
        ts = dataclasses.replace(ts, params=params, opt_state=opt, lr=lr, obs_stats=obs_stats,
                                 value_stats=value_stats, epoch=ts.epoch + 1)
        info = {k: torch.stack(v).mean() for k, v in logs.items()}
        info.update(lr=lr, mean_return=ts.mean_return, mean_length=ts.mean_length)
        return ts, info

    # ------------------------------------------------------------------
    def train_epoch(self, ts: TrainState):
        """One PPO epoch: rollout, GAE and the mini-epoch updates."""
        ts, batch, metrics = self._rollout(ts)
        advs, returns = self._gae(ts, batch)
        ts, info = self._update(ts, batch, advs, returns)
        info.update({k: v.mean() for k, v in metrics.items()})
        return ts, info

    def train(self, seed: int = 42, max_epochs: Optional[int] = None,
              callback: Optional[Callable] = None, init_ts: Optional[TrainState] = None) -> TrainState:
        ts = init_ts if init_ts is not None else self.init(seed)
        epochs = max_epochs or self.cfg.max_epochs
        steps_per_epoch = self.cfg.horizon_length * self.env.num_envs
        t_win, ep_win = time.time(), 0
        for ep in range(epochs):
            ts, info = self.train_epoch(ts)
            if callback is not None:
                callback(ep, ts, info)
            if ep % LOG_EVERY == 0 or ep == epochs - 1:
                vals = {k: float(v) for k, v in info.items()}  # one host read per logged epoch
                now = time.time()
                fps = steps_per_epoch * (ep + 1 - ep_win) / max(now - t_win, 1e-9)
                t_win, ep_win = now, ep + 1
                print(f"epoch {ep:5d} | return {vals['mean_return']:9.2f} | len {vals['mean_length']:6.1f} "
                      f"| kl {vals['kl']:.4f} | lr {vals['lr']:.2e} | fps_total {fps:,.0f}")
        return ts

    @torch.no_grad()
    def act(self, ts: TrainState, obs: torch.Tensor, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The policy's action: mu, or a gaussian sample from `generator`."""
        mu, log_std, _ = self.apply(ts.params, self._norm_obs(ts.obs_stats, obs))
        if deterministic or generator is None:
            return mu
        return mu + torch.exp(log_std) * torch.randn(mu.shape, generator=generator, device=mu.device)
