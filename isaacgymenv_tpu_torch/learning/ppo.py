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
`cv_perms=`, `reset_draws=`).  Nothing here moves a tensor to the host
inside an epoch.

Asymmetric actor-critic (a `central_value_config` and an env with
`num_states` > 0, ShadowHandOpenAI_FF): the values of the rollout, of the
GAE bootstrap and of the time-out bootstrap come from a `CentralValueNet` on
the env's normalized `states`; the actor's loss drops its value term (its
value head gets no gradient); the central value is fitted after the actor's
mini-epochs by its own minibatch passes (`cv_mini_epochs`, the actor's
minibatch count), its own Adam at the central-value learning rate (constant)
after the same global-norm clip, to the clipped value loss.
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
from isaacgymenv_tpu_torch.learning.networks import (
    ActorCritic,
    CentralValueNet,
    gaussian_entropy,
    gaussian_kl,
    gaussian_logp,
)
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
class CVState:
    """The asymmetric critic's part of a train state."""
    params: Dict[str, torch.Tensor]   # the CentralValueNet's parameters, by name
    opt_state: Dict[str, Any]         # its Adam state, as TrainState.opt_state
    stats: RunningStats               # the running normalizer of the states
    last_states: Optional[torch.Tensor]


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
    cv: Optional[CVState] = None      # None without a central value


def adam_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(), "count": torch.zeros((), dtype=torch.int32, device=device)}


class PPO:
    """PPO learner bound to a TaskEnv."""

    def __init__(self, env: TaskEnv, train_cfg: Dict[str, Any]):
        self.env = env
        p = train_cfg["params"]
        if "rnn" in p.get("network", {}):
            raise NotImplementedError("the LSTM learner is not ported (ROADMAP Queue A item 6)")
        self.cfg = PPOConfig.from_train_cfg(train_cfg)
        self.train_cfg = train_cfg
        self.network = ActorCritic.from_train_config(train_cfg, env.num_obs, env.num_actions).to(env.device)
        self.device = env.device
        cv_cfg = p.get("config", {}).get("central_value_config")
        self.central_value = bool(cv_cfg) and getattr(env, "num_states", 0) > 0
        if self.central_value:
            self.cv_network = CentralValueNet.from_train_config(train_cfg, env.num_states).to(env.device)
            self.cv_mini_epochs = int(cv_cfg.get("mini_epochs", self.cfg.mini_epochs))
            self.cv_lr = float(cv_cfg.get("learning_rate", 1e-4))
        n_steps = self.cfg.horizon_length * env.num_envs
        if n_steps % self.cfg.minibatch_size:
            raise ValueError(f"batch {n_steps} not divisible by minibatch {self.cfg.minibatch_size}")
        self.num_minibatches = n_steps // self.cfg.minibatch_size

    # ------------------------------------------------------------------
    def init(self, seed: int, params: Optional[Dict[str, torch.Tensor]] = None,
             cv_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: the env reset from `seed`, the policy (and the
        central value) drawn from `seed` (or `params`, `cv_params`), fresh
        normalizers and Adam moments."""
        env_state = self.env.initial_state(seed=seed)
        obs_dict = self.env.observations(env_state)
        obs = obs_dict["obs"]
        if params is None:
            net = ActorCritic.from_train_config(self.train_cfg, self.env.num_obs, self.env.num_actions)
            params = {k: v.to(self.device) for k, v in net.reference_init_(seed).state_dict().items()}
        n, dev = self.env.num_envs, self.device
        zero = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        cv = None
        if self.central_value:
            if cv_params is None:
                net = CentralValueNet.from_train_config(self.train_cfg, self.env.num_states)
                cv_params = {k: v.to(dev) for k, v in net.reference_init_(seed + 1).state_dict().items()}
            cv = CVState(params=cv_params, opt_state=adam_init(cv_params), last_states=obs_dict["states"],
                         stats=RunningStats.create((self.env.num_states,), device=dev))
        return TrainState(
            params=params, opt_state=adam_init(params),
            obs_stats=RunningStats.create((self.env.num_obs,), device=dev),
            value_stats=RunningStats.create((), device=dev),
            lr=torch.tensor(self.cfg.learning_rate, device=dev),
            env_state=env_state, last_obs=obs,
            rng=torch.Generator(device=dev).manual_seed(seed + 1),
            epoch=0, ep_return=zero(n), ep_length=zero(n), mean_return=zero(), mean_length=zero(), cv=cv,
        )

    def apply(self, params: Dict[str, torch.Tensor], obs: torch.Tensor):
        """The policy on `params`: (mu, log_std, value normalized)."""
        return functional_call(self.network, params, (obs,))

    def apply_cv(self, cv: CVState, states: torch.Tensor, params: Optional[Dict[str, torch.Tensor]] = None):
        """The central value on `params` (default `cv.params`) of the raw
        `states`, normalized by `cv.stats`: the value normalized."""
        return functional_call(self.cv_network, cv.params if params is None else params,
                               (self._norm_obs(cv.stats, states),))

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
        states = ts.cv.last_states if ts.cv is not None else None
        ep_ret, ep_len, m_ret, m_len = ts.ep_return, ts.ep_length, ts.mean_return, ts.mean_length
        keys = ("obs", "action", "logp", "value", "reward", "done", "mu", "log_std")
        batch: Dict[str, list] = {k: [] for k in keys + (("states",) if self.central_value else ())}
        metrics: Dict[str, list] = {}
        for t in range(cfg.horizon_length):
            mu, log_std, value_n = self.apply(ts.params, self._norm_obs(ts.obs_stats, obs))
            if self.central_value:
                value_n = self.apply_cv(ts.cv, states)
                batch["states"].append(states)
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
            # the env's metrics, JAX `PPO._metric_rollout_outputs`: its
            # extras["episode"] terms, then the two success channels
            for k, v in extras.get("episode", {}).items():
                metrics.setdefault(f"episode/{k}", []).append(torch.as_tensor(v, dtype=torch.float32))
            for k in ("true_objective", "consecutive_successes"):
                if k in extras:
                    metrics.setdefault(k, []).append(extras[k].to(torch.float32).mean())
            obs = obs_dict["obs"]
            states = obs_dict["states"] if self.central_value else None
        cv = None if ts.cv is None else dataclasses.replace(ts.cv, last_states=states)
        ts = dataclasses.replace(ts, env_state=env_state, last_obs=obs, cv=cv, ep_return=ep_ret,
                                 ep_length=ep_len, mean_return=m_ret, mean_length=m_len)
        return ts, {k: torch.stack(v) for k, v in batch.items()}, {k: torch.stack(v) for k, v in metrics.items()}

    @torch.no_grad()
    def _gae(self, ts: TrainState, batch):
        """(advantages, returns), each (H, N)."""
        cfg = self.cfg
        if self.central_value:
            v_last_n = self.apply_cv(ts.cv, ts.cv.last_states)
        else:
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

    def _value_loss(self, value_n, mb):
        """The (clipped) value loss against the normalized returns."""
        cfg = self.cfg
        if cfg.clip_value:
            v_clipped = mb["value_n"] + torch.clamp(value_n - mb["value_n"], -cfg.e_clip, cfg.e_clip)
            return torch.maximum((value_n - mb["ret_n"]) ** 2, (v_clipped - mb["ret_n"]) ** 2).mean()
        return ((value_n - mb["ret_n"]) ** 2).mean()

    def _loss(self, params, obs_stats: RunningStats, mb):
        cfg = self.cfg
        mu, log_std, value_n = self.apply(params, self._norm_obs(obs_stats, mb["obs"]))
        logp = gaussian_logp(mu, log_std, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        surr1 = mb["adv"] * ratio
        surr2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -torch.minimum(surr1, surr2).mean()
        # with a central value the actor's value head is unused
        v_loss = torch.zeros((), device=mu.device) if self.central_value else self._value_loss(value_n, mb)
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

    @staticmethod
    def _grads(loss_fn, params):
        """d loss / d params by name; zeros for a parameter the loss does not use."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out = loss_fn(leaves)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return out, {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}

    def _update(self, ts: TrainState, batch, advs, returns, perms: Optional[torch.Tensor] = None,
                cv_perms: Optional[torch.Tensor] = None):
        """`mini_epochs` passes of minibatch updates over the rollout, then,
        with a central value, `cv_mini_epochs` passes of its own.  `perms`
        (mini_epochs, M, mb) and `cv_perms` (cv_mini_epochs, M, mb) replace
        the minibatch permutations."""
        cfg = self.cfg
        H, N = batch["reward"].shape[:2]
        B = H * N
        flat = {k: v.reshape((B,) + v.shape[2:]) for k, v in batch.items()}
        flat["adv"], flat["ret"] = advs.reshape(B), returns.reshape(B)
        obs_stats = ts.obs_stats.update(flat["obs"]) if cfg.normalize_input else ts.obs_stats
        value_stats = ts.value_stats.update(flat["ret"]) if cfg.normalize_value else ts.value_stats
        cv = ts.cv
        if self.central_value and cfg.normalize_input:
            cv = dataclasses.replace(cv, stats=cv.stats.update(flat["states"]))
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
                (loss, aux), grads = self._grads(lambda p: self._loss(p, obs_stats, mbd), params)
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
        if self.central_value:
            cv_params, cv_opt, cv_losses = cv.params, cv.opt_state, []
            for e in range(self.cv_mini_epochs):
                perm = cv_perms[e] if cv_perms is not None else self._minibatch_perm(ts.rng, B, M)
                for idx in perm:
                    mbd = {k: flat[k][idx] for k in ("states", "value_n", "ret_n")}
                    vl, grads = self._grads(
                        lambda p: self._value_loss(self.apply_cv(cv, mbd["states"], params=p), mbd), cv_params)
                    with torch.no_grad():
                        cv_params, cv_opt = self._adam_step(cv_params, grads, cv_opt, self.cv_lr)
                    cv_losses.append(vl.detach())
            logs["v_loss"] = cv_losses
            ts = dataclasses.replace(ts, cv=dataclasses.replace(cv, params=cv_params, opt_state=cv_opt))
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
