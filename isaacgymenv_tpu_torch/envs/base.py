"""Vectorized env runtime: `EnvState` and the `TaskEnv` step contract.

Counterpart of `isaacgymenv_tpu/envs/base.py` with the deferred reset
timing of the flat tasks.  `step(actions)`: clip actions -> control ->
`control_freq_inv` x `engine.step` -> progress += 1 -> reset the envs flagged
done by the PREVIOUS step -> obs -> reward and new done flags ->
`time_outs` (progress >= max_len - 1 and done) -> clip obs.  The learner sees
the terminal obs with done=1, and the next step returns the first obs of the
new episode.

Random numbers: the reset draws and the per-step draws of the control (a
task's `sample_step_draws`, e.g. ShadowHand's goal-only resets) are
whole-batch arrays that a task samples from the `torch.Generator` in
`EnvState.rng`, or that the caller passes in (`reset_draws=`,
`step_draws=`), so a test can feed both packages the same numbers.
"""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.types import SimModel, SimState, make_zero_state


@dataclass
class EnvState:
    """Batched env-side state: the sim plus the runtime buffers."""

    sim: SimState
    progress: torch.Tensor   # (N,) int32 steps since episode start
    reset: torch.Tensor      # (N,) bool done flags of the last step
    rng: torch.Generator     # draws of resets and of the per-step control
    ts: Dict[str, torch.Tensor]  # task state (commands, last actions, ...)


class TaskEnv(abc.ABC):
    """Base class of the tasks; subclasses implement the hooks below."""

    model: SimModel
    terrain: Any = None
    num_obs: int
    num_actions: int

    def __init__(self, cfg: Dict[str, Any], device):
        self.cfg = cfg
        self.device = torch.device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("maxEpisodeLength", 500))
        self.clip_obs = float(env_cfg.get("clipObservations", np.inf))
        self.clip_actions = float(env_cfg.get("clipActions", np.inf))
        sim_cfg = cfg.get("sim", {})
        self.dt = float(sim_cfg.get("dt", 1.0 / 60.0))
        self.substeps = int(sim_cfg.get("substeps", 2))
        self.control_freq_inv = int(env_cfg.get("controlFrequencyInv", 1))
        self.gravity = tuple(sim_cfg.get("gravity", (0.0, 0.0, -9.81)))
        if cfg.get("task", {}).get("randomize", False):
            raise NotImplementedError("domain randomization is not ported")

    # ------------------------------------------------------------------ hooks
    @abc.abstractmethod
    def sample_reset_draws(self, rng: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        """Whole-batch random draws one reset consumes (masked afterwards)."""

    @abc.abstractmethod
    def _reset_envs(self, state: EnvState, mask: torch.Tensor, draws: Dict[str, torch.Tensor]) -> EnvState:
        """Re-initialize the envs where mask is True from `draws`."""

    def sample_step_draws(self, rng: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        """Whole-batch random draws one control step consumes (none by default)."""
        return {}

    @abc.abstractmethod
    def _make_control(self, state: EnvState, actions: torch.Tensor, draws: Dict[str, torch.Tensor]):
        """Map clipped actions to actuation: (Control, EnvState), the state
        carrying whatever the task keeps of its actions."""

    @abc.abstractmethod
    def _observations(self, state: EnvState, actions: torch.Tensor) -> torch.Tensor:
        """(N, num_obs) observations."""

    @abc.abstractmethod
    def _reward_done(self, state: EnvState, obs, actions) -> Tuple[EnvState, torch.Tensor, torch.Tensor, Dict]:
        """(state', reward (N,), done (N,) bool, info)."""

    def _post_physics(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        return state

    def _initial_ts(self) -> Dict[str, torch.Tensor]:
        return {}

    # ------------------------------------------------------------------ API
    def initial_state(self, seed: int = 0, reset_draws: Optional[Dict[str, torch.Tensor]] = None) -> EnvState:
        """All envs reset; `reset_draws` overrides the draws from the seed."""
        rng = torch.Generator(device=self.device).manual_seed(seed)
        n = self.num_envs
        state = EnvState(
            sim=make_zero_state(self.model, n),
            progress=torch.zeros(n, dtype=torch.int32, device=self.device),
            reset=torch.zeros(n, dtype=torch.bool, device=self.device),
            rng=rng,
            ts=self._initial_ts(),
        )
        draws = self.sample_reset_draws(rng, n) if reset_draws is None else reset_draws
        state = self._reset_envs(state, torch.ones(n, dtype=torch.bool, device=self.device), draws)
        return dataclasses.replace(state, sim=engine.forward(self.model, self.terrain, state.sim))

    def step(
        self, state: EnvState, actions: torch.Tensor,
        reset_draws: Optional[Dict[str, torch.Tensor]] = None,
        step_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[EnvState, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, Dict]:
        """One env step.  Returns (state', obs_dict, rew, done, extras)."""
        actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)
        draws = self.sample_step_draws(state.rng, self.num_envs) if step_draws is None else step_draws
        ctrl, state = self._make_control(state, actions, draws)
        sim = state.sim
        for _ in range(self.control_freq_inv):
            sim = engine.step(self.model, self.terrain, sim, ctrl, self.dt, self.substeps)
        state = dataclasses.replace(state, sim=sim, progress=state.progress + 1)
        state = self._post_physics(state, actions)

        # deferred reset of the envs flagged done by the previous step
        draws = self.sample_reset_draws(state.rng, self.num_envs) if reset_draws is None else reset_draws
        state = self._reset_envs(state, state.reset, draws)
        state = dataclasses.replace(state, sim=engine.forward(self.model, self.terrain, state.sim))
        obs = self._observations(state, actions)
        state, rew, done, info = self._reward_done(state, obs, actions)
        timeout = (state.progress >= self.max_episode_length - 1) & done
        state = dataclasses.replace(state, reset=done)

        obs = torch.clamp(obs, -self.clip_obs, self.clip_obs)
        return state, {"obs": obs}, rew, done, {"time_outs": timeout, **info}
