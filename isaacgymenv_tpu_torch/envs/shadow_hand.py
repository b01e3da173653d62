"""ShadowHand: in-hand reorientation of a cube to a random goal orientation.

Counterpart of `isaacgymenv_tpu/envs/shadow_hand.py`:
- the OpenAI shadow hand MJCF (24 dofs, 20 position actuators, 4 distal dofs
  coupled by fixed tendons) fixed palm up at (0, 0, 0.5), and a free 5 cm cube
  (cube_multicolor.urdf, density 567) dropped 0.10 m above the palm; 256
  sphere-surface contact pairs between the two; no ground pass (`no_ground`);
- act (N, 20): absolute position targets scaled to the actuated dofs' limits
  with a moving average, or relative targets (dofSpeedScale);
- obs (N, 211), `full_state`: unscaled dof pos, 0.2 dof vel, 10 dof force,
  object pose and velocities, goal pose, their quaternion difference, the
  fingertip states and 10 x the fingertip contact wrenches, the actions;
- reward: distance and rotation-distance terms plus an action penalty;
  +reachGoalBonus when the rotation distance is within the tolerance, which
  also resamples the goal at the next step without an env reset;
- done: the cube falls further than fallDistance from the goal, or timeout;
- reset: object position noise and a random rotation, dofs at
  noise * U(lower, upper), targets snapped to them, a new goal.
The random object forces (forceScale > 0) need body wrenches, which the port
does not have yet.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from isaacgymenv_tpu_torch.envs.base import EnvState, TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses
from isaacgymenv_tpu_torch.physics.mjcf import MJCFOptions, load_mjcf
from isaacgymenv_tpu_torch.physics.types import (
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)
from isaacgymenv_tpu_torch.physics.urdf import AssetOptions, load_urdf
from isaacgymenv_tpu_torch.utils.config import asset_root


@register("ShadowHand")
class ShadowHand(TaskEnv):
    num_actions = 20
    num_obs = 211

    hand_asset = "mjcf/open_ai_assets/hand/shadow_hand.xml"
    fingertips = (
        "robot0:ffdistal", "robot0:mfdistal", "robot0:rfdistal",
        "robot0:lfdistal", "robot0:thdistal",
    )
    hand_start = (0.0, 0.0, 0.5)
    object_offset = (0.0, -0.39, 0.10)  # relative to the hand

    def __init__(self, cfg, device):
        e = cfg["env"]
        e.setdefault("maxEpisodeLength", int(e.get("episodeLength", 600)))
        super().__init__(cfg, device)
        if e.get("observationType", "full_state") != "full_state" or e.get("asymmetric_observations", False):
            raise NotImplementedError("only the full_state observation without asymmetric states is ported")
        if float(e.get("forceScale", 0.0)) > 0.0:
            raise NotImplementedError("random object forces (forceScale > 0) need body wrenches, not ported yet")
        if e.get("objectType", "block") != "block":
            raise NotImplementedError(f"only the block object is ported (got {e.get('objectType')})")

        self.dist_reward_scale = float(e.get("distRewardScale", -10.0))
        self.rot_reward_scale = float(e.get("rotRewardScale", 1.0))
        self.action_penalty_scale = float(e.get("actionPenaltyScale", -0.0002))
        self.success_tolerance = float(e.get("successTolerance", 0.1))
        self.reach_goal_bonus = float(e.get("reachGoalBonus", 250.0))
        self.fall_dist = float(e.get("fallDistance", 0.24))
        self.fall_penalty = float(e.get("fallPenalty", 0.0))
        self.rot_eps = float(e.get("rotEps", 0.1))
        self.max_consecutive_successes = int(e.get("maxConsecutiveSuccesses", 0))
        self.av_factor = float(e.get("averFactor", 0.1))
        self.reset_position_noise = float(e.get("resetPositionNoise", 0.01))
        self.reset_dof_pos_noise = float(e.get("resetDofPosRandomInterval", 0.2))
        self.reset_dof_vel_noise = float(e.get("resetDofVelRandomInterval", 0.0))
        self.use_relative_control = bool(e.get("useRelativeControl", False))
        self.dof_speed_scale = float(e.get("dofSpeedScale", 20.0))
        self.act_moving_average = float(e.get("actionsMovingAverage", 1.0))
        self.force_prob_range = tuple(float(x) for x in e.get("forceProbRange", [0.001, 0.1]))
        self.vel_obs_scale = 0.2
        self.ft_obs_scale = 10.0

        self._build_model()

    def _build_model(self):
        mb, info = load_mjcf(
            os.path.join(asset_root(), self.hand_asset),
            MJCFOptions(fix_base_link=True, base_pos=self.hand_start),
        )
        ob, _ = load_urdf(os.path.join(asset_root(), "urdf/objects/cube_multicolor.urdf"), AssetOptions(density=567.0))
        mb.merge(ob)
        mb.gravity = np.array(self.gravity)
        # the hand is mounted 0.5 m up and the fall reset fires long before a
        # geom could reach the plane z = 0: no ground pass
        mb.no_ground = True
        self.model = attach_effective_masses(mb.finalize()).to(self.device)
        self._info = info
        names = self.model.body_names
        self.fingertip_bodies = [names.index(f) for f in self.fingertips]
        self.object_actor = 1
        self.object_body = self.model.actor_root[1]
        # actuated dofs in actuator order
        self.actuated = [self.model.dof_names.index(j) for j, _, _ in info["position_actuators"]]
        self.dof_lower, self.dof_upper = self.model.dof_lower, self.model.dof_upper
        f32 = dict(dtype=torch.float32, device=self.device)
        self.object_init = torch.tensor(
            list(np.add(self.hand_start, self.object_offset)) + [0, 0, 0, 1] + [0.0] * 6, **f32
        )
        self.goal_pos = self.object_init[0:3] - torch.tensor([0.0, 0.0, 0.04], **f32)

    # ------------------------------------------------------------------
    def _initial_ts(self):
        n, f32 = self.num_envs, dict(dtype=torch.float32, device=self.device)
        goal = torch.zeros((n, 4), **f32)
        goal[:, 3] = 1.0
        return {
            "cur_targets": torch.zeros((n, self.model.nd), **f32),
            "goal_rot": goal,
            "actions": torch.zeros((n, self.num_actions), **f32),
            "successes": torch.zeros(n, **f32),
            "consecutive_successes": torch.zeros((), **f32),
            "reset_goal": torch.zeros(n, dtype=torch.bool, device=self.device),
            "rb_force": torch.zeros((n, 3), **f32),
            "force_prob": torch.full((n,), 0.01, **f32),
        }

    def _uniform(self, rng, lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=rng, device=self.device)

    def sample_reset_draws(self, rng, n):
        """U(-1, 1): obj_pos (n, 3), obj_rot and goal (n, 2) angle pairs,
        dof_pos and dof_vel (n, nd); U(0, 1): force_prob (n,)."""
        nd = self.model.nd
        return {
            "obj_pos": self._uniform(rng, -1.0, 1.0, (n, 3)),
            "obj_rot": self._uniform(rng, -1.0, 1.0, (n, 2)),
            "goal": self._uniform(rng, -1.0, 1.0, (n, 2)),
            "dof_pos": self._uniform(rng, -1.0, 1.0, (n, nd)),
            "dof_vel": self._uniform(rng, -1.0, 1.0, (n, nd)),
            "force_prob": self._uniform(rng, 0.0, 1.0, (n,)),
        }

    def sample_step_draws(self, rng, n):
        """goal (n, 2) ~ U(-1, 1): the angle pair of a goal-only reset."""
        return {"goal": self._uniform(rng, -1.0, 1.0, (n, 2))}

    def _random_quat(self, r):
        """Rotation by pi * r[:, 0] about x, then pi * r[:, 1] about y."""
        x_unit = torch.tensor([1.0, 0.0, 0.0], device=self.device).expand(r.shape[0], 3)
        y_unit = torch.tensor([0.0, 1.0, 0.0], device=self.device).expand(r.shape[0], 3)
        return maths.quat_mul(
            maths.quat_from_angle_axis(r[:, 0] * math.pi, x_unit),
            maths.quat_from_angle_axis(r[:, 1] * math.pi, y_unit),
        )

    def _reset_envs(self, state, mask, draws):
        m = self.model
        mm = mask[:, None]
        ts = dict(state.ts)
        ts["goal_rot"] = torch.where(mm, self._random_quat(draws["goal"]), ts["goal_rot"])
        ts["reset_goal"] = torch.where(mask, torch.zeros_like(mask), ts["reset_goal"])

        rs = root_state(m, state.sim)
        obj = self.object_init.expand(mask.shape[0], 13).clone()
        obj[:, 0:3] += self.reset_position_noise * draws["obj_pos"]
        obj[:, 3:7] = self._random_quat(draws["obj_rot"])
        new_rs = rs.clone()
        new_rs[:, self.object_actor] = torch.where(mm, obj, rs[:, self.object_actor])
        sim = set_root_state(m, state.sim, new_rs)

        rand_delta = self.dof_lower + (self.dof_upper - self.dof_lower) * 0.5 * (draws["dof_pos"] + 1.0)
        pos = self.reset_dof_pos_noise * rand_delta
        vel = self.reset_dof_vel_noise * draws["dof_vel"]
        sim = set_dof_state(
            m, sim, torch.where(mm, pos, dof_pos(m, sim)), torch.where(mm, vel, dof_vel(m, sim))
        )
        ts["cur_targets"] = torch.where(mm, pos, ts["cur_targets"])
        ts["successes"] = torch.where(mask, torch.zeros_like(ts["successes"]), ts["successes"])
        ts["rb_force"] = torch.where(mm, torch.zeros_like(ts["rb_force"]), ts["rb_force"])
        lo, hi = torch.log(torch.tensor(self.force_prob_range, device=self.device))
        force_prob = torch.exp((lo - hi) * draws["force_prob"] + hi)
        ts["force_prob"] = torch.where(mask, force_prob, ts["force_prob"])
        progress = torch.where(mask, torch.zeros_like(state.progress), state.progress)
        return dataclasses.replace(state, sim=sim, progress=progress, ts=ts)

    # ------------------------------------------------------------------
    def _make_control(self, state, actions, draws):
        ts = dict(state.ts)
        # goal-only resets flagged by the previous step
        ts["goal_rot"] = torch.where(ts["reset_goal"][:, None], self._random_quat(draws["goal"]), ts["goal_rot"])
        ts["reset_goal"] = torch.zeros_like(ts["reset_goal"])

        lo, hi = self.dof_lower[self.actuated], self.dof_upper[self.actuated]
        prev = ts["cur_targets"][:, self.actuated]
        if self.use_relative_control:
            tgt = torch.clamp(prev + self.dof_speed_scale * self.dt * actions, lo, hi)
        else:
            tgt = maths.scale(actions, lo, hi)
            tgt = self.act_moving_average * tgt + (1.0 - self.act_moving_average) * prev
            tgt = torch.clamp(tgt, lo, hi)
        cur = ts["cur_targets"].clone()
        cur[:, self.actuated] = tgt
        ts["cur_targets"] = cur
        ts["actions"] = actions
        ctrl = dataclasses.replace(engine.Control.zero(self.model, actions.shape[0]), pos_target=cur)
        return ctrl, dataclasses.replace(state, ts=ts)

    # ------------------------------------------------------------------
    def _object_state(self, state):
        rs = root_state(self.model, state.sim)[:, self.object_actor]
        return rs[:, 0:3], rs[:, 3:7], rs[:, 7:10], rs[:, 10:13]

    def _observations(self, state, actions):
        m, sim, ts = self.model, state.sim, state.ts
        n = sim.q.shape[0]
        obj_pos, obj_rot, obj_linvel, obj_angvel = self._object_state(state)
        goal_rot = ts["goal_rot"]
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        ft = self.fingertip_bodies
        ft_state = torch.cat([sim.body_pos[:, ft], sim.body_quat[:, ft], sim.body_linvel[:, ft],
                              sim.body_angvel[:, ft]], dim=-1)  # (N, 5, 13)
        # fingertip force-torque sensors as the fingertips' net contact wrench
        ft_wrench = torch.cat([sim.contact_force[:, ft], sim.contact_torque[:, ft]], dim=-1)  # (N, 5, 6)
        return torch.cat(
            [
                maths.unscale(dof_pos(m, sim), self.dof_lower, self.dof_upper),
                self.vel_obs_scale * dof_vel(m, sim),
                self.ft_obs_scale * sim.dof_force,
                obj_pos, obj_rot, obj_linvel, self.vel_obs_scale * obj_angvel,
                self.goal_pos.expand(n, 3), goal_rot, quat_diff,
                ft_state.reshape(n, 65),
                self.ft_obs_scale * ft_wrench.reshape(n, 30),
                ts["actions"],
            ],
            dim=-1,
        )

    def _reward_done(self, state: EnvState, obs, actions):
        ts = dict(state.ts)
        obj_pos, obj_rot, _, _ = self._object_state(state)
        goal_dist = torch.linalg.norm(obj_pos - self.goal_pos, dim=-1)
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(ts["goal_rot"]))
        rot_dist = 2.0 * torch.arcsin(torch.clamp(torch.linalg.norm(quat_diff[:, 0:3], dim=-1), 0.0, 1.0))

        reward = (
            goal_dist * self.dist_reward_scale
            + 1.0 / (torch.abs(rot_dist) + self.rot_eps) * self.rot_reward_scale
            + torch.sum(actions ** 2, dim=-1) * self.action_penalty_scale
        )
        goal_resets = torch.abs(rot_dist) <= self.success_tolerance
        successes = ts["successes"] + goal_resets.to(torch.float32)
        reward = torch.where(goal_resets, reward + self.reach_goal_bonus, reward)
        fell = goal_dist >= self.fall_dist
        reward = torch.where(fell, reward + self.fall_penalty, reward)

        resets = fell
        progress = state.progress
        if self.max_consecutive_successes > 0:
            progress = torch.where(goal_resets, torch.zeros_like(progress), progress)
            resets = resets | (successes >= self.max_consecutive_successes)
        timeout = progress >= self.max_episode_length - 1
        resets = resets | timeout
        if self.max_consecutive_successes > 0:
            reward = torch.where(timeout, reward + 0.5 * self.fall_penalty, reward)

        num_resets = resets.sum()
        finished = (successes * resets).sum()
        cons = torch.where(
            num_resets > 0,
            self.av_factor * finished / torch.clamp(num_resets, min=1)
            + (1.0 - self.av_factor) * ts["consecutive_successes"],
            ts["consecutive_successes"],
        )
        ts["successes"] = successes
        ts["consecutive_successes"] = cons
        ts["reset_goal"] = goal_resets
        state = dataclasses.replace(state, ts=ts, progress=progress)
        return state, reward, resets, {"consecutive_successes": cons, "successes": successes.mean()}
