"""Ant: MJCF quadruped running toward a target far along +x.

Counterpart of `isaacgymenv_tpu/envs/ant.py`:
- obs (N, 60): [torso_z, vel_loc (3), angvel_loc (3), yaw, roll,
  angle_to_target, up_proj, heading_proj, dof_pos unscaled to [-1, 1] (8),
  dof_vel * 0.2 (8), the four feet's 6-D force sensors (24) * 0.1,
  actions (8)];
- act (N, 8): torque = action * motor gear * powerScale (the effort drive);
- reward: potential progress + alive 0.5 + up 0.1 (up_proj > 0.93) +
  heading (0.5, or scaled below a projection of 0.8) - 0.005 actions^2 -
  0.05 electricity - 0.1 dofs at a limit; deathCost below terminationHeight;
- done: torso below terminationHeight, or the episode's end;
- reset: dof_pos = clamp(initial + U(-0.2, 0.2), limits),
  dof_vel ~ U(-0.1, 0.1), the root at its start pose (z 0.44);
- potentials: -|to_target|_xy / dt, the target at (1000, 0, 0).
The force sensors are true joint-reaction wrenches of the feet
(`SimModel.sensor_body`), computed by the physics step on every substep's
ABA and kept from the last one.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from isaacgymenv_tpu_torch.envs.base import TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses
from isaacgymenv_tpu_torch.physics.mjcf import load_mjcf
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_EFFORT,
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)
from isaacgymenv_tpu_torch.utils.config import asset_root


@register("Ant")
class Ant(TaskEnv):
    num_obs = 60
    num_actions = 8

    foot_fragment = "foot"
    asset_default = "mjcf/nv_ant.xml"
    start_z = 0.44
    up_proj_thresh = 0.93

    def __init__(self, cfg, device):
        cfg["env"]["maxEpisodeLength"] = int(cfg["env"]["episodeLength"])
        super().__init__(cfg, device)
        e = cfg["env"]
        self.power_scale = float(e["powerScale"])
        self.heading_weight = float(e["headingWeight"])
        self.up_weight = float(e["upWeight"])
        self.actions_cost_scale = float(e["actionsCost"])
        self.energy_cost_scale = float(e["energyCost"])
        self.joints_at_limit_cost_scale = float(e["jointsAtLimitCost"])
        self.death_cost = float(e["deathCost"])
        self.termination_height = float(e["terminationHeight"])
        self.dof_vel_scale = float(e["dofVelocityScale"])
        self.contact_force_scale = float(e["contactForceScale"])

        self._build_model(cfg)
        m = self.model
        # the initial dof position: zero clamped into the limits
        zero = torch.zeros_like(m.dof_lower)
        self.initial_dof_pos = torch.where(
            m.dof_lower > 0, m.dof_lower, torch.where(m.dof_upper < 0, m.dof_upper, zero))
        self.feet_indices = [i for i, n in enumerate(m.body_names) if self.foot_fragment in n and "__ph" not in n]
        if not m.sensor_body:
            self.model = dataclasses.replace(m, sensor_body=tuple(self.feet_indices))
        self.targets = torch.tensor([1000.0, 0.0, 0.0], device=self.device)
        self.start_rotation = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
        self.init_root = torch.zeros(13, device=self.device)
        self.init_root[2], self.init_root[6] = self.start_z, 1.0

    def _build_model(self, cfg):
        path = os.path.join(asset_root(), cfg["env"].get("asset", {}).get("assetFileName", self.asset_default))
        friction = float(cfg["env"]["plane"]["staticFriction"])
        mb, info = load_mjcf(path)
        mb.geom_friction = [friction] * len(mb.geom_friction)  # the plane's friction on every geom
        for b in mb.bodies:
            b.drive_mode = DRIVE_EFFORT
            b.stiffness = 0.0
            b.effort = 1e9
        contact = cfg.get("sim", {}).get("contact", {})
        mb.contact_stiffness = float(contact.get("stiffness", 1000.0))
        mb.contact_damping = float(contact.get("damping", 30000.0))
        mb.tangential_stiffness = float(contact.get("tangential_stiffness", 1.0e6))
        mb.gravity = list(self.gravity)
        self.model = attach_effective_masses(mb.finalize()).to(self.device)
        self.terrain = None
        # the motor gears in dof order
        gears = torch.zeros(self.model.nd)
        for jname, gear in zip(info["actuator_joints"], info["gears"]):
            gears[self.model.dof_names.index(jname)] = float(gear)
        self.joint_gears = gears.to(self.device)

    # ------------------------------------------------------------------
    def _initial_ts(self):
        n = self.num_envs
        pot = torch.full((n,), -1000.0 / self.dt, device=self.device)
        return {"actions": torch.zeros((n, self.num_actions), device=self.device),
                "potentials": pot, "prev_potentials": pot.clone()}

    def sample_reset_draws(self, rng, n):
        """dof_pos (n, nd) ~ U(-0.2, 0.2), dof_vel (n, nd) ~ U(-0.1, 0.1)."""
        nd = self.model.nd
        u = lambda lo, hi: lo + (hi - lo) * torch.rand((n, nd), generator=rng, device=self.device)  # noqa: E731
        return {"dof_pos": u(-0.2, 0.2), "dof_vel": u(-0.1, 0.1)}

    def _reset_envs(self, state, mask, draws):
        m = self.model
        mm = mask[:, None]
        new_pos = torch.clamp(self.initial_dof_pos + draws["dof_pos"], m.dof_lower, m.dof_upper)
        sim = set_dof_state(m, state.sim, torch.where(mm, new_pos, dof_pos(m, state.sim)),
                            torch.where(mm, draws["dof_vel"], dof_vel(m, state.sim)))
        sim = set_root_state(m, sim, torch.where(mm, self.init_root, root_state(m, sim)[:, 0]))
        to_target = self.targets - self.init_root[0:3]
        pot0 = -torch.linalg.norm(to_target[:2]) / self.dt
        ts = dict(state.ts)
        ts["potentials"] = torch.where(mask, pot0, ts["potentials"])
        ts["prev_potentials"] = torch.where(mask, pot0, ts["prev_potentials"])
        ts["actions"] = torch.where(mm, torch.zeros_like(ts["actions"]), ts["actions"])
        return dataclasses.replace(
            state, sim=sim, progress=torch.where(mask, torch.zeros_like(state.progress), state.progress), ts=ts)

    def _make_control(self, state, actions, draws):
        ctrl = engine.Control.zero(self.model, actions.shape[0])
        return dataclasses.replace(ctrl, effort=actions * self.joint_gears * self.power_scale), state

    def _post_physics(self, state, actions, draws):
        rs = root_state(self.model, state.sim)[:, 0]
        to_target = self.targets[:2] - rs[:, 0:2]
        ts = {**state.ts, "actions": actions, "prev_potentials": state.ts["potentials"],
              "potentials": -torch.linalg.norm(to_target, dim=-1) / self.dt}
        return dataclasses.replace(state, ts=ts)

    # ------------------------------------------------------------------
    def _observations(self, state, actions):
        m = self.model
        rs = root_state(m, state.sim)[:, 0]
        torso_pos, torso_rot = rs[:, 0:3], rs[:, 3:7]
        velocity, ang_velocity = rs[:, 7:10], rs[:, 10:13]
        to_target = self.targets - torso_pos
        to_target[:, 2] = 0.0
        torso_quat, up_proj, heading_proj, _, _ = maths.compute_heading_and_up(
            torso_rot, maths.quat_conjugate(self.start_rotation).expand_as(torso_rot), to_target,
            torch.tensor([1.0, 0.0, 0.0], device=self.device).expand_as(torso_pos),
            torch.tensor([0.0, 0.0, 1.0], device=self.device).expand_as(torso_pos), 2,
        )
        vel_loc, angvel_loc, roll, _, yaw, angle_to_target = maths.compute_rot(
            torso_quat, velocity, ang_velocity, self.targets.expand_as(torso_pos), torso_pos)
        dp_scaled = maths.unscale(dof_pos(m, state.sim), m.dof_lower, m.dof_upper)
        dv = dof_vel(m, state.sim) * self.dof_vel_scale
        # the feet's joint-reaction wrenches, [force, torque] in the foot frame
        sensors = state.sim.joint_wrench.reshape(rs.shape[0], -1) * self.contact_force_scale
        return torch.cat([
            torso_pos[:, 2:3], vel_loc, angvel_loc, yaw[:, None], roll[:, None], angle_to_target[:, None],
            up_proj[:, None], heading_proj[:, None], dp_scaled, dv, sensors, state.ts["actions"],
        ], dim=-1)

    def _reward_done(self, state, obs, actions):
        nd = self.model.nd
        heading_proj, up_proj = obs[:, 11], obs[:, 10]
        heading_reward = torch.where(heading_proj > 0.8, torch.full_like(heading_proj, self.heading_weight),
                                     self.heading_weight * heading_proj / 0.8)
        up_reward = torch.where(up_proj > self.up_proj_thresh, self.up_weight, 0.0)
        actions_cost = (actions ** 2).sum(-1)
        electricity_cost = torch.abs(actions * obs[:, 12 + nd:12 + 2 * nd]).sum(-1)
        dof_at_limit_cost = (obs[:, 12:12 + nd] > 0.99).sum(-1).to(torch.float32)
        progress_reward = state.ts["potentials"] - state.ts["prev_potentials"]
        total = (progress_reward + 0.5 + up_reward + heading_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - self.joints_at_limit_cost_scale * dof_at_limit_cost)
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (state.progress >= self.max_episode_length - 1)
        # the torso's forward velocity, the objective PBT ranks by
        return state, total, done, {"true_objective": root_state(self.model, state.sim)[:, 0, 7]}
