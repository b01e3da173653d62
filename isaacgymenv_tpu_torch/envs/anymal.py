"""Anymal: flat-terrain quadruped velocity-command locomotion.

Counterpart of `isaacgymenv_tpu/envs/anymal.py`:
- obs (N, 48): [base_lin_vel*2 (body frame), base_ang_vel*0.25 (body frame),
  projected_gravity, commands*(2, 2, 0.25), dof_pos - default, dof_vel*0.05,
  previous actions]; projected_gravity uses quat_rotate, not its inverse,
  as the reference does;
- act (N, 12): PD position targets 0.5*action + default_dof_pos (Kp 85, Kd 2);
- reward (clipped >= 0): exp(-err/0.25) xy lin-vel and yaw ang-vel tracking
  plus a torque penalty, scales times dt;
- done: |contact force| > 1 N on the base or a THIGH body, or timeout;
- reset: root = baseInitState, dof_pos = default * U(0.5, 1.5),
  dof_vel ~ U(-0.1, 0.1), commands resampled.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from isaacgymenv_tpu_torch.envs.base import EnvState, TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_POS,
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)
from isaacgymenv_tpu_torch.physics.urdf import AssetOptions, load_urdf
from isaacgymenv_tpu_torch.utils.config import asset_root


@register("Anymal")
class Anymal(TaskEnv):
    num_obs = 48
    num_actions = 12

    knee_fragment = "THIGH"
    base_name = "base"

    def __init__(self, cfg, device):
        dt = float(cfg.get("sim", {}).get("dt", 0.02))
        cfg["env"]["maxEpisodeLength"] = int(float(cfg["env"]["learn"]["episodeLength_s"]) / dt + 0.5)
        super().__init__(cfg, device)

        learn = cfg["env"]["learn"]
        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.action_scale = float(cfg["env"]["control"]["actionScale"])
        self.Kp = float(cfg["env"]["control"]["stiffness"])
        self.Kd = float(cfg["env"]["control"]["damping"])
        self.rew_scales = {
            "lin_vel_xy": float(learn["linearVelocityXYRewardScale"]) * dt,
            "ang_vel_z": float(learn["angularVelocityZRewardScale"]) * dt,
            "torque": float(learn["torqueRewardScale"]) * dt,
        }
        self.command_ranges = cfg["env"]["randomCommandVelocityRanges"]
        init = cfg["env"]["baseInitState"]
        self.base_init_state = torch.tensor(
            list(init["pos"]) + list(init["rot"]) + list(init["vLinear"]) + list(init["vAngular"]),
            dtype=torch.float32, device=self.device,
        )

        self._build_model(cfg)
        named = cfg["env"]["defaultJointAngles"]
        self.default_dof_pos = torch.tensor(
            [float(named[n]) for n in self.model.dof_names], dtype=torch.float32, device=self.device
        )
        names = self.model.body_names
        self.base_index = names.index(self.base_name)
        self.knee_indices = [i for i, n in enumerate(names) if self.knee_fragment in n]
        self.obs_scale = torch.tensor(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale], device=self.device
        )

    def _build_model(self, cfg):
        asset_cfg = cfg["env"]["urdfAsset"]
        path = os.path.join(asset_root(), asset_cfg.get("file", "urdf/anymal_c/urdf/anymal.urdf"))
        mb, info = load_urdf(
            path,
            AssetOptions(
                fix_base_link=bool(asset_cfg.get("fixBaseLink", False)),
                collapse_fixed_joints=bool(asset_cfg.get("collapseFixedJoints", True)),
                density=0.001,
            ),
            friction=float(cfg["env"]["plane"]["staticFriction"]),
        )
        for b in mb.bodies:
            b.drive_mode = DRIVE_POS
            b.stiffness = self.Kp
            b.damping = self.Kd
        contact = cfg.get("sim", {}).get("contact", {})
        mb.contact_stiffness = float(contact.get("stiffness", 30000.0))
        mb.contact_damping = float(contact.get("damping", 300.0))
        mb.tangential_stiffness = float(contact.get("tangential_stiffness", 1.0e6))
        mb.gravity = list(self.gravity)
        self.model = attach_effective_masses(mb.finalize()).to(self.device)
        self.terrain = None
        self._info = info

    # ------------------------------------------------------------------
    def _initial_ts(self):
        n = self.num_envs
        return {
            "commands": torch.zeros((n, 3), device=self.device),
            "actions": torch.zeros((n, self.num_actions), device=self.device),
        }

    def sample_reset_draws(self, rng, n):
        """pos_offset (n, nd) ~ U(0.5, 1.5), vel (n, nd) ~ U(-0.1, 0.1),
        commands (n, 3) ~ U(command ranges)."""
        nd = self.model.nd

        def uniform(lo, hi, shape):
            return lo + (hi - lo) * torch.rand(shape, generator=rng, device=self.device)

        r = self.command_ranges
        commands = torch.stack(
            [uniform(*r["linear_x"], (n,)), uniform(*r["linear_y"], (n,)), uniform(*r["yaw"], (n,))], dim=-1
        )
        return {
            "pos_offset": uniform(0.5, 1.5, (n, nd)),
            "vel": uniform(-0.1, 0.1, (n, nd)),
            "commands": commands,
        }

    def _reset_envs(self, state, mask, draws):
        m = mask[:, None]
        sim = set_dof_state(
            self.model, state.sim,
            torch.where(m, self.default_dof_pos * draws["pos_offset"], dof_pos(self.model, state.sim)),
            torch.where(m, draws["vel"], dof_vel(self.model, state.sim)),
        )
        cur_root = root_state(self.model, sim)[:, 0]
        sim = set_root_state(self.model, sim, torch.where(m, self.base_init_state, cur_root))
        ts = dict(state.ts)
        ts["commands"] = torch.where(m, draws["commands"], ts["commands"])
        ts["actions"] = torch.where(m, torch.zeros_like(ts["actions"]), ts["actions"])
        return dataclasses.replace(
            state, sim=sim, progress=torch.where(mask, torch.zeros_like(state.progress), state.progress), ts=ts
        )

    # ------------------------------------------------------------------
    def _make_control(self, state, actions, draws):
        ctrl = engine.Control.zero(self.model, actions.shape[0])
        return dataclasses.replace(ctrl, pos_target=self.action_scale * actions + self.default_dof_pos), state

    def _post_physics(self, state, actions, draws):
        return dataclasses.replace(state, ts={**state.ts, "actions": actions})

    def _base_vels(self, state):
        rs = root_state(self.model, state.sim)[:, 0]
        base_quat = rs[:, 3:7]
        lin = maths.quat_rotate_inverse(base_quat, rs[:, 7:10])
        ang = maths.quat_rotate_inverse(base_quat, rs[:, 10:13])
        return base_quat, lin, ang

    def _observations(self, state, actions):
        base_quat, base_lin_vel, base_ang_vel = self._base_vels(state)
        gravity_vec = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(base_quat.shape[:-1] + (3,))
        projected_gravity = maths.quat_rotate(base_quat, gravity_vec)
        dp = (dof_pos(self.model, state.sim) - self.default_dof_pos) * self.dof_pos_scale
        dv = dof_vel(self.model, state.sim) * self.dof_vel_scale
        return torch.cat(
            [
                base_lin_vel * self.lin_vel_scale,
                base_ang_vel * self.ang_vel_scale,
                projected_gravity,
                state.ts["commands"] * self.obs_scale,
                dp,
                dv,
                state.ts["actions"],
            ],
            dim=-1,
        )

    def _reward_done(self, state: EnvState, obs, actions):
        _, base_lin_vel, base_ang_vel = self._base_vels(state)
        commands = state.ts["commands"]
        lin_vel_error = torch.sum(torch.square(commands[:, :2] - base_lin_vel[:, :2]), dim=1)
        ang_vel_error = torch.square(commands[:, 2] - base_ang_vel[:, 2])
        rew_lin = torch.exp(-lin_vel_error / 0.25) * self.rew_scales["lin_vel_xy"]
        rew_ang = torch.exp(-ang_vel_error / 0.25) * self.rew_scales["ang_vel_z"]
        rew_torque = torch.sum(torch.square(state.sim.dof_force), dim=1) * self.rew_scales["torque"]
        total = torch.clamp(rew_lin + rew_ang + rew_torque, min=0.0)

        cf = state.sim.contact_force
        base_contact = torch.linalg.norm(cf[:, self.base_index], dim=-1) > 1.0
        knee_contact = torch.any(torch.linalg.norm(cf[:, self.knee_indices], dim=-1) > 1.0, dim=-1)
        timeout = state.progress >= self.max_episode_length - 1
        return state, total, base_contact | knee_contact | timeout, {}
