"""AnymalTerrain: curriculum heightfield locomotion (the flagship task).

Counterpart of `isaacgymenv_tpu/envs/anymal_terrain.py`:
- obs (N, 188): [lin_vel*2, ang_vel*0.25, projected_gravity (inverse-rotated),
  commands[:3]*scale, dof_pos (raw), dof_vel*0.05, 140 height samples
  clip(root_z - 0.5 - h, +-1)*5, actions], plus uniform noise of
  `_noise_vec` when `addNoise`;
- act (N, 12): PD position targets 0.5*action + default_dof_pos (Kp 80,
  Kd 2, torques clipped at 80), `decimation` x `sim.dt` of physics per step;
- 13-term reward with per-term episode sums, clipped >= 0, terminal reward
  on non-timeout resets;
- commands (N, 4): [vx, vy, yaw_rate, heading]; yaw_rate is recomputed each
  step as 0.5*wrap_to_pi(heading - base heading) clipped to +-1;
- "immediate" reset timing: reward and done from the pre-reset state;
- terrain (`env.terrain.terrainType=trimesh`): a levels x types grid of
  sub-terrains with curriculum promotion by distance walked, per-env spawn
  origins, pushes every `pushInterval_s`, per-env friction from 100 buckets.

Every random number is a whole-batch draw (`sample_initial_draws`: the
initial levels and types; `sample_reset_draws`; `sample_step_draws`: the
pushes and the observation noise) that a caller can inject.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from isaacgymenv_tpu_torch.envs.base import TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.contact import Heightfield, height_at
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
from isaacgymenv_tpu_torch.utils.terrain import TerrainGrid

REW_TERMS = [
    "lin_vel_xy", "ang_vel_z", "lin_vel_z", "ang_vel_xy", "orient",
    "torques", "joint_acc", "base_height", "air_time", "collision",
    "stumble", "action_rate", "hip",
]


@register("AnymalTerrain")
class AnymalTerrain(TaskEnv):
    num_obs = 188
    num_actions = 12
    reset_timing = "immediate"
    base_height_target = 0.52

    def __init__(self, cfg, device):
        e = cfg["env"]
        learn = e["learn"]
        control = e["control"]
        self.decimation = int(control["decimation"])
        sim_dt = float(cfg["sim"]["dt"])
        dt = self.decimation * sim_dt  # the control period
        e["maxEpisodeLength"] = int(float(learn["episodeLength_s"]) / dt + 0.5)
        cfg["sim"] = dict(cfg["sim"], dt=dt)
        super().__init__(cfg, device)
        self.sim_dt = sim_dt

        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.height_meas_scale = float(learn["heightMeasurementScale"])
        self.action_scale = float(control["actionScale"])
        self.Kp = float(control["stiffness"])
        self.Kd = float(control["damping"])
        self.allow_knee_contacts = bool(learn["allowKneeContacts"])
        self.push_interval = int(float(learn["pushInterval_s"]) / dt + 0.5)
        self.push_enabled = bool(learn.get("pushRobots", True))
        self.max_episode_length_s = float(learn["episodeLength_s"])

        scale_keys = {
            "termination": "terminalReward", "lin_vel_xy": "linearVelocityXYRewardScale",
            "lin_vel_z": "linearVelocityZRewardScale", "ang_vel_z": "angularVelocityZRewardScale",
            "ang_vel_xy": "angularVelocityXYRewardScale", "orient": "orientationRewardScale",
            "torques": "torqueRewardScale", "joint_acc": "jointAccRewardScale",
            "base_height": "baseHeightRewardScale", "air_time": "feetAirTimeRewardScale",
            "collision": "kneeCollisionRewardScale", "stumble": "feetStumbleRewardScale",
            "action_rate": "actionRateRewardScale", "hip": "hipRewardScale",
        }
        self.rew_scales = {k: float(learn[v]) * dt for k, v in scale_keys.items()}
        self.command_ranges = e["randomCommandVelocityRanges"]
        init = e["baseInitState"]
        self.base_init_state = self._tensor(list(init["pos"]) + list(init["rot"]) + list(init["vLinear"])
                                            + list(init["vAngular"]))

        # --- terrain ---
        tcfg = e["terrain"]
        self.curriculum = bool(tcfg.get("curriculum", True))
        seed = int(cfg.get("seed", 0))
        if tcfg.get("terrainType", "plane") == "trimesh":
            grid = TerrainGrid(tcfg, self.num_envs, seed=seed)
            self.terrain = Heightfield(
                heights=torch.tensor(grid.height_field_raw.astype(np.float32) * grid.vertical_scale,
                                     device=self.device),
                hscale=grid.horizontal_scale,
                border_x=-grid.border_size,
                border_y=-grid.border_size,
            )
            self.terrain_origins = self._tensor(grid.env_origins)
            self.env_length = grid.env_length
            self.num_levels = grid.env_rows
            self.num_types = grid.env_cols
        else:
            self.terrain = None
            self.terrain_origins = None
            self.num_levels = int(tcfg.get("numLevels", 1))
            self.num_types = int(tcfg.get("numTerrains", 1))
            self.env_length = float(tcfg.get("mapLength", 8.0))
        self.max_init_level = int(tcfg.get("maxInitMapLevel", 0))
        if not self.curriculum:
            self.max_init_level = self.num_levels - 1

        self._build_model(cfg, seed)

        named = e["defaultJointAngles"]
        self.default_dof_pos = self._tensor([float(named.get(n, 0.0)) for n in self.model.dof_names])
        names = self.model.body_names
        foot_name = e["urdfAsset"].get("footName", "SHANK")
        knee_name = e["urdfAsset"].get("kneeName", "THIGH")
        self.base_index = names.index(e["urdfAsset"].get("baseName", names[0]))
        self.feet_indices = [i for i, n in enumerate(names) if foot_name in n]
        self.knee_indices = [i for i, n in enumerate(names) if knee_name in n]
        self.hip_dofs = [0, 3, 6, 9]

        # the 140-point height scan around the base
        y = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        x = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8])
        gx, gy = np.meshgrid(x, y, indexing="ij")
        self.num_height_points = gx.size
        self.height_points = self._tensor(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1))

        self._noise_vec = self._make_noise_vec(learn)
        self.add_noise = bool(learn.get("addNoise", False))

    def _tensor(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def _configure_drives(self, mb):
        for b in mb.bodies:
            b.drive_mode = DRIVE_POS
            b.stiffness = self.Kp
            b.damping = self.Kd
            b.effort = 80.0  # torque clip

    def _build_model(self, cfg, seed: int):
        e = cfg["env"]
        asset_cfg = e["urdfAsset"]
        mb, info = load_urdf(
            os.path.join(asset_root(), asset_cfg["file"]),
            AssetOptions(
                fix_base_link=bool(asset_cfg.get("fixBaseLink", False)),
                collapse_fixed_joints=bool(asset_cfg.get("collapseFixedJoints", True)),
                density=0.001,
            ),
            friction=float(e["terrain"].get("staticFriction", 1.0)),
        )
        self._configure_drives(mb)
        contact = cfg.get("sim", {}).get("contact", {})
        mb.contact_stiffness = float(contact.get("stiffness", 30000.0))
        mb.contact_damping = float(contact.get("damping", 60000.0))
        mb.tangential_stiffness = float(contact.get("tangential_stiffness", 1.0e6))
        mb.gravity = list(self.gravity)
        model = attach_effective_masses(mb.finalize())

        # per-env friction: env i takes bucket i % 100 of 100 uniform draws
        learn = e["learn"]
        if bool(learn.get("randomizeFriction", False)):
            lo, hi = learn["frictionRange"]
            buckets = np.random.default_rng(seed + 17).uniform(lo, hi, size=(100,))
            per_env = buckets[np.arange(self.num_envs) % 100]
            gf = model.geom_friction.numpy()[None, :] * 0 + per_env[:, None]
            model = dataclasses.replace(model, geom_friction=torch.tensor(gf, dtype=torch.float32))
        self.model = model.to(self.device)
        self._info = info

    def _make_noise_vec(self, learn) -> torch.Tensor:
        lvl = float(learn.get("noiseLevel", 1.0))
        v = np.zeros(self.num_obs, np.float32)
        v[0:3] = float(learn["linearVelocityNoise"]) * lvl * self.lin_vel_scale
        v[3:6] = float(learn["angularVelocityNoise"]) * lvl * self.ang_vel_scale
        v[6:9] = float(learn["gravityNoise"]) * lvl
        v[12:24] = float(learn["dofPositionNoise"]) * lvl * self.dof_pos_scale
        v[24:36] = float(learn["dofVelocityNoise"]) * lvl * self.dof_vel_scale
        v[36:176] = float(learn["heightMeasurementNoise"]) * lvl * self.height_meas_scale
        return self._tensor(v)

    # ------------------------------------------------------------------ draws
    def _uniform(self, rng, lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=rng, device=self.device)

    def sample_initial_draws(self, rng, n):
        """terrain_levels (n,) in [0, maxInitMapLevel], terrain_types (n,)."""
        return {
            "terrain_levels": torch.randint(0, self.max_init_level + 1, (n,), generator=rng, device=self.device),
            "terrain_types": torch.randint(0, self.num_types, (n,), generator=rng, device=self.device),
        }

    def sample_reset_draws(self, rng, n):
        """pos_offset (n, nd) ~ U(0.5, 1.5), vel (n, nd) ~ U(-0.1, 0.1),
        commands (n, 3) [vx, vy, heading] ~ U(command ranges), xy (n, 2) ~
        U(-0.5, 0.5) (the spawn offset)."""
        nd, r = self.model.nd, self.command_ranges
        commands = torch.stack([self._uniform(rng, *r[k], (n,)) for k in ("linear_x", "linear_y", "yaw")], dim=-1)
        return {
            "pos_offset": self._uniform(rng, 0.5, 1.5, (n, nd)),
            "vel": self._uniform(rng, -0.1, 0.1, (n, nd)),
            "commands": commands,
            "xy": self._uniform(rng, -0.5, 0.5, (n, 2)),
        }

    def sample_step_draws(self, rng, n):
        """push (n, 2) ~ U(-1, 1), the pushed xy velocity (used on push
        steps); noise (n, num_obs) ~ U(0, 1)."""
        draws = {}
        if self.push_enabled:
            draws["push"] = self._uniform(rng, -1.0, 1.0, (n, 2))
        if self.add_noise:
            draws["noise"] = torch.rand((n, self.num_obs), generator=rng, device=self.device)
        return draws

    # ------------------------------------------------------------------
    def _initial_ts(self):
        n, dev = self.num_envs, self.device
        zeros = lambda *s: torch.zeros((n,) + s, device=dev)  # noqa: E731
        ts = {
            "commands": zeros(4),
            "actions": zeros(self.num_actions),
            "last_actions": zeros(self.num_actions),
            "last_dof_vel": zeros(self.model.nd),
            "feet_air_time": zeros(len(self.feet_indices)),
            "last_reset_distance": torch.zeros((), device=dev),
            "common_step": torch.zeros((), dtype=torch.int32, device=dev),
            "init_done": torch.zeros((), dtype=torch.bool, device=dev),
        }
        for k in REW_TERMS:
            ts[f"epsum_{k}"] = zeros()
        return ts

    def _env_origins(self, levels, types):
        if self.terrain_origins is None:
            return torch.zeros((levels.shape[0], 3), device=self.device)
        return self.terrain_origins[levels, types]

    def _commands_from(self, draws):
        cmd = torch.cat([draws["commands"][:, :2], torch.zeros_like(draws["commands"][:, :1]),
                         draws["commands"][:, 2:3]], dim=-1)
        # small commands are zeroed
        keep = (torch.linalg.norm(cmd[:, :2], dim=-1) > 0.25)[:, None]
        return cmd * keep

    def _reset_envs(self, state, mask, draws):
        m = self.model
        ts = dict(state.ts)

        # terrain curriculum: promote by distance walked, demote short walks
        rs = root_state(m, state.sim)[:, 0]
        if self.terrain_origins is not None:
            origins_now = self._env_origins(ts["terrain_levels"], ts["terrain_types"])
            distance = torch.linalg.norm(rs[:, :2] - origins_now[:, :2], dim=-1)
            cmd_dist = torch.linalg.norm(ts["commands"][:, :2], dim=-1) * self.max_episode_length_s * 0.25
            do_update = mask & ts["init_done"] & self.curriculum
            lv = ts["terrain_levels"]
            lv = lv - (do_update & (distance < cmd_dist)).long()
            lv = lv + (do_update & (distance > self.env_length / 2)).long()
            ts["terrain_levels"] = torch.clamp(lv, min=0) % self.num_levels
            # mean distance walked by the envs resetting now (the promotion's measure)
            n_mask = torch.clamp(mask.sum(), min=1)
            ts["last_reset_distance"] = torch.where(
                mask.any(), (distance * mask).sum() / n_mask, ts["last_reset_distance"])

        mm = mask[:, None]
        sim = set_dof_state(
            m, state.sim,
            torch.where(mm, self.default_dof_pos * draws["pos_offset"], dof_pos(m, state.sim)),
            torch.where(mm, draws["vel"], dof_vel(m, state.sim)),
        )
        origins = self._env_origins(ts["terrain_levels"], ts["terrain_types"])
        init_root = self.base_init_state.expand(mask.shape[0], 13).clone()
        init_root[:, 0:3] += origins
        init_root[:, 0:2] += draws["xy"]
        sim = set_root_state(m, sim, torch.where(mm, init_root, rs))

        ts["commands"] = torch.where(mm, self._commands_from(draws), ts["commands"])
        for k in ("actions", "last_actions", "last_dof_vel", "feet_air_time"):
            ts[k] = torch.where(mm, torch.zeros_like(ts[k]), ts[k])
        ts["init_done"] = torch.ones_like(ts["init_done"])
        for k in REW_TERMS:
            ts[f"epsum_{k}"] = torch.where(mask, torch.zeros_like(ts[f"epsum_{k}"]), ts[f"epsum_{k}"])
        progress = torch.where(mask, torch.zeros_like(state.progress), state.progress)
        return dataclasses.replace(state, sim=sim, progress=progress, ts=ts)

    # ------------------------------------------------------------------
    def _make_control(self, state, actions, draws):
        ctrl = engine.Control.zero(self.model, actions.shape[0])
        return dataclasses.replace(ctrl, pos_target=self.action_scale * actions + self.default_dof_pos), state

    def _post_physics(self, state, actions, draws):
        ts = dict(state.ts)
        ts["actions"] = actions
        step = ts["common_step"] + 1
        ts["common_step"] = step

        m = self.model
        rs = root_state(m, state.sim)[:, 0]
        sim = state.sim
        if self.push_enabled:
            # every push_interval steps the base xy velocity is set to the draw;
            # the body caches are refreshed every step, as the JAX package does
            do_push = (step % self.push_interval) == 0
            new_rs = rs.clone()
            new_rs[:, 7:9] = torch.where(do_push, draws["push"], rs[:, 7:9])
            sim = engine.forward(m, self.terrain, set_root_state(m, sim, new_rs))
            rs = new_rs

        # heading-based yaw command
        base_quat = rs[:, 3:7]
        fwd = maths.quat_apply(base_quat, torch.tensor([1.0, 0.0, 0.0], device=self.device).expand_as(rs[:, :3]))
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])
        cmds = ts["commands"].clone()
        cmds[:, 2] = torch.clamp(0.5 * maths.wrap_to_pi(cmds[:, 3] - heading), -1.0, 1.0)
        ts["commands"] = cmds
        return dataclasses.replace(state, sim=sim, ts=ts)

    def _obs_noise(self, obs, draws):
        if not self.add_noise:
            return obs
        return obs + (2.0 * draws["noise"] - 1.0) * self._noise_vec

    # ------------------------------------------------------------------
    def _measured_heights(self, rs):
        """The 140-sample height scan around the base, yawed with it."""
        if self.terrain is None:
            return torch.zeros((rs.shape[0], self.num_height_points), device=self.device)
        pts = maths.quat_apply_yaw(
            rs[:, None, 3:7], self.height_points.expand(rs.shape[0], -1, -1)
        ) + rs[:, None, 0:3]
        return height_at(self.terrain, pts[..., 0], pts[..., 1])

    def _base_frame(self, rs):
        base_quat = rs[:, 3:7]
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand_as(rs[:, :3])
        return (maths.quat_rotate_inverse(base_quat, rs[:, 7:10]),
                maths.quat_rotate_inverse(base_quat, rs[:, 10:13]),
                maths.quat_rotate_inverse(base_quat, down))

    def _observations(self, state, actions):
        m = self.model
        rs = root_state(m, state.sim)[:, 0]
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(rs)
        heights = self._measured_heights(rs)
        height_obs = torch.clamp(rs[:, 2:3] - 0.5 - heights, -1.0, 1.0) * self.height_meas_scale
        cmd_scale = torch.tensor([self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale], device=self.device)
        return torch.cat(
            [
                base_lin_vel * self.lin_vel_scale,
                base_ang_vel * self.ang_vel_scale,
                projected_gravity,
                state.ts["commands"][:, :3] * cmd_scale,
                dof_pos(m, state.sim) * self.dof_pos_scale,
                dof_vel(m, state.sim) * self.dof_vel_scale,
                height_obs,
                state.ts["actions"],
            ],
            dim=-1,
        )

    def _termination(self, cf, knee_contact):
        """Base contact, and knee contact unless allowed."""
        done = torch.linalg.norm(cf[:, self.base_index], dim=-1) > 1.0
        if not self.allow_knee_contacts:
            done = done | torch.any(knee_contact, dim=1)
        return done

    def _reward_done(self, state, obs, actions):
        m = self.model
        ts = state.ts
        rs = root_state(m, state.sim)[:, 0]
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(rs)
        commands = ts["commands"]
        dp = dof_pos(m, state.sim)
        dv = dof_vel(m, state.sim)
        cf = state.sim.contact_force
        S = self.rew_scales
        sq = torch.square

        lin_vel_error = torch.sum(sq(commands[:, :2] - base_lin_vel[:, :2]), dim=1)
        ang_vel_error = sq(commands[:, 2] - base_ang_vel[:, 2])
        r = {}
        r["lin_vel_xy"] = torch.exp(-lin_vel_error / 0.25) * S["lin_vel_xy"]
        r["ang_vel_z"] = torch.exp(-ang_vel_error / 0.25) * S["ang_vel_z"]
        r["lin_vel_z"] = sq(base_lin_vel[:, 2]) * S["lin_vel_z"]
        r["ang_vel_xy"] = torch.sum(sq(base_ang_vel[:, :2]), dim=1) * S["ang_vel_xy"]
        r["orient"] = torch.sum(sq(projected_gravity[:, :2]), dim=1) * S["orient"]
        r["base_height"] = sq(rs[:, 2] - self.base_height_target) * S["base_height"]
        r["torques"] = torch.sum(sq(state.sim.dof_force), dim=1) * S["torques"]
        r["joint_acc"] = torch.sum(sq(ts["last_dof_vel"] - dv), dim=1) * S["joint_acc"]

        knee_contact = torch.linalg.norm(cf[:, self.knee_indices], dim=-1) > 1.0
        r["collision"] = torch.sum(knee_contact, dim=1).float() * S["collision"]

        feet_cf = cf[:, self.feet_indices]
        stumble = (torch.linalg.norm(feet_cf[..., :2], dim=-1) > 5.0) & (torch.abs(feet_cf[..., 2]) < 1.0)
        r["stumble"] = torch.sum(stumble, dim=1).float() * S["stumble"]
        r["action_rate"] = torch.sum(sq(ts["last_actions"] - ts["actions"]), dim=1) * S["action_rate"]

        contact = feet_cf[..., 2] > 1.0
        air = ts["feet_air_time"]
        first_contact = (air > 0.0) & contact
        air = air + self.dt
        rew_air = torch.sum((air - 0.5) * first_contact, dim=1) * S["air_time"]
        r["air_time"] = rew_air * (torch.linalg.norm(commands[:, :2], dim=1) > 0.1)
        air = air * ~contact

        default_hip = self.default_dof_pos[self.hip_dofs]
        r["hip"] = torch.sum(torch.abs(dp[:, self.hip_dofs] - default_hip), dim=1) * S["hip"]

        total = torch.clamp(sum(r.values()), min=0.0)
        done = self._termination(cf, knee_contact)
        timeout = state.progress >= self.max_episode_length - 1
        done = done | timeout
        total = total + S["termination"] * (done & ~timeout)

        ts = dict(ts)
        ts["feet_air_time"] = air
        ts["last_actions"] = ts["actions"]
        ts["last_dof_vel"] = dv
        info = {}
        n_done = torch.clamp(done.sum(), min=1)
        for k in REW_TERMS:
            s = ts[f"epsum_{k}"] + r[k]
            ts[f"epsum_{k}"] = s
            # per-term mean over the envs finishing now, per second of episode
            info[f"rew_{k}"] = torch.where(
                done.any(), (s * done).sum() / n_done / self.max_episode_length_s, torch.zeros_like(s[0]))
        info["terrain_level"] = ts["terrain_levels"].float().mean()
        info["distance_walked"] = ts["last_reset_distance"]
        return dataclasses.replace(state, ts=ts), total, done, {"episode": info}
