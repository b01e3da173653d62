"""BallBalance: a tripod tray balancing a bouncing ball.

Counterpart of `isaacgymenv_tpu/envs/ball_balance.py`:
- the procedural balance bot: a free tray (cylinder r 0.5, t 0.02, density
  100) on three two-segment legs (capsules r 0.02, hinges about y; the
  uppers passive within +-45 degrees, the lowers position-driven, Kp 4000,
  Kd 100, within -70..90 degrees), each foot pinned to the floor by a
  world anchor; a free ball (sphere r 0.1, density 200), whose one contact
  sphere meets the ground and the tray's and legs' surfaces (7 pairs);
- act (N, 3): lower-leg target velocities, integrated
  target += dt * actionSpeedScale * a and clamped to the limits;
- obs (N, 24): the actuated dofs' pos (3) and vel (3), the ball's pos (3)
  and linvel (3), the tray sensor's force (3) / 20 and its torque about the
  three leg mounts (3 x 3) / 20: the tray's force sensor
  (`SimModel.sensor_body`), the joint-reaction wrench of its free joint,
  turned into the world and split across the three mounts;
- reward: 1 / (1 + |ball - (0, 0, 0.7)|) / (1 + |ball vel|); done when the
  ball falls below 1.5 radii, or at the episode's end;
- reset: the bot at its default pose with zero dofs; the ball at a random
  offset (0.001-0.5 m) and height (1-2 m), moving inward at up to 5 m/s
  and falling at 5 m/s.
The tray's free joint transmits no wrench in exact arithmetic, so its sensor
reads rounding noise, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from isaacgymenv_tpu_torch.envs.base import TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import builder as B
from isaacgymenv_tpu_torch.physics import engine
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_NONE,
    DRIVE_POS,
    JT_FREE,
    JT_REVOLUTE,
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)


def _euler_zyx_quat(roll, pitch, yaw):
    """Quaternion (xyzw) of the Euler angles, z-y-x order."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _quat_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _build_balance_bot():
    """The balance bot and the ball: (builder, tray height, leg mount radius, leg angles)."""
    tray_radius, tray_t = 0.5, 0.02
    leg_radius = 0.02
    leg_outer = tray_radius - 0.1
    leg_len = leg_outer - 2 * leg_radius
    leg_inner = leg_outer - leg_len / math.sqrt(2)
    tray_height = leg_len * math.sqrt(2) + 2 * leg_radius + 0.5 * tray_t

    mb = B.ModelBuilder()
    m_tray = 100.0 * math.pi * tray_radius**2 * tray_t
    tray = mb.add_body("tray", -1, JT_FREE, mass=m_tray, inertia=B.cylinder_inertia(m_tray, tray_radius, tray_t))
    mb.add_surface(tray, B.ModelBuilder.SURF_CYLINDER, (0, 0, 0), None, (tray_radius, 0.5 * tray_t, 0))
    m_leg = 1000.0 * (math.pi * leg_radius**2 * leg_len + 4 / 3 * math.pi * leg_radius**3)

    angles = [0.0, 2.0 / 3.0 * math.pi, 4.0 / 3.0 * math.pi]
    anchors = []
    for i, ang in enumerate(angles):
        up_from = np.array([leg_outer * math.cos(ang), leg_outer * math.sin(ang), -leg_radius - 0.5 * tray_t])
        up_to = np.array([leg_inner * math.cos(ang), leg_inner * math.sin(ang), up_from[2] - leg_len / math.sqrt(2)])
        up_pos = (up_from + up_to) / 2
        up_quat = _euler_zyx_quat(0, -0.75 * math.pi, ang)
        upper = mb.add_body(
            f"upper_leg{i}", tray, JT_REVOLUTE,
            joint_pos=up_pos + _quat_mat(up_quat) @ np.array([0, 0, -0.5 * leg_len]),
            joint_quat=up_quat, joint_axis=(0, 1, 0), joint_name=f"upper_leg_joint{i}",
            mass=m_leg, inertia=B.capsule_inertia(m_leg, leg_radius, leg_len),
            lower=-math.pi / 4, upper=math.pi / 4, has_limit=True,
            drive_mode=DRIVE_NONE, stiffness=0.0, damping=0.0, effort=1e6,
        )
        # the body frame sits at the joint, the capsule's center half a leg up it
        mb.add_surface(upper, B.ModelBuilder.SURF_CAPSULE, (0, 0, 0.5 * leg_len), None,
                       (leg_radius, 0.5 * leg_len, 0))
        low_quat = _euler_zyx_quat(0, -0.5 * math.pi, 0)
        low_pos_in_upper = np.array([-0.5 * leg_len, 0, 0.5 * leg_len]) + np.array([0, 0, 0.5 * leg_len])
        lower = mb.add_body(
            f"lower_leg{i}", upper, JT_REVOLUTE,
            joint_pos=low_pos_in_upper + _quat_mat(low_quat) @ np.array([0, 0, -0.5 * leg_len]),
            joint_quat=low_quat, joint_axis=(0, 1, 0), joint_name=f"lower_leg_joint{i}",
            mass=m_leg, inertia=B.capsule_inertia(m_leg, leg_radius, leg_len),
            lower=-70 * math.pi / 180, upper=math.pi / 2, has_limit=True,
            drive_mode=DRIVE_POS, stiffness=4000.0, damping=100.0, effort=1e6,
        )
        mb.add_surface(lower, B.ModelBuilder.SURF_CAPSULE, (0, 0, 0.5 * leg_len), None,
                       (leg_radius, 0.5 * leg_len, 0))
        # the foot (the capsule's far end) pinned to its spot on the floor
        anchors.append((lower, np.array([0, 0, leg_len]),
                        np.array([leg_outer * math.cos(ang), leg_outer * math.sin(ang), leg_radius])))
    for body, off, target in anchors:
        mb.add_anchor(body, off, target)

    r_ball = 0.1
    m_ball = 200.0 * 4 / 3 * math.pi * r_ball**3
    ball = mb.add_body("ball", -1, JT_FREE, mass=m_ball, inertia=B.sphere_inertia(m_ball, r_ball))
    mb.add_geom_sphere(ball, (0, 0, 0), r_ball)
    mb.add_surface(ball, B.ModelBuilder.SURF_SPHERE, (0, 0, 0), None, (r_ball, 0, 0))
    return mb, tray_height, leg_outer, angles


@register("BallBalance")
class BallBalance(TaskEnv):
    num_obs = 24
    num_actions = 3

    ball_radius = 0.1
    ball_actor = 1

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.action_speed_scale = float(cfg["env"].get("actionSpeedScale", 20.0))
        mb, self.tray_height, leg_outer, angles = _build_balance_bot()
        mb.gravity = np.array(self.gravity)
        model = mb.finalize()
        self.tray_body = model.body_names.index("tray")
        # the tray's force sensor: its joint-reaction wrench
        self.model = dataclasses.replace(model, sensor_body=(self.tray_body,)).to(self.device)
        self.actuated = [i for i, n in enumerate(self.model.dof_names) if "lower" in n]
        self.sensor_offsets = torch.tensor(
            [[leg_outer * math.cos(a), leg_outer * math.sin(a), 0.0] for a in angles], device=self.device)
        self.tray_init = torch.zeros(13, device=self.device)
        self.tray_init[2], self.tray_init[6] = self.tray_height, 1.0

    def _initial_ts(self):
        return {"dof_targets": torch.zeros((self.num_envs, len(self.actuated)), device=self.device)}

    def sample_reset_draws(self, rng, n):
        """dist ~ U(0.001, 0.5), theta ~ U(-pi, pi), height ~ U(1, 2), hspeed ~ U(0, 5), each (n,)."""
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=rng, device=self.device)  # noqa: E731
        return {"dist": u(0.001, 0.5), "theta": u(-math.pi, math.pi), "height": u(1.0, 2.0), "hspeed": u(0.0, 5.0)}

    def _reset_envs(self, state, mask, draws):
        m = self.model
        n = mask.shape[0]
        dists, theta = draws["dist"], draws["theta"]
        dirs = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
        speedscale = (dists - 0.001) / (0.5 - 0.001)
        ball_init = torch.zeros((n, 13), device=self.device)
        ball_init[:, 6] = 1.0
        ball_init[:, 0:2] = dists[:, None] * dirs
        ball_init[:, 2] = draws["height"]
        ball_init[:, 7:9] = -speedscale[:, None] * draws["hspeed"][:, None] * dirs
        ball_init[:, 9] = -5.0
        new_rs = torch.stack([self.tray_init.expand(n, 13), ball_init], dim=1)
        sim = set_root_state(m, state.sim, torch.where(mask[:, None, None], new_rs, root_state(m, state.sim)))
        mm = mask[:, None]
        sim = set_dof_state(m, sim, torch.where(mm, 0.0, dof_pos(m, sim)), torch.where(mm, 0.0, dof_vel(m, sim)))
        ts = dict(state.ts)
        ts["dof_targets"] = torch.where(mm, 0.0, ts["dof_targets"])
        return dataclasses.replace(
            state, sim=sim, progress=torch.where(mask, torch.zeros_like(state.progress), state.progress), ts=ts)

    def _make_control(self, state, actions, draws):
        m = self.model
        n = actions.shape[0]
        lo, hi = m.dof_lower[self.actuated], m.dof_upper[self.actuated]
        targets = torch.clamp(state.ts["dof_targets"] + self.dt * self.action_speed_scale * actions, lo, hi)
        full = torch.zeros((n, m.nd), device=self.device)
        full[:, self.actuated] = targets
        ctrl = dataclasses.replace(engine.Control.zero(m, n), pos_target=full)
        return ctrl, dataclasses.replace(state, ts={**state.ts, "dof_targets": targets})

    def _sensor_obs(self, state):
        """The tray sensor's force (world) split across the three leg mounts,
        and its torque about each mount."""
        quat = state.sim.body_quat[:, self.tray_body]
        cf = maths.quat_rotate(quat, state.sim.joint_wrench[:, 0, 0:3]) / 3.0
        torques = [torch.linalg.cross(maths.quat_rotate(quat, self.sensor_offsets[j].expand_as(cf)), cf, dim=-1)
                   for j in range(3)]
        return cf, torques

    def _observations(self, state, actions):
        m = self.model
        ball = root_state(m, state.sim)[:, self.ball_actor]
        f, torques = self._sensor_obs(state)
        return torch.cat([dof_pos(m, state.sim)[:, self.actuated], dof_vel(m, state.sim)[:, self.actuated],
                          ball[:, 0:3], ball[:, 7:10], f / 20.0] + [t / 20.0 for t in torques], dim=-1)

    def _reward_done(self, state, obs, actions):
        ball = root_state(self.model, state.sim)[:, self.ball_actor]
        pos, vel = ball[:, 0:3], ball[:, 7:10]
        ball_dist = torch.sqrt(pos[:, 0] ** 2 + (pos[:, 2] - 0.7) ** 2 + pos[:, 1] ** 2)
        ball_speed = torch.linalg.norm(vel, dim=-1)
        reward = 1.0 / (1.0 + ball_dist) * (1.0 / (1.0 + ball_speed))
        done = (pos[:, 2] < self.ball_radius * 1.5) | (state.progress >= self.max_episode_length - 1)
        return state, reward, done, {}
