"""Quadcopter: a tilt-rotor quadcopter flying to a fixed target by direct thrust.

Counterpart of `isaacgymenv_tpu/envs/quadcopter.py`:
- the procedural model: a free chassis (cylinder r 0.1, t 0.03, density
  50) and four rotor arms (spheres r 0.01, density 200, a pitch hinge
  within +-30 degrees), each carrying a rotor (cylinder r 0.04, t 0.01,
  density 1000, a roll hinge within +-30 degrees); 9 bodies, 8 dofs under
  PD position drives (Kp 1000, Kd 0), no contact geoms;
- act (N, 12): 0:8 dof target velocities, integrated
  target += dt * 8 pi * a and clamped to the limits; 8:12 thrust
  velocities, thrust += dt * 200 * a, clamped to [0, 2] N;
- the thrust acts along each rotor's local +z, turned into the world by the
  rotor's orientation in the body caches of the step's start, as a body
  wrench (`Control.body_wrench`) on the four rotor bodies;
- obs (N, 21): (target - pos) / 3, quat, linvel / 2, angvel / pi, dof_pos;
  the target is (0, 0, 1);
- reward: pos = 1 / (1 + d^2) with d the distance to the target,
  pos + pos * (up + spin), up = 1 / (1 + tilt^2), spin = 1 / (1 + w_z^2);
  done when d > 3 or z < 0.3, or at the episode's end;
- reset: the root at (0, 0, 1) + U([-1.5, -1.5, -0.2], [1.5, 1.5, 1.5]),
  dof_pos ~ U(-0.2, 0.2) (also the dof targets), zero velocities and thrusts.
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
    DRIVE_POS,
    JT_FREE,
    JT_REVOLUTE,
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)


def _build_quadcopter():
    """The quadcopter: (builder, the four rotor bodies)."""
    mb = B.ModelBuilder()
    chassis_radius, chassis_t = 0.1, 0.03
    rotor_radius, rotor_t = 0.04, 0.01
    arm_radius = 0.01

    m_ch = 50.0 * math.pi * chassis_radius**2 * chassis_t
    chassis = mb.add_body("chassis", -1, JT_FREE, mass=m_ch,
                          inertia=B.cylinder_inertia(m_ch, chassis_radius, chassis_t))
    rotor_bodies = []
    for i, ang in enumerate([0.25 * math.pi, 0.75 * math.pi, 1.25 * math.pi, 1.75 * math.pi]):
        qa = np.array([0.0, 0.0, math.sin(ang / 2), math.cos(ang / 2)])  # a yaw by ang
        Rz = np.array([[math.cos(ang), -math.sin(ang), 0], [math.sin(ang), math.cos(ang), 0], [0, 0, 1]])
        m_arm = 200.0 * 4.0 / 3.0 * math.pi * arm_radius**3
        arm = mb.add_body(
            f"rotor_arm{i}", chassis, JT_REVOLUTE,
            joint_pos=Rz @ np.array([chassis_radius + 0.25 * arm_radius, 0, 0]), joint_quat=qa,
            joint_axis=(0, 1, 0), joint_name=f"rotor_pitch{i}",
            mass=m_arm, inertia=B.sphere_inertia(m_arm, arm_radius),
            lower=-math.pi / 6, upper=math.pi / 6, has_limit=True,
            drive_mode=DRIVE_POS, stiffness=1000.0, damping=0.0, effort=1e6,
        )
        m_rot = 1000.0 * math.pi * rotor_radius**2 * rotor_t
        rotor = mb.add_body(
            f"rotor{i}", arm, JT_REVOLUTE,
            joint_pos=(rotor_radius + 0.25 * arm_radius, 0, 0), joint_axis=(1, 0, 0), joint_name=f"rotor_roll{i}",
            mass=m_rot, inertia=B.cylinder_inertia(m_rot, rotor_radius, rotor_t),
            lower=-math.pi / 6, upper=math.pi / 6, has_limit=True,
            drive_mode=DRIVE_POS, stiffness=1000.0, damping=0.0, effort=1e6,
        )
        rotor_bodies.append(rotor)
    return mb, rotor_bodies


@register("Quadcopter")
class Quadcopter(TaskEnv):
    num_obs = 21
    num_actions = 12

    thrust_max = 2.0

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        mb, self.rotor_bodies = _build_quadcopter()
        mb.gravity = np.array(self.gravity)
        self.model = mb.finalize().to(self.device)
        self.target = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        self.init_root = torch.zeros(13, device=self.device)
        self.init_root[2], self.init_root[6] = 1.0, 1.0

    def _initial_ts(self):
        n = self.num_envs
        return {"dof_targets": torch.zeros((n, 8), device=self.device),
                "thrusts": torch.zeros((n, 4), device=self.device)}

    def sample_reset_draws(self, rng, n):
        """root_noise (n, 3) ~ U([-1.5, -1.5, -0.2], [1.5, 1.5, 1.5]), dof_pos (n, 8) ~ U(-0.2, 0.2)."""
        lo = torch.tensor([-1.5, -1.5, -0.2], device=self.device)
        hi = torch.tensor([1.5, 1.5, 1.5], device=self.device)
        return {"root_noise": lo + (hi - lo) * torch.rand((n, 3), generator=rng, device=self.device),
                "dof_pos": -0.2 + 0.4 * torch.rand((n, 8), generator=rng, device=self.device)}

    def _reset_envs(self, state, mask, draws):
        m = self.model
        mm = mask[:, None]
        init = self.init_root.expand(mask.shape[0], 13).clone()
        init[:, 0:3] += draws["root_noise"]
        sim = set_root_state(m, state.sim, torch.where(mm, init, root_state(m, state.sim)[:, 0]))
        new_dp = draws["dof_pos"]
        sim = set_dof_state(m, sim, torch.where(mm, new_dp, dof_pos(m, sim)), torch.where(mm, 0.0, dof_vel(m, sim)))
        ts = dict(state.ts)
        ts["dof_targets"] = torch.where(mm, new_dp, ts["dof_targets"])
        ts["thrusts"] = torch.where(mm, 0.0, ts["thrusts"])
        return dataclasses.replace(
            state, sim=sim, progress=torch.where(mask, torch.zeros_like(state.progress), state.progress), ts=ts)

    def _make_control(self, state, actions, draws):
        m = self.model
        n = actions.shape[0]
        targets = torch.clamp(state.ts["dof_targets"] + self.dt * 8.0 * math.pi * actions[:, 0:8],
                              m.dof_lower, m.dof_upper)
        thrusts = torch.clamp(state.ts["thrusts"] + self.dt * 200.0 * actions[:, 8:12], 0.0, self.thrust_max)
        # each rotor's local +z thrust, turned into the world, on the rotor body
        wrench = torch.zeros((n, m.nb, 6), device=self.device)
        local = torch.zeros((n, 3), device=self.device)
        for k, b in enumerate(self.rotor_bodies):
            local[:, 2] = thrusts[:, k]
            wrench[:, b, 3:6] = maths.quat_rotate(state.sim.body_quat[:, b], local)
        ctrl = dataclasses.replace(engine.Control.zero(m, n), pos_target=targets, body_wrench=wrench)
        return ctrl, dataclasses.replace(state, ts={**state.ts, "dof_targets": targets, "thrusts": thrusts})

    def _observations(self, state, actions):
        rs = root_state(self.model, state.sim)[:, 0]
        return torch.cat([(self.target - rs[:, 0:3]) / 3.0, rs[:, 3:7], rs[:, 7:10] / 2.0, rs[:, 10:13] / math.pi,
                          dof_pos(self.model, state.sim)], dim=-1)

    def _reward_done(self, state, obs, actions):
        rs = root_state(self.model, state.sim)[:, 0]
        pos, quat = rs[:, 0:3], rs[:, 3:7]
        target_dist = torch.linalg.norm(self.target - pos, dim=-1)
        pos_reward = 1.0 / (1.0 + target_dist * target_dist)
        tiltage = torch.abs(1.0 - maths.quat_axis(quat, 2)[..., 2])
        up_reward = 1.0 / (1.0 + tiltage * tiltage)
        spinnage = torch.abs(rs[:, 12])
        spin_reward = 1.0 / (1.0 + spinnage * spinnage)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)
        die = (target_dist > 3.0) | (pos[:, 2] < 0.3)
        done = die | (state.progress >= self.max_episode_length - 1)
        return state, reward, done, {}
