"""FrankaCubeStack: pick up cube A and stack it on cube B.

Counterpart of `isaacgymenv_tpu/envs/franka_cube_stack.py`:
- franka_panda_gripper.urdf (7 arm dofs on effort drive, 2 finger dofs on
  position drive, Kp 5000, Kd 100, effort 200; every Franka body gravity
  compensated) fixed on a stand at (-0.45, 0, 1.125); a fixed table
  1.2 x 1.2 x 0.05 at (0, 0, 1) and a fixed stand, each a box surface; the
  free cubes A (5 cm) and B (7 cm), each a box surface with 8 inset corner
  spheres, which keep their gravity.  The cubes' spheres meet the table's,
  the stand's, each other's and the Franka's surfaces as pairs, so the scene
  runs on the split pair B2 + B3 (B2's gravity compensation mode);
- act (N, 7) (`controlType: osc`): a task-space delta of the grip site (6)
  turned into arm torques by operational-space control (`_osc_torques`:
  kp 150, kd 2 sqrt(150), nullspace kp 10 toward the default pose), and a
  binary gripper (1) that snaps the finger targets to their limits;
  `joint_tor`: (N, 8), arm torques scaled by the effort limits;
- obs (N, 19): cube A's quat (4) and pos (3), cube B - cube A (3), the grip
  site's pos (3) and quat (4), the finger dofs (2); `joint_tor` ends with
  all 9 dofs (26);
- reward: reaching (1 - tanh(10 x the mean distance of grip site and
  fingertips to cube A)), raised to the alignment term once cube A is
  lifted, a lift bonus, and the stack reward, which also ends the episode;
- reset: cube B anywhere in the spawn square, cube A redrawn in 8 masked
  rounds where it lands too close to B, both with a random yaw, both at the
  table + cube A's half-height (the reference's quirk: cube B starts 1 cm
  sunk and pops out); the Franka dofs at the default pose plus noise,
  clipped to the limits, the fingers exact.
Every random number comes from `sample_reset_draws`, so a test can hand the
JAX package's draws across.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from isaacgymenv_tpu_torch.envs.base import TaskEnv
from isaacgymenv_tpu_torch.envs.registry import register
from isaacgymenv_tpu_torch.ops import maths
from isaacgymenv_tpu_torch.physics import builder as B
from isaacgymenv_tpu_torch.physics import dynamics, engine, kinematics
from isaacgymenv_tpu_torch.physics.meff import attach_effective_masses
from isaacgymenv_tpu_torch.physics.types import (
    DRIVE_EFFORT,
    DRIVE_POS,
    JT_FIXED,
    JT_FREE,
    JT_PRISMATIC,
    JT_REVOLUTE,
    dof_pos,
    dof_vel,
    root_state,
    set_dof_state,
    set_root_state,
)
from isaacgymenv_tpu_torch.physics.urdf import AssetOptions, load_urdf
from isaacgymenv_tpu_torch.utils.config import asset_root

FRANKA_DEFAULT = (0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854, 0.035, 0.035)
TABLE_POS = (0.0, 0.0, 1.0)
TABLE_THICK = 0.05
TABLE_HEIGHT = TABLE_POS[2] + TABLE_THICK / 2  # 1.025
CUBE_A, CUBE_B = 0.050, 0.070
RESAMPLE_ROUNDS = 8  # masked redraws of cube A away from cube B


def _add_box_actor(mb, name, half, pos, mass, fixed=False, friction=1.0):
    """A box actor: a box surface, and 8 corner spheres inset by their radius
    when it is free; a fixed one sits at `pos`, a free one is placed by its
    root state."""
    b = mb.add_body(
        name, -1, JT_FIXED if fixed else JT_FREE,
        joint_pos=pos if fixed else (0, 0, 0),
        mass=mass, inertia=B.box_inertia(mass, 2 * half[0], 2 * half[1], 2 * half[2]),
    )
    mb.add_surface(b, B.ModelBuilder.SURF_BOX, (0, 0, 0), None, half, friction)
    if not fixed:
        r = max(min(half) / 2.0, 1e-3)
        for dx in (-1, 1):
            for dy in (-1, 1):
                for dz in (-1, 1):
                    mb.add_geom_sphere(b, (dx * (half[0] - r), dy * (half[1] - r), dz * (half[2] - r)), r, friction)
    return b


def franka_builder():
    """The Franka on its stand, fixed base, every body gravity compensated,
    the arm on effort drive and the fingers on position drive: (builder,
    the URDF loader's info)."""
    fb, finfo = load_urdf(
        os.path.join(asset_root(), "urdf/franka_description/robots/franka_panda_gripper.urdf"),
        AssetOptions(fix_base_link=True, collapse_fixed_joints=False, density=1000.0),
        base_pos=(-0.45, 0.0, TABLE_POS[2] + TABLE_THICK / 2 + 0.1),
    )
    i = 0
    for b in fb.bodies:
        b.gravcomp = 1.0  # disable_gravity
        if b.jtype in (JT_REVOLUTE, JT_PRISMATIC):
            if i < 7:
                b.drive_mode, b.stiffness, b.damping = DRIVE_EFFORT, 0.0, 0.0
            else:  # the fingers
                b.drive_mode, b.stiffness, b.damping, b.effort = DRIVE_POS, 5000.0, 100.0, 200.0
            i += 1
    return fb, finfo


@register("FrankaCubeStack")
class FrankaCubeStack(TaskEnv):
    num_obs = 19
    num_actions = 7

    cubeA_actor, cubeB_actor = 3, 4  # franka, table, stand, cube A, cube B

    def __init__(self, cfg, device):
        e = cfg["env"]
        e.setdefault("maxEpisodeLength", int(e.get("episodeLength", 300)))
        super().__init__(cfg, device)
        self.control_type = e.get("controlType", "osc")
        if self.control_type not in ("osc", "joint_tor"):
            raise ValueError(f"FrankaCubeStack: unknown controlType {self.control_type!r}")
        if self.control_type == "joint_tor":
            self.num_obs, self.num_actions = 26, 8
        self.action_scale = float(e.get("actionScale", 1.0))
        self.start_position_noise = float(e.get("startPositionNoise", 0.25))
        self.start_rotation_noise = float(e.get("startRotationNoise", 0.785))
        self.franka_dof_noise = float(e.get("frankaDofNoise", 0.25))
        self.r_dist = float(e.get("distRewardScale", 0.1))
        self.r_lift = float(e.get("liftRewardScale", 1.5))
        self.r_align = float(e.get("alignRewardScale", 2.0))
        self.r_stack = float(e.get("stackRewardScale", 16.0))
        self._build_model()
        self.kp, self.kd = 150.0, 2.0 * math.sqrt(150.0)
        self.kp_null, self.kd_null = 10.0, 2.0 * math.sqrt(10.0)
        self.cmd_limit = torch.tensor([0.1, 0.1, 0.1, 0.5, 0.5, 0.5], device=self.device)

    def _build_model(self):
        fb, finfo = franka_builder()
        _add_box_actor(fb, "table", (0.6, 0.6, TABLE_THICK / 2), TABLE_POS, 100.0, fixed=True)
        _add_box_actor(fb, "table_stand", (0.1, 0.1, 0.05), (-0.5, 0.0, TABLE_POS[2] + TABLE_THICK / 2 + 0.05),
                       20.0, fixed=True)
        self.cubeA_body = _add_box_actor(fb, "cubeA", (CUBE_A / 2,) * 3, None, 1000.0 * CUBE_A**3)
        self.cubeB_body = _add_box_actor(fb, "cubeB", (CUBE_B / 2,) * 3, None, 1000.0 * CUBE_B**3)
        fb.gravity = np.array(self.gravity)
        self.model = attach_effective_masses(fb.finalize()).to(self.device)
        m = self.model
        self.eef_body = finfo["link_body"]["panda_grip_site"]
        self.lf_body = finfo["link_body"]["panda_leftfinger_tip"]
        self.rf_body = finfo["link_body"]["panda_rightfinger_tip"]
        self.arm_v_adr = [m.dof_v_adr[d] for d in range(7)]
        self.finger_dofs = [7, 8]
        self.effort_limit = m.dof_effort[:7]
        self.default_dof = torch.tensor(FRANKA_DEFAULT, device=self.device)
        self.inertias = dynamics.body_spatial_inertias(m)

    # ------------------------------------------------------------------
    def _initial_ts(self):
        n = self.num_envs
        return {"actions": torch.zeros((n, self.num_actions), device=self.device),
                "gripper_targets": torch.full((n, 2), 0.035, device=self.device)}

    def sample_reset_draws(self, rng, n):
        """U(0, 1) each: the cubes' spawn points `b_xy`, `a_xy` (n, 2), cube A's
        redraws `a_rounds` (8, n, 2), their yaws `yaw_a`, `yaw_b` (n,), and
        the Franka dofs' noise `dof` (n, 9)."""
        u = lambda *shape: torch.rand(shape, generator=rng, device=self.device)  # noqa: E731
        return {"b_xy": u(n, 2), "a_xy": u(n, 2), "a_rounds": u(RESAMPLE_ROUNDS, n, 2), "yaw_a": u(n),
                "yaw_b": u(n), "dof": u(n, 9)}

    def _sample_cube_states(self, draws, n):
        """(n, 13) root states of cube A and cube B: B anywhere in the spawn
        square, A redrawn while it lies within reach of B."""
        noise = self.start_position_noise
        center = torch.tensor(TABLE_POS[:2], device=self.device)
        z = TABLE_HEIGHT + CUBE_A / 2  # both cubes at cube A's half-height: the reference's quirk
        b_xy = center + 2.0 * noise * (draws["b_xy"] - 0.5)
        min_dist = (CUBE_A + CUBE_B) * np.sqrt(2) / 2.0 * 2.0
        a_xy = center + 2.0 * noise * (draws["a_xy"] - 0.5)
        for i in range(RESAMPLE_ROUNDS):
            bad = torch.linalg.norm(a_xy - b_xy, dim=-1) < min_dist
            a_xy = torch.where(bad[:, None], center + 2.0 * noise * (draws["a_rounds"][i] - 0.5), a_xy)
        z_unit = torch.tensor([0.0, 0.0, 1.0], device=self.device).expand(n, 3)

        def mk(xy, u_yaw):
            s = torch.zeros((n, 13), device=self.device)
            s[:, 0:2] = xy
            s[:, 2] = z
            s[:, 3:7] = maths.quat_from_angle_axis(2.0 * self.start_rotation_noise * (u_yaw - 0.5), z_unit)
            return s

        return mk(a_xy, draws["yaw_a"]), mk(b_xy, draws["yaw_b"])

    def _reset_envs(self, state, mask, draws):
        m = self.model
        n = mask.shape[0]
        a_state, b_state = self._sample_cube_states(draws, n)
        rs = root_state(m, state.sim).clone()
        mm = mask[:, None]
        rs[:, self.cubeA_actor] = torch.where(mm, a_state, rs[:, self.cubeA_actor])
        rs[:, self.cubeB_actor] = torch.where(mm, b_state, rs[:, self.cubeB_actor])
        sim = set_root_state(m, state.sim, rs)
        pos = torch.clamp(self.default_dof + self.franka_dof_noise * 2.0 * (draws["dof"] - 0.5),
                          m.dof_lower, m.dof_upper)
        pos[:, 7:] = self.default_dof[7:]  # fingers exact
        sim = set_dof_state(m, sim, torch.where(mm, pos, dof_pos(m, sim)), torch.where(mm, 0.0, dof_vel(m, sim)))
        ts = dict(state.ts)
        ts["gripper_targets"] = torch.where(mm, 0.035, ts["gripper_targets"])
        return dataclasses.replace(
            state, sim=sim, progress=torch.where(mask, torch.zeros_like(state.progress), state.progress), ts=ts)

    # ------------------------------------------------------------------
    def _osc_torques(self, state, dpose):
        """Operational-space control of the grip site: arm torques (N, 7)
        clipped to the effort limits, from the pose delta `dpose` (N, 6).
        The two batched solves are task logic, strict fp32."""
        m = self.model
        q = dof_pos(m, state.sim)[:, :7]
        qd = dof_vel(m, state.sim)[:, :7]
        kin = kinematics.fk(m, state.sim.q, state.sim.qd)
        av = self.arm_v_adr
        M = dynamics.crba(m, kin, self.inertias)[:, av][:, :, av]
        eef_pos = kin.p_w[self.eef_body]
        J = kinematics.body_jacobian(m, kin, self.eef_body, eef_pos)[..., av]
        ang, lin = kinematics.world_velocities(m, kin)
        eef_vel = torch.cat([lin[self.eef_body], ang[self.eef_body]], -1)

        eye = torch.eye(7, device=q.device).expand_as(M)
        eye6 = torch.eye(6, device=q.device).expand(q.shape[0], 6, 6)
        Jt = J.transpose(-1, -2)
        Minv = torch.linalg.solve(M + 1e-9 * eye, eye)
        m_eef_inv = J @ Minv @ Jt
        m_eef = torch.linalg.solve(m_eef_inv + 1e-2 * eye6, eye6)
        u = Jt @ m_eef @ (self.kp * dpose - self.kd * eef_vel)[..., None]
        j_eef_inv = m_eef @ J @ Minv
        u_null = self.kd_null * -qd + self.kp_null * (
            torch.remainder(self.default_dof[:7] - q + math.pi, 2 * math.pi) - math.pi)
        u_null = M @ u_null[..., None]
        proj = eye - Jt @ j_eef_inv
        u = (u + proj @ u_null)[..., 0]
        return torch.clamp(u, -self.effort_limit, self.effort_limit)

    def _make_control(self, state, actions, draws):
        m = self.model
        n = actions.shape[0]
        u_arm, u_gripper = actions[:, :-1], actions[:, -1]
        if self.control_type == "osc":
            u = self._osc_torques(state, u_arm * self.cmd_limit / self.action_scale)
        else:
            u = torch.clamp(u_arm * self.effort_limit / self.action_scale, -self.effort_limit, self.effort_limit)
        # the binary gripper: the finger targets snap to their limits
        fd = self.finger_dofs
        fingers = torch.where(u_gripper[:, None] >= 0.0, m.dof_upper[fd], m.dof_lower[fd])
        effort = torch.zeros((n, m.nd), device=self.device)
        effort[:, :7] = u
        targets = torch.zeros((n, m.nd), device=self.device)
        targets[:, fd] = fingers
        ctrl = dataclasses.replace(engine.Control.zero(m, n), effort=effort, pos_target=targets)
        return ctrl, dataclasses.replace(state, ts={**state.ts, "gripper_targets": fingers, "actions": actions})

    # ------------------------------------------------------------------
    def _scene_state(self, state):
        sim = state.sim
        rs = root_state(self.model, sim)
        return rs[:, self.cubeA_actor], rs[:, self.cubeB_actor], sim.body_pos[:, self.eef_body], \
            sim.body_quat[:, self.eef_body]

    def _observations(self, state, actions):
        cubeA, cubeB, eef_pos, eef_quat = self._scene_state(state)
        q = dof_pos(self.model, state.sim)
        tail = q[:, 7:9] if self.control_type == "osc" else q
        return torch.cat([cubeA[:, 3:7], cubeA[:, 0:3], cubeB[:, 0:3] - cubeA[:, 0:3], eef_pos, eef_quat, tail], -1)

    def _reward_done(self, state, obs, actions):
        sim = state.sim
        cubeA, cubeB, eef_pos, _ = self._scene_state(state)
        lf, rf = sim.body_pos[:, self.lf_body], sim.body_pos[:, self.rf_body]
        target_height = CUBE_B + CUBE_A / 2.0

        d = torch.linalg.norm(cubeA[:, 0:3] - eef_pos, dim=-1)
        d_lf = torch.linalg.norm(cubeA[:, 0:3] - lf, dim=-1)
        d_rf = torch.linalg.norm(cubeA[:, 0:3] - rf, dim=-1)
        dist_reward = 1 - torch.tanh(10.0 * (d + d_lf + d_rf) / 3)

        cubeA_height = cubeA[:, 2] - TABLE_HEIGHT
        cubeA_lifted = (cubeA_height - CUBE_A) > 0.04
        lift_reward = cubeA_lifted.to(torch.float32)

        to_b = cubeB[:, 0:3] - cubeA[:, 0:3]
        offset = torch.zeros_like(to_b)
        offset[:, 2] = (CUBE_A + CUBE_B) / 2
        d_ab = torch.linalg.norm(to_b + offset, dim=-1)
        align_reward = (1 - torch.tanh(10.0 * d_ab)) * cubeA_lifted
        dist_reward = torch.maximum(dist_reward, align_reward)

        aligned = torch.linalg.norm(to_b[:, :2], dim=-1) < 0.02
        on_top = torch.abs(cubeA_height - target_height) < 0.02
        gripper_away = d > 0.04
        stack_reward = aligned & on_top & gripper_away

        rewards = torch.where(stack_reward, self.r_stack * stack_reward,
                              self.r_dist * dist_reward + self.r_lift * lift_reward + self.r_align * align_reward)
        done = stack_reward | (state.progress >= self.max_episode_length - 1)
        info = {"episode": {"lift": lift_reward.mean(), "stack": stack_reward.to(torch.float32).mean()}}
        return state, rewards, done, info
