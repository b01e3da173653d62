"""Where B2 + B3 part from their plain version on FrankaCubeStack's reach states.

    python3 scripts/diag_franka_reach.py        # from the repo root, on a machine with an H100

Builds the kernels, then for two reach states at 8192 envs (40 acting steps
of chip_smoke.py's reaching command from the env's own start, the grip
site driven toward 2 cm and toward 3 cm above cube A's center, the gripper
open) and two controls of the next step (the gripper held open, or
closing), runs two substeps of B2 + B3 and of `split_substep_plain` from
the same state and names every env outside tests/test_fused_split.py's
tolerances (q, qd, contact force, slip_p) after the second substep, with
the decisions that could part them:
- a live-contact count that differs between the kernel and the plain
  version at the first or the second substep's start (the count witness
  of chip_smoke.py);
- a joint-limit decision (q above its upper or below its lower limit) that
  differs at the second substep's start;
- an active pair whose Coulomb clamp margin, |f_t| - mu f_n as the plain
  version computes it (`contact.stiction_force`), lies within 1e-4 N of 0
  at the first or the second substep: the stiction decision, which no
  witness of the split pair covers.
Prints how far the hand has pressed cube A into the table in each state,
then one line per state and control and one per env outside.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ENVS = 8192
HEIGHTS = (0.02, 0.03)  # the grip site's target above cube A's center
CLAMP_NEAR = 1e-4        # N: a clamp margin this close to 0 is reported
TOLS = {0: (5e-4, 5e-4), 1: (2e-3, 1e-2), 3: (2e-3, 5e-2), 6: (2e-3, 1e-5)}  # q, qd, contact force, slip_p


def reach_actions(env, state, height: float, grasp: bool = False) -> torch.Tensor:
    """chip_smoke.franka_reach_actions with the target's height a parameter."""
    cube_a, _, eef_pos, _ = env._scene_state(state)
    target = cube_a[:, 0:3] + torch.tensor([0.0, 0.0, height], device=env.device)
    actions = torch.zeros((env.num_envs, env.num_actions), device=env.device)
    actions[:, 0:3] = torch.clamp(10.0 * (target - eef_pos), -1.0, 1.0)
    actions[:, -1] = -1.0 if grasp else 1.0
    return actions


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("diag_franka_reach: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.envs import franka_cube_stack as fcs
    from isaacgymenv_tpu_torch.physics import contact, fused_split

    chip_smoke.build_all()
    env = isaacgymenv_tpu_torch.make("FrankaCubeStack", num_envs=N_ENVS)
    m = env.model
    n, h = env.num_envs, env.dt / env.substeps
    tables = fused_split.tables_for(m, env.device)
    qa = list(m.dof_q_adr)
    margins = []
    stiction = contact.stiction_force

    def recording(slip, v_t, nrm, fn, mu, kt_el, ct, hh, active):
        s = slip + v_t * hh
        s = s - (s * nrm).sum(-1, keepdim=True) * nrm
        f_trial = -kt_el[..., None] * s - ct[..., None] * v_t
        margins.append((torch.linalg.norm(f_trial, dim=-1) - mu * fn, active))
        return stiction(slip, v_t, nrm, fn, mu, kt_el, ct, hh, active)

    print(chip_smoke.card_line())
    for height in HEIGHTS:
        state = env.initial_state(seed=1)
        for _ in range(chip_smoke.FRANKA_REACH_STEPS):
            state, *_ = env.step(state, reach_actions(env, state, height))
        q, qd, slip_p = state.sim.q, state.sim.qd, state.sim.slip_p
        sunk = fcs.TABLE_HEIGHT + fcs.CUBE_A / 2 - env._scene_state(state)[0][:, 2]
        print(f"target {height} m above cube A: cube A's center below its resting height by up to "
              f"{float(sunk.max()):.4g} m (median {float(sunk.median()):.4g} m)")
        slip_g = torch.zeros((n, m.ng, 3), device=env.device)
        for grasp in (False, True):
            ctrl, _ = env._make_control(state, reach_actions(env, state, height, grasp), {})
            ctl = (ctrl.pos_target, ctrl.vel_target, ctrl.effort)
            k1 = fused_split.split_substep(tables, q, qd, *ctl, slip_g, slip_p, h, 1)
            k2 = fused_split.split_substep(tables, k1[0], k1[1], *ctl, k1[5], k1[6], h, 1)
            contact.stiction_force = recording
            margins.clear()
            try:  # records [ground, pairs] of each plain substep
                p1 = fused_split.split_substep_plain(tables, q, qd, *ctl, slip_g, slip_p, h, 1)
                p2 = fused_split.split_substep_plain(tables, p1[0], p1[1], *ctl, p1[5], p1[6], h, 1)
            finally:
                contact.stiction_force = stiction
            bad = torch.zeros(n, dtype=torch.bool, device=q.device)
            for i, (rtol, atol) in TOLS.items():
                bad |= ((k2[i] - p2[i]).abs() > atol + rtol * p2[i].abs()).reshape(n, -1).any(-1)
            flip1 = chip_smoke.count_flips(tables, (q, qd, slip_g, slip_p), (q, qd), h)
            flip2 = chip_smoke.count_flips(tables, (k1[0], k1[1], k1[5], k1[6]), (p1[0], p1[1]), h)
            lim2 = (((k1[0][:, qa] > m.dof_upper) != (p1[0][:, qa] > m.dof_upper))
                    | ((k1[0][:, qa] < m.dof_lower) != (p1[0][:, qa] < m.dof_lower))).any(-1)
            print(f"target {height} m above cube A, gripper {'closing' if grasp else 'open'}: {int(bad.sum())} of "
                  f"{n} envs outside the tolerances; count flips at substep 1 {int(flip1.sum())}, at substep 2 "
                  f"{int(flip2.sum())}; joint-limit decisions differing at substep 2 {int(lim2.sum())}")
            for e in bad.nonzero().flatten().tolist():
                errs = {name: f"{float((k2[i][e] - p2[i][e]).abs().max()):.4g}"
                        for name, i in (("q", 0), ("qd", 1), ("contact_force", 3), ("slip_p", 6))}
                near = []
                for sub, (margin, active) in ((1, margins[1]), (2, margins[3])):
                    pairs = ((margin[e].abs() < CLAMP_NEAR) & active[e]).nonzero().flatten().tolist()
                    near += [f"substep {sub} pair {p} (bodies {m.geom_body[m.pair_geom[p]]}, "
                             f"{m.surf_body[m.pair_surf[p]]}) margin {float(margin[e, p]):.3g} N" for p in pairs]
                print(f"  env {e}: max abs err {errs}; count flip {bool(flip1[e] | flip2[e])}; limit decision "
                      f"{bool(lim2[e])}; clamp margins within {CLAMP_NEAR} N: {near or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
