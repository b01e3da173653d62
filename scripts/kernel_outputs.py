"""The port's kernels on fixed seeded inputs, to hold two builds bit for bit.

    python3 scripts/kernel_outputs.py OUT.pt            # from the root of a tree
    python3 scripts/kernel_outputs.py --compare A.pt B.pt

Run from the root of a checkout (it imports `isaacgymenv_tpu_torch` and
`chip_smoke` from the working directory, so another tree's code runs with
this script: `cd other && python3 ../scripts/kernel_outputs.py ...`, the
robot files from ISAACGYMENV_TPU_ASSET_ROOT when that tree has none), it
builds that tree's kernel sources and runs on the card, on the inputs of
chip_smoke.py's numpy-seeded states, each wrapper once:
- B1 on Anymal at 4096 envs (`near_standing_state`), 4 substeps;
- B1 in wrench mode at 8192 Quadcopter envs (`quad_flight_state`);
- B2 + B3 on ShadowHand at 16384 envs with the cube on the palm
  (`cube_on_palm_state`), 2 substeps;
- B2 with anchors + B3 with the tray's sensor at 4096 BallBalance envs
  (`ball_on_tray_state`), 4 substeps;
and saves every output with the card's name.  `--compare` holds the
outputs both files have to be equal bit for bit, and names those only one
has.  None of these scenes has gravity compensation, so two builds that
differ only in that mode must agree exactly.
"""

from __future__ import annotations

import os
import sys

import torch


def outputs() -> dict:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import isaacgymenv_tpu_torch
    from isaacgymenv_tpu_torch.physics import fused, fused_split

    out = {}
    env = isaacgymenv_tpu_torch.make("Anymal", num_envs=4096)
    q, qd, tgt, slip = (t.to(env.device) for t in chip_smoke.near_standing_state(env, 4096, seed=1))
    zero = torch.zeros_like(tgt)
    res = fused.fused_substep(fused.tables_for(env.model, env.device), q, qd, tgt, zero, zero, slip,
                              env.dt / env.substeps, env.substeps)
    out["B1 Anymal"] = res[:6]

    env = isaacgymenv_tpu_torch.make("Quadcopter", num_envs=8192)
    q, qd, tgt, bw = (t.to(env.device) for t in chip_smoke.quad_flight_state(env, 8192, seed=1))
    zero = torch.zeros_like(tgt)
    res = fused.fused_substep(fused.tables_for(env.model, env.device), q, qd, tgt, zero, zero, None,
                              env.dt / env.substeps, env.substeps, body_wrench=bw)
    out["B1 wrench Quadcopter"] = res[:5]

    for task, n, state in (("ShadowHand", 16384, chip_smoke.cube_on_palm_state),
                           ("BallBalance", 4096, chip_smoke.ball_on_tray_state)):
        env = isaacgymenv_tpu_torch.make(task, num_envs=n)
        q, qd, tgt, slip_p = (t.to(env.device) for t in state(env, n, seed=1))
        zero = torch.zeros_like(tgt)
        slip_g = torch.zeros((n, env.model.ng, 3), device=env.device)
        res = fused_split.split_substep(fused_split.tables_for(env.model, env.device), q, qd, tgt, zero, zero,
                                        slip_g, slip_p, env.dt / env.substeps, env.substeps)
        out[f"B2 + B3 {task}"] = tuple(t for t in res if t is not None)
        del env
    torch.cuda.synchronize()
    return {k: tuple(t.cpu() for t in v) for k, v in out.items()}


def compare(a_path: str, b_path: str) -> int:
    a, b = (torch.load(p, weights_only=True) for p in (a_path, b_path))
    print(f"{a_path}: {a['card']}; {b_path}: {b['card']}")
    bad = 0
    for key in sorted(set(a["outputs"]) | set(b["outputs"])):
        if key not in a["outputs"] or key not in b["outputs"]:
            print(f"{key}: only in {a_path if key in a['outputs'] else b_path}")
            continue
        xs, ys = a["outputs"][key], b["outputs"][key]
        same = len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))
        diff = [float((x - y).abs().max()) for x, y in zip(xs, ys)]
        print(f"{key}: {len(xs)} outputs, {'bit for bit equal' if same else f'DIFFER, max abs diff {diff}'}")
        bad += not same
    return 1 if bad else 0


def main(argv) -> int:
    if argv[:1] == ["--compare"]:
        return compare(*argv[1:3])
    if not torch.cuda.is_available():
        print("kernel_outputs: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.save({"card": torch.cuda.get_device_name(0), "outputs": outputs()}, argv[0])
    print(f"kernel_outputs: wrote {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
