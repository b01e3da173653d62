"""The port's FrankaCubeStack slice against the JAX package on the CPU, N = 8 envs.

FrankaCubeStack is the split pair's scene with gravity compensation: the
Franka's 16 bodies compensated, the free cubes A and B (box surfaces, 8
corner spheres each) resting on the fixed table, 672 pairs.  Both packages
build the model once, in a module-scoped fixture.  The JAX side runs its
XLA path at -O0, one substep of `engine.step` compiled and chained
(tests/jax_reference.py); the JAX env step is compiled with that chain in
place of its physics and with the reset draws it makes from its state's
key, which are handed to the port.  The port runs the split kernels' plain
versions.  States are seeded with numpy: the arm near its default pose,
both cubes resting 0.5-1 mm into the table, cube A under the grip site in
two envs.

Tolerances (rtol / atol), fp32 throughout:
- model leaves 1e-5 / 1e-6, as tests/test_torch_anymal.py; the kernel
  table's gravcomp fields exact (the same fp32 product);
- the gravity compensation law alone (its moment, on a scene without
  contacts) 1e-6 / 1e-6: a 3x3 rotation of the COM and one cross product;
- the physics those of tests/test_fused_split.py: q 5e-4 / 5e-4, qd and
  dof_force 2e-3 / 1e-2, contact force and torque 2e-3 / 5e-2, slip_p
  2e-3 / 1e-5;
- the OSC torques 1e-4 / 1e-4 N m: two batched fp32 solves of the same
  7x7 and 6x6 systems;
- reset q, qd exact to 1e-6 (the same fp32 formulas on the same draws);
- env steps: obs 2e-3 / 5e-3, rew 1e-3 / 1e-4, gripper targets exact,
  done and time_outs exact.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.envs.franka_cube_stack import FrankaCubeStack as JaxFrankaCubeStack  # noqa: E402
from isaacgymenv_tpu.physics import builder as jax_builder  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import types as jax_types  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import compiled, env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.envs import franka_cube_stack as port_fcs  # noqa: E402
from isaacgymenv_tpu_torch.physics import builder, engine, fused, fused_split, kinematics, types  # noqa: E402

N = 8
STEP_TOLS = (("q", 5e-4, 5e-4), ("qd", 2e-3, 1e-2), ("dof_force", 2e-3, 1e-2), ("contact_force", 2e-3, 5e-2),
             ("contact_torque", 2e-3, 5e-2), ("slip_p", 2e-3, 1e-5))
OBS_TOL, REW_TOL = (2e-3, 5e-3), (1e-3, 1e-4)


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    return (JaxFrankaCubeStack(jax_task_config("FrankaCubeStack", num_envs=N)),
            isaacgymenv_tpu_torch.make(task="FrankaCubeStack", num_envs=N, device="cpu"))


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of FrankaCubeStack, one compiled substep chained."""
    jm = envs[0].model
    return substep_chain(jm, None, jax_types.make_zero_state(jm, N), jax_engine.Control.zero(jm, N))


def _resting(env, seed):
    """q, qd, finger targets, arm efforts, slip_p: the arm near its default
    pose (dofs within 0.25 rad), both cubes resting 0.5-1 mm into the table
    at a random yaw and settling at up to 5 cm/s, cube A under the grip site
    in envs 0 and 1."""
    rng = np.random.default_rng(seed)
    m = env.model
    q = np.zeros((N, m.nq), np.float32)
    lo, hi = m.dof_lower.numpy(), m.dof_upper.numpy()
    q[:, list(m.dof_q_adr)] = np.clip(np.asarray(port_fcs.FRANKA_DEFAULT) + 0.25 * rng.uniform(-1, 1, (N, m.nd)),
                                      lo, hi)
    q[:, [m.dof_q_adr[7], m.dof_q_adr[8]]] = rng.uniform(0.0, 0.04, (N, 2))
    eef = kinematics.fk(m, torch.tensor(q), torch.zeros(N, m.nv)).p_w[env.eef_body].numpy()
    qd = np.zeros((N, m.nv), np.float32)
    qd[:, list(m.dof_v_adr)] = 0.1 * rng.normal(size=(N, m.nd))
    for k, (body, size) in enumerate(((env.cubeA_body, port_fcs.CUBE_A), (env.cubeB_body, port_fcs.CUBE_B))):
        qa, va = m.q_adr[body], m.v_adr[body]
        q[:, qa:qa + 2] = rng.uniform(-0.25, 0.25, (N, 2)) + [0.0, 0.3 * (2 * k - 1)]
        q[:, qa + 2] = port_fcs.TABLE_HEIGHT + size / 2 - rng.uniform(0.0005, 0.001, N)
        yaw = rng.uniform(-0.785, 0.785, N)
        q[:, qa + 5], q[:, qa + 6] = np.sin(yaw / 2), np.cos(yaw / 2)
        qd[:, va:va + 6] = 0.02 * rng.normal(size=(N, 6))
        qd[:, va + 5] = -0.05 * rng.random(N)
    qa, qb = m.q_adr[env.cubeA_body], m.q_adr[env.cubeB_body]
    q[:2, qa:qa + 2] = eef[:2, :2]
    q[:2, qb:qb + 2] = eef[:2, :2] + [0.0, 0.2]
    tgt = np.zeros((N, m.nd), np.float32)
    tgt[:, 7:] = rng.uniform(0.0, 0.04, (N, 2))
    eff = np.zeros((N, m.nd), np.float32)
    eff[:, :7] = 0.3 * m.dof_effort[:7].numpy() * rng.uniform(-1, 1, (N, 7))
    slip = (1e-4 * rng.normal(size=(N, m.n_pairs, 3))).astype(np.float32)
    return q, qd, tgt, eff, slip


def _jax_state(jm, q, qd, slip):
    return jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))


def test_model_matches_jax_field_by_field(envs):
    """The model's tables against the JAX model's leaves, field by field, and
    the gravity compensation in the kernels' table: 16 Franka bodies
    compensated, the cubes, table and stand not."""
    jax_env, port_env = envs
    jm, tm = jax_env.model, port_env.model
    for f in dataclasses.fields(tm):
        if not f.init:
            continue
        ours, ref = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(ours, torch.Tensor):
            assert tuple(ours.shape) == np.shape(ref), f.name
            _close(ours, ref, 1e-5, 1e-6, f.name)
        elif ours is None or ref is None:
            assert ours is None and ref is None, f.name
        elif f.name != "sdf_dist":
            assert ours == ref, f.name
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng, tm.n_pairs, len(tm.surf_kind)) == (20, 23, 21, 9, 120, 672, 17)
    assert set(tm.surf_kind) == {1} and not (tm.anchor_body or tm.sensor_body or tm.tendon_dof or tm.no_ground)
    gc = tm.body_gravcomp.numpy()
    assert list(np.flatnonzero(gc)) == list(range(16)) and set(gc[:16]) == {1.0}
    assert (port_env.eef_body, port_env.lf_body, port_env.rf_body) == (jax_env.eef_body, jax_env.lf_body,
                                                                       jax_env.rf_body)
    # the kernels' table: gc_mass = gravcomp x mass (0 where a body keeps its gravity), the COMs
    table = fused_split.pack_model(tm).base
    np.testing.assert_array_equal(np.asarray(table.gc_mass[:tm.nb]), gc * tm.body_mass.numpy())
    np.testing.assert_array_equal(np.asarray(table.com[:3 * tm.nb]).reshape(-1, 3), tm.body_com.numpy())
    assert not any(table.gc_mass[tm.nb:])
    assert engine._use_fused(tm, torch.zeros(N, tm.nq)) == "split"
    for device in ("cuda", "cpu"):
        engine._check_supported(tm, None, "split", device)


def _piece(bld, gravcomp):
    """Three bodies of tests/test_fused.py's gravcomp scene (the free base
    and two revolute links, no geoms), compensated by `gravcomp`."""
    mb = bld.ModelBuilder()
    base = mb.add_body("base", -1, types.JT_FREE, mass=1.5, inertia=np.diag([0.01, 0.012, 0.014]),
                       com=(0, 0, 0.01), gravcomp=gravcomp[0])
    j1 = mb.add_body("j1", base, types.JT_REVOLUTE, joint_pos=(0.08, 0, 0), joint_axis=(0, 1, 0), joint_name="j1",
                     mass=0.2, com=(0, 0, -0.05), inertia=np.diag([4e-4] * 3), drive_mode=types.DRIVE_POS,
                     stiffness=20.0, damping=0.5, lower=-1.0, upper=1.0, has_limit=True, effort=10.0,
                     armature=0.001, maxvel=20.0, gravcomp=gravcomp[1])
    mb.add_body("j2", j1, types.JT_REVOLUTE, joint_pos=(0, 0, -0.1), joint_axis=(0, 1, 0), joint_name="j2",
                mass=0.1, com=(0.02, 0, -0.04), inertia=np.diag([2e-4] * 3), drive_mode=types.DRIVE_POS,
                stiffness=10.0, damping=0.3, lower=-1.0, upper=1.0, has_limit=True, effort=8.0, armature=0.001,
                maxvel=20.0, gravcomp=gravcomp[2])
    mb.gravity = np.array([0.0, 0.0, -9.81])
    return mb.finalize()


def test_gravcomp_law_matches_jax():
    """The plain law alone on a piece of tests/test_fused.py's gravcomp scene
    (gravcomp 1, 0.5 and 0 on its three bodies, random poses, no contacts):
    `engine.gravcomp_wrench` against the moment JAX's substep leaves in the
    contact torque, which holds only the gravity compensation here; one
    control step of `engine.step` (B1's kind, its plain version on the CPU)
    against JAX's."""
    gravcomp = (1.0, 0.5, 0.0)
    jm, tm = _piece(jax_builder, gravcomp), _piece(builder, gravcomp)
    rng = np.random.default_rng(4)
    q = np.zeros((N, tm.nq), np.float32)
    q[:, 0:3] = rng.normal(size=(N, 3))
    quat = rng.normal(size=(N, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.8, 0.8, (N, 2))
    qd = (0.5 * rng.normal(size=(N, tm.nv))).astype(np.float32)
    tgt = rng.uniform(-0.5, 0.5, (N, 2)).astype(np.float32)
    js0 = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    run = substep_chain(jm, None, js0, jax_engine.Control.zero(jm, N))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
    one = run(js0, jctrl, 0.01, 1)

    kin = kinematics.fk(tm, torch.tensor(q), torch.tensor(qd))
    w = engine.gravcomp_wrench(tm, torch.stack(kin.R_w, dim=-3))
    _close(w[..., :3], one.contact_torque, 1e-6, 1e-6, "gravcomp moment")
    m = tm.body_mass.numpy()
    want_f = -(np.float32(gravcomp) * m)[:, None] * np.float32([0.0, 0.0, -9.81])
    np.testing.assert_array_equal(w[..., 3:].numpy(), np.broadcast_to(want_f, (N, 3, 3)))
    assert float(w[:, 0, :3].abs().max()) > 1e-3 and not w[:, 2].any()

    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd))
    assert engine._use_fused(tm, ts0.q) == "mono"
    engine._check_supported(tm, None, "mono", "cuda")
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt))
    out = engine.step(tm, None, ts0, tctrl, 0.02, 2)
    ref = run(js0, jctrl, 0.02, 2)
    for field, rtol, atol in STEP_TOLS[:5]:
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)
    # B1's plain version is that loop
    tables = fused.tables_for(tm, "cpu")
    zero = torch.zeros(N, tm.nd)
    b1 = fused.fused_substep_plain(tables, ts0.q, ts0.qd, torch.tensor(tgt), zero, zero, None, 0.01, 2)
    assert all(torch.equal(a, b) for a, b in zip(b1[:5], (out.q, out.qd, out.dof_force, out.contact_force,
                                                          out.contact_torque)))


def test_engine_step_with_gravcomp_matches_jax(envs, jax_physics):
    """One control step of `engine.step` (the split kind; on the CPU its
    plain version) against JAX's XLA path from the cubes resting on the
    table, the arm on effort drive and the fingers on position drive; the
    contact torque of the compensated bodies holds the gravcomp moment;
    B2's and B3's plain versions compose to one substep."""
    jax_env, port_env = envs
    tm = port_env.model
    q, qd, tgt, eff, slip = _resting(port_env, 3)
    jctrl = jax_engine.Control.zero(jax_env.model, N).replace(pos_target=jnp.asarray(tgt), effort=jnp.asarray(eff))
    ref = jax_physics(_jax_state(jax_env.model, q, qd, slip), jctrl, port_env.dt, port_env.substeps)
    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd),
                              slip_p=torch.tensor(slip))
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt), effort=torch.tensor(eff))
    out = engine.step(tm, None, ts0, tctrl, port_env.dt, port_env.substeps)

    cf = np.linalg.norm(np.asarray(ref.contact_force), axis=-1)
    assert (cf[:, [port_env.cubeA_body, port_env.cubeB_body]] > 0).all(), "both cubes must rest on the table"
    # the Franka's links touch nothing, so their contact torque is the gravcomp moment alone
    assert np.abs(np.asarray(ref.contact_torque)[:, 1:8]).max() > 1.0 and not cf[:, 1:8].any()
    for field, rtol, atol in STEP_TOLS:
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)

    tables = fused_split.tables_for(tm, "cpu")
    h = port_env.dt / port_env.substeps
    args = (ts0.q, ts0.qd, tctrl.pos_target, tctrl.vel_target, tctrl.effort, torch.zeros(N, tm.ng, 3), ts0.slip_p)
    f_ext, cf1, ct1, sg1, sp1 = fused_split.contacts_plain(tables, args[0], args[1], args[5], args[6], h)
    q1, qd1, dof_force, _ = fused_split.dynamics_plain(tables, *args[:5], f_ext, h)
    one = fused_split.split_substep_plain(tables, *args, h, 1)
    for a, b in zip((q1, qd1, dof_force, cf1, ct1, sg1, sp1), one):
        assert torch.equal(a, b)


def test_osc_torques_match_jax(envs):
    """`_osc_torques` against JAX's from the same state and pose deltas:
    CRBA on the arm, the grip site's Jacobian and velocity, two solves."""
    jax_env, port_env = envs
    q, qd, *_ = _resting(port_env, 5)
    rng = np.random.default_rng(5)
    dpose = (rng.uniform(-1, 1, (N, 6)) * [0.1, 0.1, 0.1, 0.5, 0.5, 0.5]).astype(np.float32)
    jstate = JaxEnvState(sim=_jax_state(jax_env.model, q, qd, np.zeros((N, 672, 3), np.float32)),
                         progress=jnp.zeros(N, jnp.int32), reset=jnp.zeros(N, bool), rng=jax.random.PRNGKey(0), ts={})
    want = compiled(jax_env._osc_torques, jstate, jnp.asarray(dpose))(jstate, jnp.asarray(dpose))
    tstate = port_env.initial_state(seed=0)
    tstate = dataclasses.replace(tstate, sim=dataclasses.replace(tstate.sim, q=torch.tensor(q), qd=torch.tensor(qd)))
    got = port_env._osc_torques(tstate, torch.tensor(dpose))
    assert tuple(got.shape) == (N, 7) and float(np.abs(np.asarray(want)).max()) > 1.0
    _close(got, want, 1e-4, 1e-4, "osc torques")


def _jax_reset_draws(key, n):
    """The whole-batch draws of `FrankaCubeStack._reset_envs(state, mask, key)`."""
    k_cube, k_dof = jax.random.split(key)
    kb, ka, krots = jax.random.split(k_cube, 3)
    k1, k2 = jax.random.split(krots)
    u = jax.random.uniform
    return {"b_xy": u(kb, (n, 2)), "a_xy": u(ka, (n, 2)),
            "a_rounds": jnp.stack([u(jax.random.fold_in(ka, i + 1), (n, 2)) for i in range(port_fcs.RESAMPLE_ROUNDS)]),
            "yaw_a": u(k1, (n,)), "yaw_b": u(k2, (n,)), "dof": u(k_dof, (n, 9))}


def _to_port(jstate):
    return interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")


def test_reset_matches_jax_with_injected_draws(envs):
    """`_reset_envs` on a mask of envs with JAX's draws passed across: the
    cubes' spawn points with the 8 masked redraws of cube A (some used), the
    yaws, the Franka dofs with noise (fingers exact), the untouched envs."""
    jax_env, port_env = envs
    jm = jax_env.model
    q, qd, *_ = _resting(port_env, 8)
    sim = jax_engine.forward(jm, None, _jax_state(jm, q, qd, np.zeros((N, 672, 3), np.float32)))
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.full(N, 5, jnp.int32), reset=jnp.zeros(N, bool),
                                        rng=jax.random.PRNGKey(0), ts=jax_env._initial_ts(None)))
    mask = jnp.asarray(np.arange(N) % 4 != 1)
    key = jax.random.PRNGKey(11)

    def fn(st, m, k):
        return jax_env._reset_envs(st, m, k), _jax_reset_draws(k, N)

    want, draws = compiled(fn, jstate, mask, key)(jstate, mask, key)
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = port_env._reset_envs(_to_port(jstate), torch.tensor(np.asarray(mask)), draws)
    for field in ("q", "qd"):
        _close(getattr(got.sim, field), getattr(want.sim, field), 1e-6, 1e-6, field)
    _close(got.ts["gripper_targets"], want.ts["gripper_targets"], 0, 0, "gripper targets")
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(want.progress))
    # the redraws moved cube A in some env: its first draw lay within reach of cube B
    first = (np.asarray(draws["a_xy"]) - np.asarray(draws["b_xy"])) * 0.5
    assert (np.linalg.norm(first, axis=-1) < (port_fcs.CUBE_A + port_fcs.CUBE_B) * np.sqrt(2)).any()


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    """3 env steps from the resting cubes (two envs 3 steps from their time
    limit, so the deferred reset runs): obs, reward, done and time_outs, the
    gripper targets, the cubes' root states, through the OSC control."""
    jax_env, port_env = envs
    jm = jax_env.model
    q, qd, tgt, _, slip = _resting(port_env, 7)
    progress = np.where(np.isin(np.arange(N), [2, 5]), jax_env.max_episode_length - 3, 0).astype(np.int32)
    sim = jax_engine.forward(jm, None, _jax_state(jm, q, qd, slip))
    ts = {"actions": jnp.zeros((N, 7)), "gripper_targets": jnp.asarray(tgt[:, 7:])}
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool),
                                        rng=jax.random.PRNGKey(7), ts=ts))
    fn = lambda st, a: (jax_env.step(st, a), _jax_reset_draws(jax.random.split(st.rng, 3)[1], N))  # noqa: E731
    jstep = env_step(fn, jax_physics, jstate, jnp.zeros((N, 7)))
    tstate = _to_port(jstate)

    rng = np.random.default_rng(6)
    resets = 0
    for i in range(3):
        actions = rng.uniform(-1.0, 1.0, size=(N, 7)).astype(np.float32)
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
        _close(tobs["obs"], jobs["obs"], *OBS_TOL, f"obs, step {i}")
        _close(trew, jrew, *REW_TOL, f"rew, step {i}")
        _close(tstate.ts["gripper_targets"], jstate.ts["gripper_targets"], 0, 0, f"gripper targets, step {i}")
        rs = types.root_state(port_env.model, tstate.sim)[:, [port_env.cubeA_actor, port_env.cubeB_actor]]
        want = np.asarray(jax_types.root_state(jm, jstate.sim))[:, [port_env.cubeA_actor, port_env.cubeB_actor]]
        _close(rs, want, *OBS_TOL, f"cube root states, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(textras["episode"]["lift"], jextras["episode"]["lift"], 0, 0, "lift")
        resets += int(np.asarray(jstate.progress == 0).sum()) if i == 2 else 0
    assert np.asarray(jextras["time_outs"]).sum() == 0 and resets == 2, "the two timed-out envs must have reset"


def test_joint_torque_control_matches_jax(envs):
    """`controlType: joint_tor`: 8 actions (arm torques scaled by the effort
    limits, the binary gripper) and the 26-wide obs, against JAX's on the
    module's model."""
    jax_env, _ = envs
    port_env = isaacgymenv_tpu_torch.make(task="FrankaCubeStack", num_envs=N, device="cpu",
                                          **{"env.controlType": "joint_tor"})
    assert (port_env.num_obs, port_env.num_actions) == (26, 8)
    jt = copy.copy(jax_env)
    jt.control_type, jt.num_obs, jt.num_actions = "joint_tor", 26, 8
    q, qd, *_ = _resting(port_env, 9)
    sim = jax_engine.forward(jt.model, None, _jax_state(jt.model, q, qd, np.zeros((N, 672, 3), np.float32)))
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.zeros(N, jnp.int32), reset=jnp.zeros(N, bool),
                                        rng=jax.random.PRNGKey(0), ts=jt._initial_ts(None)))
    actions = jnp.asarray(np.random.default_rng(9).uniform(-1.5, 1.5, (N, 8)).astype(np.float32))

    def fn(st, a):
        ctrl, st = jt._make_control(st, a)
        return ctrl.effort, ctrl.pos_target, st.ts["gripper_targets"], jt._observations(st, a)

    want = compiled(fn, jstate, actions)(jstate, actions)
    tstate = _to_port(jstate)
    ctrl, tstate = port_env._make_control(tstate, torch.tensor(np.asarray(actions)), {})
    got = (ctrl.effort, ctrl.pos_target, tstate.ts["gripper_targets"],
           port_env._observations(tstate, torch.tensor(np.asarray(actions))))
    for name, g, w in zip(("effort", "pos_target", "gripper targets", "obs"), got, want):
        _close(g, w, 1e-6, 1e-6, name)
    assert float(np.abs(np.asarray(want[0])).max()) > 10.0
