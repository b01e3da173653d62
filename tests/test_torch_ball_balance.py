"""The port's BallBalance slice against the JAX package on the CPU, N = 8 envs.

BallBalance is the split pair's scene with world anchors (the three feet)
and a force sensor (the tray).  Both packages build its procedural model
once, in a module-scoped fixture.  The JAX side runs its XLA path at -O0,
one substep of `engine.step` compiled and chained (tests/jax_reference.py);
the JAX env step is compiled with that chain in place of its physics and
with the reset draws it makes from its state's key, which are handed to the
port.  The port runs the split kernels' plain versions.  States are seeded
with numpy: the bot near its default pose, the ball on the tray.

Tolerances (rtol / atol), fp32 throughout:
- model leaves 1e-5 / 1e-6, as tests/test_torch_anymal.py;
- the anchors' f_ext 1e-5 relative, 1e-5 of its largest entry absolute:
  the same fp32 spring-damper, whose stiff gain 0.2 m / h^2 scales the
  rounding of the displacement;
- the physics those of tests/test_fused_split.py: q 5e-4 / 5e-4, qd and
  dof_force 2e-3 / 1e-2, contact force and torque 2e-3 / 5e-2, slip_p
  2e-3 / 1e-5;
- the tray sensor's joint wrench 1e-3 absolute, never relative: the tray's
  joint is free, so its wrench is zero in exact arithmetic and both
  packages read rounding noise (a few 1e-5 N);
- env steps: obs 2e-3 / 5e-3, its 12 sensor entries (indices 12-23) 1e-4
  absolute; rew 1e-3 / 1e-4; dof targets 1e-6 / 1e-6; done and time_outs
  exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.ball_balance import BallBalance as JaxBallBalance  # noqa: E402
from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.ops import maths as jax_maths  # noqa: E402
from isaacgymenv_tpu.physics import contact as jax_contact  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import types as jax_types  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import compiled, env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.physics import contact, engine, fused_split, types  # noqa: E402

N = 8
STEP_TOLS = (("q", 5e-4, 5e-4), ("qd", 2e-3, 1e-2), ("dof_force", 2e-3, 1e-2), ("contact_force", 2e-3, 5e-2),
             ("contact_torque", 2e-3, 5e-2), ("slip_p", 2e-3, 1e-5), ("joint_wrench", 0.0, 1e-3))
OBS_TOL, SENSOR_OBS_TOL, REW_TOL = (2e-3, 5e-3), (0.0, 1e-4), (1e-3, 1e-4)
SENSORS = slice(12, 24)  # the tray sensor's 12 entries of the 24-wide obs


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    return (JaxBallBalance(jax_task_config("BallBalance", num_envs=N)),
            isaacgymenv_tpu_torch.make(task="BallBalance", num_envs=N, device="cpu"))


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of BallBalance, one compiled substep chained."""
    jm = envs[0].model
    return substep_chain(jm, None, jax_types.make_zero_state(jm, N), jax_engine.Control.zero(jm, N))


def _ball_on_tray(env, seed):
    """q, qd, pos_target, slip_p: the bot near its default pose (the feet near
    their anchors), the ball 0.5-2 mm into the tray within 0.3 m of its
    center, rolling at up to 1.4 m/s."""
    rng = np.random.default_rng(seed)
    m = env.model
    ball = m.actor_root[env.ball_actor]
    tq, bq, bv = m.q_adr[env.tray_body], m.q_adr[ball], m.v_adr[ball]
    q = np.zeros((N, m.nq), np.float32)
    q[:, tq + 2] = env.tray_height + 0.002 * rng.uniform(-1, 1, N)
    quat = rng.normal(size=(N, 4)) * 0.005 + [0.0, 0.0, 0.0, 1.0]
    q[:, tq + 3:tq + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, list(m.dof_q_adr)] = 0.02 * rng.uniform(-1, 1, (N, m.nd))
    r, th = 0.3 * np.sqrt(rng.random(N)), rng.uniform(-np.pi, np.pi, N)
    q[:, bq], q[:, bq + 1] = r * np.cos(th), r * np.sin(th)
    q[:, bq + 2] = env.tray_height + 0.01 + env.ball_radius - rng.uniform(0.0005, 0.002, N)
    q[:, bq + 6] = 1.0
    qd = np.zeros((N, m.nv), np.float32)
    qd[:, :bv] = 0.05 * rng.normal(size=(N, bv))
    qd[:, bv + 3:bv + 5] = rng.uniform(-1.0, 1.0, (N, 2))
    tgt = (0.02 * rng.uniform(-1, 1, (N, m.nd))).astype(np.float32)
    slip = (1e-4 * rng.normal(size=(N, m.n_pairs, 3))).astype(np.float32)
    return q, qd, tgt, slip


def _jax_step(envs, jax_physics, q, qd, tgt, slip):
    jax_env, port_env = envs
    jm = jax_env.model
    js0 = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
    return jax_physics(js0, jctrl, port_env.dt, port_env.substeps)


def test_model_matches_jax_field_by_field(envs):
    """The model's tables against the JAX model's leaves: anchors, pairs,
    sensor, masses and inertias, field by field."""
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
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng, tm.n_pairs) == (8, 20, 18, 6, 1, 7)
    assert tm.anchor_body == (2, 4, 6) and tm.sensor_body == (0,) and tm.anchor_offset.shape == (3, 3)
    assert port_env.actuated == list(jax_env.actuated)


def test_anchor_forces_match_jax(envs):
    """`contact.anchor_forces` against JAX's on body poses and velocities
    drawn about the feet's anchors: f_ext on the three feet, zero elsewhere."""
    jax_env, port_env = envs
    jm, tm = jax_env.model, port_env.model
    rng = np.random.default_rng(9)
    quat = rng.normal(size=(N, tm.nb, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    R = np.asarray(jax_maths.quat_to_rotmat(jnp.asarray(quat, jnp.float32)))
    pos = np.zeros((N, tm.nb, 3), np.float32)
    pos[:, list(tm.anchor_body)] = tm.anchor_target.numpy() + 0.01 * rng.normal(size=(N, len(tm.anchor_body), 3))
    lin, ang = (rng.normal(size=(N, tm.nb, 3)).astype(np.float32) for _ in range(2))
    h = port_env.dt / port_env.substeps
    args = [jnp.asarray(a) for a in (pos, R, lin, ang)]
    want = np.asarray(compiled(lambda *a: jax_contact.anchor_forces(jm, *a, h), *args)(*args))
    got = contact.anchor_forces(tm, *(torch.tensor(np.asarray(a)) for a in args), h)
    assert tuple(got.shape) == want.shape == (N, tm.nb, 6)
    scale = np.abs(want).max()
    assert scale > 1.0, "the anchors must pull"
    _close(got, want, 1e-5, 1e-5 * scale, "anchor f_ext")
    free = [b for b in range(tm.nb) if b not in tm.anchor_body]
    assert not got[:, free].any()


def test_engine_step_with_anchors_and_tray_sensor_matches_jax(envs, jax_physics):
    """One control step of `engine.step` (the split kind; on the CPU its
    plain version) against JAX's XLA path."""
    port_env = envs[1]
    tm = port_env.model
    q, qd, tgt, slip = _ball_on_tray(port_env, 3)
    ref = _jax_step(envs, jax_physics, q, qd, tgt, slip)
    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd),
                              slip_p=torch.tensor(slip))
    assert engine._use_fused(tm, ts0.q) == "split"
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt))
    out = engine.step(tm, None, ts0, tctrl, port_env.dt, port_env.substeps)

    on_tray = np.linalg.norm(np.asarray(ref.contact_force)[:, 0], axis=-1) > 0
    assert on_tray.sum() >= N // 2, "the ball must load the tray"
    # the anchors' moments about the lower legs' origins are in the contact torque
    assert np.abs(np.asarray(ref.contact_torque)[:, list(tm.anchor_body)]).max() > 1e-3
    assert tuple(out.joint_wrench.shape) == (N, 1, 6)
    for field, rtol, atol in STEP_TOLS:
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def test_split_plain_pair_with_anchors_and_sensor_matches_jax(envs, jax_physics):
    """`split_substep_plain` against JAX `engine.step` on the same state; B2's
    and B3's plain versions compose to it; the wrapper on a CPU state runs
    the plain version."""
    jax_env, port_env = envs
    tm = port_env.model
    q, qd, tgt, slip = _ball_on_tray(port_env, 5)
    ref = _jax_step(envs, jax_physics, q, qd, tgt, slip)
    tables = fused_split.tables_for(tm, "cpu")
    zero = torch.zeros(N, tm.nd)
    h = port_env.dt / port_env.substeps
    args = (torch.tensor(q), torch.tensor(qd), torch.tensor(tgt), zero, zero, torch.zeros(N, tm.ng, 3),
            torch.tensor(slip), h)
    out = fused_split.split_substep_plain(tables, *args, port_env.substeps)
    names = ("q", "qd", "dof_force", "contact_force", "contact_torque", "slip_g", "slip_p", "joint_wrench")
    tols = dict((k, (r, a)) for k, r, a in STEP_TOLS)
    for name, got in zip(names, out):
        if name in tols:
            _close(got, getattr(ref, name), *tols[name], name)

    # B2's plain version, then B3's, is one substep of the pair
    f_ext, cf, ct, slip_g1, slip_p1 = fused_split.contacts_plain(tables, args[0], args[1], args[5], args[6], h)
    q1, qd1, dof_force, jw = fused_split.dynamics_plain(tables, *args[:5], f_ext, h)
    one = fused_split.split_substep_plain(tables, *args, 1)
    for a, b in zip((q1, qd1, dof_force, cf, ct, slip_g1, slip_p1, jw), one):
        assert torch.equal(a, b)
    # the wrapper on a CPU state: the plain version, no launch, the sensor wrenches last
    before = (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches)
    wrapped = fused_split.split_substep(tables, *args, port_env.substeps)
    assert (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches) == before
    assert len(wrapped) == 8 and all(torch.equal(a, b) for a, b in zip(wrapped, out))


def test_gate_sends_anchors_and_sensors_to_the_split_pair(envs):
    """The anchors travel in the split table, under a cap; the gate runs
    anchors and sensors on the split pair on the card, refuses anchors on
    B1 on either device, and sensors off both kernels on the card."""
    tm = envs[1].model
    table = fused_split.pack_model(tm)
    assert table.na == 3 and list(table.anchor_body[:3]) == [2, 4, 6]
    _close(np.asarray(table.anchor_target[:9]).reshape(3, 3), tm.anchor_target, 0, 0, "anchor_target")
    _close(np.asarray(table.anchor_meff[:3]), tm.anchor_meff, 0, 0, "anchor_meff")
    many = dataclasses.replace(tm, anchor_body=(2,) * (fused_split.MAX_ANCHORS + 1))
    assert fused_split.split_structural_ok(tm) and not fused_split.split_structural_ok(many)
    engine._check_supported(tm, None, "split", "cuda")
    engine._check_supported(tm, None, None, "cpu")
    for device in ("cuda", "cpu"):
        with pytest.raises(NotImplementedError, match="world anchors on B1"):
            engine._check_supported(tm, None, "mono", device)
    with pytest.raises(NotImplementedError, match="force sensors off the kernels"):
        engine._check_supported(tm, None, None, "cuda")


def _jax_reset_draws(key, n):
    """The whole-batch draws of `BallBalance._reset_envs(state, mask, key)`."""
    kd, kdir, kh, khs, _ = jax.random.split(key, 5)
    return {"dist": jax.random.uniform(kd, (n,), minval=0.001, maxval=0.5),
            "theta": jax.random.uniform(kdir, (n,), minval=-np.pi, maxval=np.pi),
            "height": jax.random.uniform(kh, (n,), minval=1.0, maxval=2.0),
            "hspeed": jax.random.uniform(khs, (n,), minval=0.0, maxval=5.0)}


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    """3 env steps from the ball on the tray (two envs 3 steps from their time
    limit, one ball below 1.5 radii): obs with the sensor entries, reward,
    done and time_outs, the integrated dof targets, through a reset."""
    jax_env, port_env = envs
    jm = jax_env.model
    q, qd, tgt, slip = _ball_on_tray(port_env, 7)
    bq = jm.q_adr[jm.actor_root[1]]
    q[4, bq:bq + 3] = (0.8, 0.0, 0.12)  # off the tray, below 1.5 radii, clear of the ground
    progress = np.where(np.isin(np.arange(N), [1, 6]), jax_env.max_episode_length - 3, 0).astype(np.int32)
    key = jax.random.PRNGKey(7)
    sim = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))
    ts = {"dof_targets": jnp.asarray(tgt[:, jax_env.actuated])}
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool),
                                        rng=key, ts=ts))
    fn = lambda st, a: (jax_env.step(st, a), _jax_reset_draws(jax.random.split(st.rng, 3)[1], N))  # noqa: E731
    jstep = env_step(fn, jax_physics, jstate, jnp.zeros((N, 3)))
    tstate = interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")

    rng = np.random.default_rng(6)
    seen = {"reset": False, "timeout": False}
    for i in range(3):
        actions = rng.uniform(-1.0, 1.0, size=(N, 3)).astype(np.float32)
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
        _close(tobs["obs"], jobs["obs"], *OBS_TOL, f"obs, step {i}")
        _close(tobs["obs"][:, SENSORS], np.asarray(jobs["obs"])[:, SENSORS], *SENSOR_OBS_TOL, f"sensor obs, step {i}")
        _close(trew, jrew, *REW_TOL, f"rew, step {i}")
        _close(tstate.ts["dof_targets"], jstate.ts["dof_targets"], 1e-6, 1e-6, f"dof targets, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        seen["reset"] |= bool(np.asarray(jdone)[4]) and i == 0
        seen["timeout"] |= bool(np.asarray(jextras["time_outs"]).any())
    assert all(seen.values()), f"every branch must run: {seen}"
    assert np.asarray(jstate.progress)[4] == 1, "the fallen ball's env must have been reset"
