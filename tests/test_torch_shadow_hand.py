"""The port's ShadowHand slice against the JAX package on the CPU, N = 8 envs.

The JAX ShadowHand is built once, in a module-scoped fixture; its physics
runs the XLA path (`engine.step` on the CPU backend), which
tests/test_fused_split.py holds the Pallas split pair against, compiled at
XLA optimization level 0 once, as one substep chained (tests/jax_reference.py),
with a body wrench (zero where the control has none: f_ext + 0, the same
numbers); the JAX env step is compiled with that chain in place of its
physics and with the draws it makes from its state's key.  The
ShadowHandOpenAI_FF env of the JAX package (openai obs, asymmetric states,
random object forces) reuses that model: only its task logic is new.  The port runs its split kernels' plain version
(`split_substep_plain`, the `engine._substep` loop).  States are seeded with
numpy, with the cube resting on the palm so that pair contacts are active;
reset and goal draws repeat the JAX package's key splits and are handed to
both packages.

Tolerances (rtol / atol), fp32 throughout:
- model leaves 1e-5 / 1e-6: the same float64 host math rounded once (the
  effective masses are formed in fp32 by both);
- _surface_closest 1e-5 / 1e-6 and passive_force 1e-5 / 1e-4: the same
  elementwise formulas;
- engine.step those of tests/test_fused_split.py:93-152: q 5e-4 / 5e-4,
  qd and dof_force 2e-3 / 1e-2, contact force and torque 2e-3 / 5e-2,
  slip_p 2e-3 / 1e-5; body_pos as q;
- env steps: obs 2e-3 / 5e-3, as the Anymal slice's (the observation holds
  10 x the dof force and the fingertip contact wrench, clipped at 5; the
  measured error is under 1e-5), and so the openai obs and the 211-wide
  states, rew 1e-3 / 1e-3 (1 / (rot_dist + 0.1) amplifies a rotation error
  up to 100x), done and time_outs exact; the object force (rb_force) 1e-6 /
  1e-7: a decay factor or a draw times the mass, elementwise;
- the policy 1e-5: the same fp32 matmuls.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.envs.shadow_hand import ShadowHand as JaxShadowHand  # noqa: E402
from isaacgymenv_tpu.learning.networks import ActorCritic as JaxActorCritic  # noqa: E402
from isaacgymenv_tpu.physics import contact as jax_contact  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics.types import make_zero_state as jax_zero_state  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import compiled, env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.learning.networks import ActorCritic  # noqa: E402
from isaacgymenv_tpu_torch.ops import maths  # noqa: E402
from isaacgymenv_tpu_torch.physics import contact, engine, fused_split, kinematics, types  # noqa: E402
from isaacgymenv_tpu_torch.utils.config import load_train_config  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def envs():
    return (
        JaxShadowHand(jax_task_config("ShadowHand", num_envs=N)),
        isaacgymenv_tpu_torch.make(task="ShadowHand", num_envs=N, device="cpu"),
    )


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of the hand scene, one compiled substep chained,
    compiled with a body wrench: a control without one gets zeros."""
    jm = envs[0].model
    zero_wrench = jnp.zeros((N, jm.nb, 6))
    run = substep_chain(jm, None, jax_zero_state(jm, N),
                        jax_engine.Control.zero(jm, N).replace(body_wrench=zero_wrench))

    def run_any(s, c, dt, substeps):
        return run(s, c if c.body_wrench is not None else c.replace(body_wrench=zero_wrench), dt, substeps)

    run_any.model, run_any.forward = run.model, run.forward
    return run_any


# what JaxShadowHand._build_model sets: the OpenAI env reuses the built model
_MODEL_ATTRS = ("model", "_info", "fingertip_bodies", "object_actor", "object_body", "actuated", "dof_lower",
                "dof_upper", "object_init", "object_mass")


@pytest.fixture(scope="module")
def openai_envs(envs):
    """ShadowHandOpenAI_FF in both packages; the JAX one on the module's model."""
    jax_env = envs[0]
    build = lambda self, cfg: self.__dict__.update({k: getattr(jax_env, k) for k in _MODEL_ATTRS})  # noqa: E731
    with mock.patch.object(JaxShadowHand, "_build_model", build):
        jenv = JaxShadowHand(jax_task_config("ShadowHandOpenAI_FF", num_envs=N))
    return jenv, isaacgymenv_tpu_torch.make(task="ShadowHandOpenAI_FF", num_envs=N, device="cpu")


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _cube_on_palm(env, seed):
    """q, qd, pos_target, slip_p: hand dofs near zero within their limits
    (wrist at zero), the cube 0.5-2 mm into the top face of the palm,
    slightly tilted."""
    rng = np.random.default_rng(seed)
    m = env.model
    q = np.zeros((N, m.nq), np.float32)
    dq = np.clip(0.15 * rng.normal(size=(N, m.nd)), m.dof_lower.numpy(), m.dof_upper.numpy())
    dq[:, [m.dof_names.index("robot0:WRJ1"), m.dof_names.index("robot0:WRJ0")]] = 0.0
    q[:, list(m.dof_q_adr)] = dq
    kin = kinematics.fk(m, torch.zeros(1, m.nq), torch.zeros(1, m.nv))
    palm = m.body_names.index("robot0:palm")
    s = max((i for i, b in enumerate(m.surf_body) if b == palm), key=lambda i: float(m.surf_size[i].prod()))
    R, p = kin.R_w[palm][0].numpy(), kin.p_w[palm][0].numpy()
    off, half = m.surf_offset[s].numpy(), m.surf_size[s].numpy()
    signs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
    top = (p + (off + signs * half) @ R.T)[:, 2].max()
    center = p + R @ off
    qa = m.q_adr[env.object_body]
    # 2 cm off the palm box's center toward the little finger, clear of the thumb
    q[:, qa] = center[0] + 0.02 + 0.003 * rng.uniform(-1, 1, N)
    q[:, qa + 1] = center[1] + 0.008 * rng.uniform(-1, 1, N)
    q[:, qa + 2] = top + 0.025 - rng.uniform(0.0005, 0.002, N)  # cube half extent 0.025
    quat = rng.normal(size=(N, 4)) * 0.01 + [0.0, 0.0, 0.0, 1.0]
    q[:, qa + 3:qa + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qd = (0.2 * rng.normal(size=(N, m.nv))).astype(np.float32)
    tgt = (dq + 0.2 * rng.normal(size=(N, m.nd))).astype(np.float32)
    slip = (1e-4 * rng.normal(size=(N, m.n_pairs, 3))).astype(np.float32)
    return q, qd, tgt, slip


def test_model_matches_jax_field_by_field(envs):
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
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng, tm.n_pairs) == (27, 31, 30, 24, 96, 256)
    assert len(tm.tendon_dof) == 4 and tm.no_ground
    assert port_env.fingertip_bodies == [int(b) for b in jax_env.fingertip_bodies]
    assert port_env.actuated == [int(d) for d in jax_env.actuated]


_jax_surface_closest = jax.jit(jax_contact._surface_closest)  # one compile serves the four kinds


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_surface_closest_matches_jax(kind):
    rng = np.random.default_rng(20 + kind)
    size = np.tile((0.02 + 0.03 * rng.random(3)).astype(np.float32), (64, 1))
    local = (rng.uniform(-2.0, 2.0, size=(N, 64, 3)) * size).astype(np.float32)
    kinds = np.full(64, kind, np.int32)
    jn, jd = _jax_surface_closest(jnp.asarray(kinds), jnp.asarray(local), jnp.asarray(size))
    tn, td = contact._surface_closest(torch.tensor(kinds), torch.tensor(local), torch.tensor(size))
    assert (np.asarray(jd) < 0).any() and (np.asarray(jd) > 0).any(), "points inside and outside"
    _close(tn, jn, 1e-5, 1e-6, "normal")
    _close(td, jd, 1e-5, 1e-6, "distance")


def test_passive_force_with_violated_tendons(envs):
    jax_env, port_env = envs
    rng = np.random.default_rng(3)
    pos = (0.4 * rng.normal(size=(N, 24))).astype(np.float32)
    vel = (2.0 * rng.normal(size=(N, 24))).astype(np.float32)
    m = port_env.model
    td, tc = np.asarray(m.tendon_dof), m.tendon_coef.numpy()
    length = (pos[:, td] * tc).sum(-1)
    lo, hi = m.tendon_range.numpy().T
    assert ((length < lo) | (length > hi)).mean() > 0.5, "most tendons violated"
    want = jax.jit(lambda p, v: jax_engine.passive_force(jax_env.model, p, v))(jnp.asarray(pos), jnp.asarray(vel))
    got = engine.passive_force(m, torch.tensor(pos), torch.tensor(vel))
    _close(got, want, 1e-5, 1e-4)


def test_pair_table_rows_come_from_the_model(envs):
    _, port_env = envs
    m = port_env.model
    pint, pflt = fused_split.pack_pairs(m)
    assert pint.shape == (256, fused_split.PI_N) and pflt.shape == (256, fused_split.PF_N)
    for p in (0, 87, 88, 200, 255):
        g, s = m.pair_geom[p], m.pair_surf[p]
        assert list(pint[p]) == [g, m.geom_body[g], m.surf_body[s], m.surf_kind[s]]
        row = pflt[p]
        np.testing.assert_array_equal(row[fused_split.PF_RG], m.geom_radius[g].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_MG], m.geom_meff[g].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_MGEL], m.geom_meff_el[g].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_MS], m.surf_meff[s].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_MSEL], m.surf_meff_el[s].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_MU], torch.sqrt(m.geom_friction[g] * m.surf_friction[s]).numpy())
        np.testing.assert_array_equal(row[fused_split.PF_OFF:fused_split.PF_OFF + 3], m.surf_offset[s].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_SIZE:fused_split.PF_SIZE + 3], m.surf_size[s].numpy())
        np.testing.assert_array_equal(row[fused_split.PF_ROTM:fused_split.PF_ROTM + 9], m.surf_rotm[s].reshape(9).numpy())
        np.testing.assert_array_equal(row[fused_split.PF_GOFF:fused_split.PF_GOFF + 3], m.geom_offset[g].numpy())
    # geom-major: the 88 hand spheres against the cube, then the 8 cube
    # spheres against the 21 hand surfaces
    assert (pint[:88, fused_split.PI_SB] == port_env.object_body).all()
    assert (pint[88:, fused_split.PI_GB] == port_env.object_body).all()


def test_engine_step_matches_jax_xla_path(envs, jax_physics):
    jax_env, port_env = envs
    q, qd, tgt, slip = _cube_on_palm(port_env, 4)
    jm, tm = jax_env.model, port_env.model
    js0 = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
    dt = jax_env.dt
    ref = jax_physics(js0, jctrl, dt, 2)

    ts0 = dataclasses.replace(
        types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd), slip_p=torch.tensor(slip)
    )
    assert engine._use_fused(tm, ts0.q) == "split"
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt))
    out = engine.step(tm, None, ts0, tctrl, dt, 2)

    # no ground pass: any contact force at the last substep is a pair contact
    in_contact = (np.linalg.norm(np.asarray(ref.contact_force), axis=-1) > 0).any(-1)
    assert in_contact.sum() >= N // 4, "the pair-contact path must be exercised"
    for field, rtol, atol in (
        ("q", 5e-4, 5e-4), ("qd", 2e-3, 1e-2), ("dof_force", 2e-3, 1e-2),
        ("contact_force", 2e-3, 5e-2), ("contact_torque", 2e-3, 5e-2),
        ("slip_p", 2e-3, 1e-5), ("body_pos", 5e-4, 5e-4),
    ):
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def _body_wrench(env, seed):
    """(N, nb, 6) world [moment, force]: small on the hand's moving bodies,
    a 0.5 N force and a 2e-3 N m moment on the cube, and 1 N m, 3 N on the
    two fixed bodies at the root (no motion: welded to the world), where a
    wrench leaking into the contact torque would show 20x the tolerance."""
    rng = np.random.default_rng(seed)
    m = env.model
    w = rng.normal(size=(N, m.nb, 6)) * np.array([1e-3] * 3 + [1e-2] * 3)
    w[:, env.object_body] = rng.normal(size=(N, 6)) * np.array([2e-3] * 3 + [0.5] * 3)
    w[:, :2] = rng.choice([-1.0, 1.0], size=(N, 2, 6)) * np.array([1.0] * 3 + [3.0] * 3)
    assert m.body_names[0] == "robot0:hand mount" and m.jtype[0] == m.jtype[1] == types.JT_FIXED
    return w.astype(np.float32)


def test_engine_step_with_body_wrench_matches_jax(envs, jax_physics):
    jax_env, port_env = envs
    q, qd, tgt, slip = _cube_on_palm(port_env, 10)
    wrench = _body_wrench(port_env, 11)
    jm, tm = jax_env.model, port_env.model
    js0 = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt), body_wrench=jnp.asarray(wrench))
    ref = jax_physics(js0, jctrl, jax_env.dt, 2)

    ts0 = dataclasses.replace(
        types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd), slip_p=torch.tensor(slip)
    )
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt),
                                body_wrench=torch.tensor(wrench))
    out = engine.step(tm, None, ts0, tctrl, jax_env.dt, 2)
    plain = engine.step(tm, None, ts0, dataclasses.replace(tctrl, body_wrench=None), jax_env.dt, 2)

    in_contact = (np.linalg.norm(np.asarray(ref.contact_force), axis=-1) > 0).any(-1)
    assert in_contact.sum() >= N // 4, "the pair-contact path must be exercised"
    qa = tm.q_adr[port_env.object_body]
    assert float((out.q - plain.q)[:, qa:qa + 3].abs().max()) > 1e-4, "the wrench must move the cube"
    assert float(out.contact_torque[:, :2].abs().max()) == 0.0, "no contact torque on the welded root"
    for field, rtol, atol in (
        ("q", 5e-4, 5e-4), ("qd", 2e-3, 1e-2), ("dof_force", 2e-3, 1e-2),
        ("contact_force", 2e-3, 5e-2), ("contact_torque", 2e-3, 5e-2),
        ("slip_p", 2e-3, 1e-5), ("body_pos", 5e-4, 5e-4),
    ):
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def _jax_random_quat_draws(key, n):
    """The two angle draws of `ShadowHand._random_quat(key, n)`."""
    k0, k1 = jax.random.split(key)
    return jnp.stack([jax.random.uniform(k, (n,), minval=-1.0, maxval=1.0) for k in (k0, k1)], axis=-1)


def _jax_reset_draws(key, env):
    """The whole-batch draws of `ShadowHand._reset_envs(state, mask, key)`."""
    n, nd = env.num_envs, env.model.nd
    k_obj_pos, k_obj_rot, k_goal, k_dof, k_dvel, k_fp = jax.random.split(key, 6)
    draws = {
        "obj_pos": jax.random.uniform(k_obj_pos, (n, 3), minval=-1.0, maxval=1.0),
        "obj_rot": _jax_random_quat_draws(k_obj_rot, n),
        "goal": _jax_random_quat_draws(k_goal, n),
        "dof_pos": jax.random.uniform(k_dof, (n, nd), minval=-1.0, maxval=1.0),
        "dof_vel": jax.random.uniform(k_dvel, (n, nd), minval=-1.0, maxval=1.0),
        "force_prob": jax.random.uniform(k_fp, (n,)),
    }
    return draws


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    jax_env, port_env = envs
    q, qd, _, _ = _cube_on_palm(port_env, 5)
    qd[:] = 0.0
    jm = jax_env.model
    key = jax.random.PRNGKey(7)
    ts = dict(compiled(jax_env._initial_ts, key)(key))
    # env 0's goal is its cube's orientation: it reaches it at step 1 and
    # takes a goal-only reset at step 2; envs 4-7 time out at step 1 and are
    # reset at step 2
    qa = jm.q_adr[jax_env.object_body]
    ts["goal_rot"] = ts["goal_rot"].at[0].set(jnp.asarray(q[0, qa + 3:qa + 7]))
    progress = np.where(np.arange(N) >= 4, jax_env.max_episode_length - 2, 0).astype(np.int32)
    # the body caches are refreshed by the step's physics before any use
    sim = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    jstate = jax.device_get(JaxEnvState(
        sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool), rng=key, ts=ts,
    ))
    tstate = interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")

    rng = np.random.default_rng(6)
    # targets near the seeded dof positions: the hand holds still under the cube
    m = port_env.model
    act = port_env.actuated
    lo, hi = m.dof_lower[act].numpy(), m.dof_upper[act].numpy()
    hold = (2.0 * q[:, list(m.dof_q_adr)][:, act] - hi - lo) / (hi - lo)
    def step_and_draws(st, a):
        # _make_control: fold_in(state.rng, 41); step: key, k_reset, k_noise = split(state.rng, 3)
        goal = _jax_random_quat_draws(jax.random.fold_in(st.rng, 41), N)
        return jax_env.step(st, a), goal, _jax_reset_draws(jax.random.split(st.rng, 3)[1], jax_env)

    jstep = env_step(step_and_draws, jax_physics, jstate, jnp.zeros((N, 20)))
    torch_of = lambda d: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    goal_resets, resets = [], []
    for i in range(3):
        actions = np.clip(hold + rng.uniform(-0.1, 0.1, size=(N, 20)), -1.0, 1.0).astype(np.float32)
        resets.append(np.asarray(jstate.reset).copy())
        goal_resets.append(np.asarray(jstate.ts["reset_goal"]).copy())
        (jstate, jobs, jrew, jdone, jextras), goal, reset_draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws=torch_of(reset_draws),
            step_draws={"goal": torch.tensor(np.asarray(goal))},
        )
        _close(tobs["obs"], jobs["obs"], 2e-3, 5e-3, f"obs, step {i}")
        _close(trew, jrew, 1e-3, 1e-3, f"rew, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(tstate.ts["goal_rot"], jstate.ts["goal_rot"], 1e-5, 1e-6, f"goal_rot, step {i}")
        np.testing.assert_array_equal(tstate.ts["reset_goal"].numpy(), np.asarray(jstate.ts["reset_goal"]))
        cf = np.linalg.norm(np.asarray(jstate.sim.contact_force), axis=-1)
        assert (cf > 0).any(-1).sum() >= N // 4, f"pair contacts at step {i}"
    assert goal_resets[1][0] and not resets[1][0], "a goal-only reset of env 0 at step 2"
    assert resets[1][4:].all() and not resets[1][:4].any(), "the deferred reset of envs 4-7 at step 2"


def _cube_rotations(n):
    """(n, 4) xyzw: env e's cube turned by 90 deg x (e % 4) about z, then
    90 deg about x for odd e; the cube rests on the palm as before (its
    contact spheres are symmetric), and its frame, which the random forces
    are drawn in, points elsewhere in each env."""
    e = torch.arange(n)
    a, b = e % 4 * torch.pi / 4, (e % 2) * torch.pi / 4
    zero = torch.zeros(n)
    qz = torch.stack([zero, zero, torch.sin(a), torch.cos(a)], -1)
    qx = torch.stack([torch.sin(b), zero, zero, torch.cos(b)], -1)
    return maths.quat_mul(qz, qx)


def test_openai_env_steps_with_forces_and_states_match_jax(openai_envs, jax_physics):
    jax_env, port_env = openai_envs
    assert (jax_env.num_obs, jax_env.num_states, port_env.num_obs, port_env.num_states) == (42, 211, 42, 211)
    assert port_env.force_scale == jax_env.force_scale == 1.0
    q, qd, _, _ = _cube_on_palm(port_env, 12)
    qd[:] = 0.0
    jm, tm = jax_env.model, port_env.model
    qa = jm.q_adr[jax_env.object_body]
    q[:, qa + 3:qa + 7] = maths.quat_mul(torch.tensor(q[:, qa + 3:qa + 7]), _cube_rotations(N)).numpy()
    key = jax.random.PRNGKey(13)
    ts = dict(compiled(jax_env._initial_ts, key)(key))
    # a force probability per env from 0.05 to 0.9, and a decaying force already on envs 0-3
    ts["force_prob"] = jnp.linspace(0.05, 0.9, N)
    rb = np.zeros((N, 3), np.float32)
    rb[:4] = np.random.default_rng(14).normal(size=(4, 3)) * 0.07
    ts["rb_force"] = jnp.asarray(rb)
    progress = np.where(np.arange(N) >= 6, jax_env.max_episode_length - 2, 0).astype(np.int32)
    # the forces turn with the object pose of the last refresh: the body caches
    # of q, qd, as the port's forward gives them, go to both packages
    tsim = engine.forward(tm, None, dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q),
                                                        qd=torch.tensor(qd)))
    caches = {f: jnp.asarray(getattr(tsim, f).numpy()) for f in ("body_pos", "body_quat", "body_linvel",
                                                                   "body_angvel")}
    sim = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), **caches)
    jstate = jax.device_get(JaxEnvState(
        sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool), rng=key, ts=ts,
    ))
    tstate = interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")

    rng = np.random.default_rng(15)
    act = port_env.actuated
    lo, hi = tm.dof_lower[act].numpy(), tm.dof_upper[act].numpy()
    hold = (2.0 * q[:, list(tm.dof_q_adr)][:, act] - hi - lo) / (hi - lo)

    def step_and_draws(st, a):
        # _make_control: fold_in(rng, 41) for the goal, split(fold_in(rng, 43)) for the forces
        k_f, k_g = jax.random.split(jax.random.fold_in(st.rng, 43))
        draws = {"goal": _jax_random_quat_draws(jax.random.fold_in(st.rng, 41), N),
                 "force_fire": jax.random.uniform(k_f, (N,)), "force": jax.random.normal(k_g, (N, 3))}
        return jax_env.step(st, a), draws, _jax_reset_draws(jax.random.split(st.rng, 3)[1], jax_env)

    jstep = env_step(step_and_draws, jax_physics, jstate, jnp.zeros((N, 20)))
    torch_of = lambda d: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    fired, resets = np.zeros(N, bool), []
    # the first obs dict of each package: obs and states without a step
    _close(port_env.observations(tstate)["states"], compiled(jax_env.observations, jstate)(jstate)["states"],
           2e-3, 5e-3, "states")
    for i in range(2):
        actions = np.clip(hold + rng.uniform(-0.1, 0.1, size=(N, 20)), -1.0, 1.0).astype(np.float32)
        prob = np.asarray(jstate.ts["force_prob"])
        resets.append(np.asarray(jstate.reset).copy())
        (jstate, jobs, jrew, jdone, jextras), step_draws, reset_draws = jstep(jstate, jnp.asarray(actions))
        fired |= np.asarray(step_draws["force_fire"]) < prob
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws=torch_of(reset_draws), step_draws=torch_of(step_draws),
        )
        assert tobs["obs"].shape == (N, 42) and tobs["states"].shape == (N, 211)
        _close(tobs["obs"], jobs["obs"], 2e-3, 5e-3, f"obs, step {i}")
        _close(tobs["states"], jobs["states"], 2e-3, 5e-3, f"states, step {i}")
        _close(trew, jrew, 1e-3, 1e-3, f"rew, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(tstate.ts["rb_force"], jstate.ts["rb_force"], 1e-6, 1e-7, f"rb_force, step {i}")
        _close(tstate.ts["force_prob"], jstate.ts["force_prob"], 1e-6, 0, f"force_prob, step {i}")
        cf = np.linalg.norm(np.asarray(jstate.sim.contact_force), axis=-1)
        assert (cf > 0).any(-1).sum() >= N // 4, f"pair contacts at step {i}"
    assert fired.any() and not fired.all(), "forces fire in some envs and decay in others"
    assert resets[1][6:].all() and not resets[1][:6].any(), "envs 6-7 reset at step 2: force and probability redrawn"


def test_policy_forward_with_carried_weights():
    rng = np.random.default_rng(8)
    units = tuple(load_train_config("ShadowHand")["params"]["network"]["mlp"]["units"])
    assert units == (512, 512, 256, 128)
    obs = (rng.normal(size=(N, 211)) * 2.0).astype(np.float32)
    net = JaxActorCritic(num_actions=20, units=units, activation="elu")
    # the network's parameter tree, filled from the numpy seed
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(9), jnp.zeros((1, 211)))
    params = jax.tree_util.tree_map(lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    params["params"]["log_std"] = (0.3 * rng.normal(size=20)).astype(np.float32)
    jmu, jlog_std, jvalue = jax.jit(net.apply)(params, jnp.asarray(obs))

    policy = ActorCritic(211, 20, units=units, activation="elu")
    policy.load_state_dict(interop.policy_from_jax(params))
    with torch.no_grad():
        mu, log_std, value = policy(torch.tensor(obs))
    _close(mu, jmu, 1e-5, 1e-5, "mu")
    _close(log_std, jlog_std, 1e-5, 1e-5, "log_std")
    _close(value, jvalue, 1e-5, 1e-5, "value")


def test_dispatch_rule(envs):
    _, hand = envs
    anymal = isaacgymenv_tpu_torch.make(task="Anymal", num_envs=N, device="cpu")
    q_any, q_hand = anymal.initial_state().sim.q, torch.zeros(N, hand.model.nq)
    assert engine._use_fused(anymal.model, q_any) == "mono"
    assert engine._use_fused(hand.model, q_hand) == "split"
    m = hand.model
    over = fused_split.MAX_PAIRS // m.n_pairs + 1
    many_pairs = dataclasses.replace(m, pair_geom=m.pair_geom * over, pair_surf=m.pair_surf * over)
    assert engine._use_fused(many_pairs, q_hand) is None
    # features neither path has raise; sensors run on the split pair (B3's sensor output)
    ctrl = engine.Control.zero(m, N)
    sim = types.make_zero_state(m, N)
    with pytest.raises(NotImplementedError, match="not ported yet: gravity compensation"):
        engine.step(dataclasses.replace(m, body_gravcomp=torch.ones(m.nb)), None, sim, ctrl, 0.01, 2)
    sensed = engine.step(dataclasses.replace(m, sensor_body=(7,)), None, sim, ctrl, 0.01, 2)
    assert tuple(sensed.joint_wrench.shape) == (N, 1, 6)
    for key, value in (("env.observationType", "full"), ("env.objectType", "egg")):
        with pytest.raises(NotImplementedError, match="ported"):
            isaacgymenv_tpu_torch.make(task="ShadowHand", num_envs=N, device="cpu", **{key: value})
    # body wrenches run on both kernels; world anchors on the split pair, not on B1
    wrench = dataclasses.replace(engine.Control.zero(anymal.model, N), body_wrench=torch.zeros(N, anymal.model.nb, 6))
    engine.step(anymal.model, None, anymal.initial_state().sim, wrench, 0.01, 2)
    anchored = dataclasses.replace(anymal.model, anchor_body=(1,))
    with pytest.raises(NotImplementedError, match="world anchors on B1"):
        engine.step(anchored, None, anymal.initial_state().sim, ctrl, 0.01, 2)
    if not torch.cuda.is_available():  # no device means "cuda", never a silent CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            isaacgymenv_tpu_torch.make(task="ShadowHand", num_envs=N)


def test_split_wrapper_runs_plain_version_on_cpu(envs):
    _, env = envs
    m = env.model
    q, qd, tgt, slip = (torch.tensor(a) for a in _cube_on_palm(env, 9))
    zero = torch.zeros_like(tgt)
    slip_g = torch.zeros(N, m.ng, 3)
    tables = fused_split.tables_for(m, "cpu")
    before = (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches)
    args = (q, qd, tgt, zero, zero, slip_g, slip, 0.01, 2)
    out = fused_split.split_substep(tables, *args)
    ref = fused_split.split_substep_plain(tables, *args)
    assert (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches) == before
    assert out[7] is None and ref[7] is None  # no force sensors
    for a, b in zip(out[:7], ref[:7]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_split.split_substep(tables, q.to("meta"), *args[1:])
    with pytest.raises(ValueError, match="needs CUDA"):
        fused_split.launch_contacts(tables, q.t(), qd.t(), None, slip, None, None, None, 0.01)


def test_split_wrapper_with_body_wrench_runs_plain_version_on_cpu(envs):
    _, env = envs
    m = env.model
    q, qd, tgt, slip = (torch.tensor(a) for a in _cube_on_palm(env, 16))
    wrench = torch.tensor(_body_wrench(env, 17))
    zero = torch.zeros_like(tgt)
    slip_g = torch.zeros(N, m.ng, 3)
    tables = fused_split.tables_for(m, "cpu")
    before = (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches)
    args = (q, qd, tgt, zero, zero, slip_g, slip, 0.01, 2)
    out = fused_split.split_substep(tables, *args, body_wrench=wrench)
    ref = fused_split.split_substep_plain(tables, *args, body_wrench=wrench)
    assert (fused_split.launch_contacts.launches, fused_split.launch_dynamics.launches) == before
    assert out[7] is None and ref[7] is None  # no force sensors
    for a, b in zip(out[:7], ref[:7]):
        assert torch.equal(a, b)
    assert not torch.equal(out[0], fused_split.split_substep(tables, *args)[0]), "the wrench is applied"
    # B2's plain version alone: the wrench in f_ext, not in the contact torque
    f_ext, cf, ct, _, _ = fused_split.contacts_plain(tables, q, qd, slip_g, slip, 0.01, body_wrench=wrench)
    f_ext0, cf0, ct0, _, _ = fused_split.contacts_plain(tables, q, qd, slip_g, slip, 0.01)
    assert torch.equal(f_ext, f_ext0 + wrench) and torch.equal(ct, ct0) and torch.equal(cf, cf0)
