"""The port's ShadowHand slice against the JAX package on the CPU, N = 8 envs.

The JAX ShadowHand is built once, in a module-scoped fixture; its step
functions are compiled at XLA optimization level 0 and run the XLA path
(`engine.step` on the CPU backend), which tests/test_fused_split.py holds the
Pallas split pair against.  The port runs its split kernels' plain version
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
  measured error is under 1e-5), rew 1e-3 / 1e-3 (1 / (rot_dist + 0.1)
  amplifies a rotation error up to 100x), done and time_outs exact;
- the policy 1e-5: the same fp32 matmuls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.envs.shadow_hand import ShadowHand as JaxShadowHand  # noqa: E402
from isaacgymenv_tpu.learning.networks import ActorCritic as JaxActorCritic  # noqa: E402
from isaacgymenv_tpu.physics import contact as jax_contact  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics.types import make_zero_state as jax_zero_state  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.learning.networks import ActorCritic  # noqa: E402
from isaacgymenv_tpu_torch.physics import contact, engine, fused_split, kinematics, types  # noqa: E402
from isaacgymenv_tpu_torch.utils.config import load_train_config  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def envs():
    return (
        JaxShadowHand(jax_task_config("ShadowHand", num_envs=N)),
        isaacgymenv_tpu_torch.make(task="ShadowHand", num_envs=N, device="cpu"),
    )


def _jax_compiled(fn, *args):
    """fn jitted and compiled for args at XLA backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


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


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_surface_closest_matches_jax(kind):
    rng = np.random.default_rng(20 + kind)
    size = np.tile((0.02 + 0.03 * rng.random(3)).astype(np.float32), (64, 1))
    local = (rng.uniform(-2.0, 2.0, size=(N, 64, 3)) * size).astype(np.float32)
    kinds = np.full(64, kind, np.int32)
    jn, jd = jax_contact._surface_closest(jnp.asarray(kinds), jnp.asarray(local), jnp.asarray(size))
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
    want = jax_engine.passive_force(jax_env.model, jnp.asarray(pos), jnp.asarray(vel))
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


def test_engine_step_matches_jax_xla_path(envs):
    jax_env, port_env = envs
    q, qd, tgt, slip = _cube_on_palm(port_env, 4)
    jm, tm = jax_env.model, port_env.model
    js0 = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd), slip_p=jnp.asarray(slip))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
    dt = jax_env.dt
    ref = _jax_compiled(lambda s, c: jax_engine.step(jm, None, s, c, dt, 2), js0, jctrl)(js0, jctrl)

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
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def test_env_steps_match_jax_with_injected_draws(envs):
    jax_env, port_env = envs
    q, qd, _, _ = _cube_on_palm(port_env, 5)
    qd[:] = 0.0
    jm = jax_env.model
    key = jax.random.PRNGKey(7)
    ts = jax_env._initial_ts(key)
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
    jstep = _jax_compiled(jax_env.step, jstate, jnp.zeros((N, 20)))
    goal_resets, resets = [], []
    for i in range(3):
        actions = np.clip(hold + rng.uniform(-0.1, 0.1, size=(N, 20)), -1.0, 1.0).astype(np.float32)
        # _make_control: fold_in(state.rng, 41); step: key, k_reset, k_noise = split(state.rng, 3)
        step_draws = {"goal": torch.tensor(np.asarray(_jax_random_quat_draws(jax.random.fold_in(jstate.rng, 41), N)))}
        reset_draws = _jax_reset_draws(jax.random.split(jstate.rng, 3)[1], jax_env)
        resets.append(np.asarray(jstate.reset).copy())
        goal_resets.append(np.asarray(jstate.ts["reset_goal"]).copy())
        jstate, jobs, jrew, jdone, jextras = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws=reset_draws, step_draws=step_draws
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


def test_policy_forward_with_carried_weights():
    rng = np.random.default_rng(8)
    units = tuple(load_train_config("ShadowHand")["params"]["network"]["mlp"]["units"])
    assert units == (512, 512, 256, 128)
    obs = (rng.normal(size=(N, 211)) * 2.0).astype(np.float32)
    net = JaxActorCritic(num_actions=20, units=units, activation="elu")
    params = net.init(jax.random.PRNGKey(9), jnp.zeros((1, 211)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    params["params"]["log_std"] = (0.3 * rng.normal(size=20)).astype(np.float32)
    jmu, jlog_std, jvalue = net.apply(params, jnp.asarray(obs))

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
    # features neither path has raise
    ctrl = engine.Control.zero(m, N)
    sim = types.make_zero_state(m, N)
    for bad in (
        dataclasses.replace(m, anchor_body=(26,)),
        dataclasses.replace(m, body_gravcomp=torch.ones(m.nb)),
        dataclasses.replace(m, sensor_body=(7,)),
    ):
        with pytest.raises(NotImplementedError, match="not ported"):
            engine.step(bad, None, sim, ctrl, 0.01, 2)
    with pytest.raises(NotImplementedError, match="forceScale"):
        isaacgymenv_tpu_torch.make(task="ShadowHand", num_envs=N, device="cpu", **{"env.forceScale": 1.0})
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
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_split.split_substep(tables, q.to("meta"), *args[1:])
    with pytest.raises(ValueError, match="needs CUDA"):
        fused_split.launch_contacts(tables, q.t(), qd.t(), None, slip, None, None, None, 0.01)
