"""The port's Anymal slice against the JAX package on the CPU, N = 8 envs.

The one port test file that builds the JAX Anymal model (once, in a
module-scoped fixture).  The JAX side runs its XLA path (`engine.step` on
the CPU backend), which tests/test_fused.py in turn holds the Pallas kernel
against, compiled once as one substep chained (tests/jax_reference.py); the
JAX env step is compiled with that chain in place of its physics and with
the reset draws it makes from its state's key.  The port runs the fused
kernel's plain version.  Random draws are
made with numpy or, for resets, by repeating the JAX package's key splits
here, and handed to both packages.

Tolerances (rtol = atol unless stated), fp32 throughout:
- model leaves 1e-5 relative / 1e-6 absolute: the same float64 host math
  rounded once, except the effective masses, formed in fp32 by both;
- fk 1e-5 and aba 1e-4 relative / 1e-3 absolute: the same formulas summed
  in another order;
- engine.step those of tests/test_fused.py: q 2e-4, qd and dof_force 2e-3,
  contact_force rtol 2e-3 / atol 2e-2, body_pos 2e-4; slip 2e-4 as a position;
- env steps: obs rtol 2e-3 / atol 5e-3 (the qd tolerance 2e-3 times the obs
  scale 2 of the base velocity, plus margin), rew rtol 1e-3 / atol 1e-4
  (dt-scaled exponentials of those velocities), done and time_outs exact;
- the policy 1e-5: the same fp32 matmuls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.anymal import Anymal as JaxAnymal  # noqa: E402
from isaacgymenv_tpu.learning.networks import ActorCritic as JaxActorCritic  # noqa: E402
from isaacgymenv_tpu.learning.running_stats import RunningStats as JaxRunningStats  # noqa: E402
from isaacgymenv_tpu.physics import dynamics as jax_dynamics  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import kinematics as jax_kinematics  # noqa: E402
from isaacgymenv_tpu.physics.types import make_zero_state as jax_zero_state  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import compiled as _jax_compiled  # noqa: E402
from tests.jax_reference import env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.learning.networks import ActorCritic  # noqa: E402
from isaacgymenv_tpu_torch.physics import dynamics, engine, kinematics, types  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def envs():
    return (
        JaxAnymal(jax_task_config("Anymal", num_envs=N)),
        isaacgymenv_tpu_torch.make(task="Anymal", num_envs=N, device="cpu"),
    )


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of Anymal, one compiled substep chained."""
    jm = envs[0].model
    return substep_chain(jm, None, jax_zero_state(jm, N), jax_engine.Control.zero(jm, N))


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _seeded_state(env, seed):
    """q, qd, pos_target near the standing pose, base low enough for contact."""
    rng = np.random.default_rng(seed)
    model = env.model
    default = np.asarray(env.default_dof_pos)
    q = np.zeros((N, model.nq), np.float32)
    q[:, 2] = 0.46 + 0.06 * rng.random(N)
    quat = rng.normal(size=(N, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = default + 0.2 * rng.normal(size=(N, model.nd))
    qd = (0.3 * rng.normal(size=(N, model.nv))).astype(np.float32)
    tgt = (default + 0.3 * rng.normal(size=(N, model.nd))).astype(np.float32)
    return q, qd, tgt


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
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng) == (13, 19, 18, 12, 143)


def test_fk_and_world_velocities_match_jax(envs):
    jax_env, port_env = envs
    q, qd, _ = _seeded_state(jax_env, 1)
    jkin = _jax_compiled(lambda q, qd: jax_kinematics.fk(jax_env.model, q, qd), q, qd)(q, qd)
    jang, jlin = jax_kinematics.world_velocities(jax_env.model, jkin)
    tkin = kinematics.fk(port_env.model, torch.tensor(q), torch.tensor(qd))
    tang, tlin = kinematics.world_velocities(port_env.model, tkin)
    for field in ("R_w", "p_w", "v"):
        for i, (a, b) in enumerate(zip(getattr(tkin, field), getattr(jkin, field))):
            _close(a, b, 1e-5, 1e-5, f"{field}[{i}]")
    _close(torch.stack(tang, 1), jnp.stack(jang, 1), 1e-5, 1e-5, "angvel")
    _close(torch.stack(tlin, 1), jnp.stack(jlin, 1), 1e-5, 1e-5, "linvel")


def test_aba_matches_jax(envs):
    jax_env, port_env = envs
    q, qd, _ = _seeded_state(jax_env, 2)
    rng = np.random.default_rng(3)
    tau = (20.0 * rng.normal(size=(N, 18))).astype(np.float32)
    f_ext = (10.0 * rng.normal(size=(N, 13, 6))).astype(np.float32)
    d_extra = (0.05 * rng.random(size=(N, 12))).astype(np.float32)
    jm = jax_env.model
    args = (q, qd, tau, f_ext, d_extra)
    want = _jax_compiled(
        lambda q, qd, t, f, d: jax_dynamics.aba(jm, jax_kinematics.fk(jm, q, qd), t, f, d), *args
    )(*args)
    tm = port_env.model
    got = dynamics.aba(
        tm, kinematics.fk(tm, torch.tensor(q), torch.tensor(qd)),
        torch.tensor(tau), torch.tensor(f_ext), torch.tensor(d_extra),
    )
    _close(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize("substeps", [1, 4])
def test_engine_step_matches_jax_xla_path(envs, jax_physics, substeps):
    jax_env, port_env = envs
    q, qd, tgt = _seeded_state(jax_env, 4 + substeps)
    jm, tm = jax_env.model, port_env.model
    js0 = jax_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
    ref = jax_physics(js0, jctrl, 0.02, substeps)

    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd))
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt))
    out = engine.step(tm, None, ts0, tctrl, 0.02, substeps)

    in_contact = (np.linalg.norm(np.asarray(ref.contact_force), axis=-1) > 0).any(-1)
    assert in_contact.sum() >= N // 4, "the ground-contact path must be exercised"
    for field, rtol, atol in (
        ("q", 2e-4, 2e-4), ("qd", 2e-3, 2e-3), ("dof_force", 2e-3, 2e-3),
        ("contact_force", 2e-3, 2e-2), ("body_pos", 2e-4, 2e-4), ("slip_g", 2e-4, 2e-4),
    ):
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def _jax_reset_draws(key, env):
    """The whole-batch draws of `Anymal._reset_envs(state, mask, key)`,
    repeated with jax.random (envs/anymal.py key splits)."""
    n, nd, r = env.num_envs, env.model.nd, env.command_ranges
    k_pos, k_vel, k_cmd = jax.random.split(key, 3)
    kx, ky, kw = jax.random.split(k_cmd, 3)
    cmd = [
        jax.random.uniform(k, (n,), minval=r[name][0], maxval=r[name][1])
        for k, name in ((kx, "linear_x"), (ky, "linear_y"), (kw, "yaw"))
    ]
    draws = {
        "pos_offset": jax.random.uniform(k_pos, (n, nd), minval=0.5, maxval=1.5),
        "vel": jax.random.uniform(k_vel, (n, nd), minval=-0.1, maxval=0.1),
        "commands": jnp.stack(cmd, axis=-1),
    }
    return draws


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    jax_env, port_env = envs
    key = jax.random.PRNGKey(5)
    # initial_state: key, k_ts, k_reset, k_dr = split(key, 4)  (envs/base.py)
    init = lambda k: (jax_env.initial_state(k), _jax_reset_draws(jax.random.split(k, 4)[2], jax_env))  # noqa: E731
    jstate, draws = _jax_compiled(init, key)(key)
    tinit = port_env.initial_state(reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    for field in ("q", "qd", "body_pos", "body_quat", "body_linvel"):
        _close(getattr(tinit.sim, field), getattr(jstate.sim, field), 1e-5, 1e-5, f"initial {field}")
    _close(tinit.ts["commands"], jstate.ts["commands"], 0, 0, "initial commands")
    # half the envs two steps from their time limit: resets happen in the
    # window.  The JAX state is carried over as numpy leaves.
    near_end = np.where(np.arange(N) % 2 == 0, jax_env.max_episode_length - 3, 0).astype(np.int32)
    jstate = jax.device_get(jstate.replace(progress=jnp.asarray(near_end)))
    tstate = interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")

    rng = np.random.default_rng(6)
    # step: key, k_reset, k_noise = split(state.rng, 3)  (envs/base.py)
    jstep = env_step(lambda st, a: (jax_env.step(st, a), _jax_reset_draws(jax.random.split(st.rng, 3)[1], jax_env)),
                     jax_physics, jstate, jnp.zeros((N, 12)))
    any_reset = False
    for i in range(5):
        actions = rng.uniform(-1.0, 1.0, size=(N, 12)).astype(np.float32)
        any_reset |= bool(np.asarray(jstate.reset).any())
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
        _close(tobs["obs"], jobs["obs"], 2e-3, 5e-3, f"obs, step {i}")
        _close(trew, jrew, 1e-3, 1e-4, f"rew, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        if i >= 2:
            cf = np.linalg.norm(np.asarray(jstate.sim.contact_force), axis=-1)
            assert (cf > 0).any(), f"no ground contact at step {i}"
    assert any_reset, "the deferred-reset branch must run with injected draws"


def test_acting_step_with_carried_weights(envs):
    jax_env, _ = envs
    rng = np.random.default_rng(8)
    obs = (rng.normal(size=(N, 48)) * 2.0).astype(np.float32)
    batch = (rng.normal(size=(64, 48)) * 3.0 + 1.0).astype(np.float32)

    net = JaxActorCritic(num_actions=12, units=(256, 128, 64), activation="elu")
    # the network's parameter tree, filled from the numpy seed
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(9), jnp.zeros((1, 48)))
    params = jax.tree_util.tree_map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    params["params"]["log_std"] = (0.3 * rng.normal(size=12)).astype(np.float32)

    def forward(p, b, o):
        stats = JaxRunningStats.create((48,)).update(b)
        return stats, net.apply(p, stats.normalize(o))

    jstats, (jmu, jlog_std, jvalue) = jax.jit(forward)(params, jnp.asarray(batch), jnp.asarray(obs))

    policy = ActorCritic(48, 12, units=(256, 128, 64), activation="elu")
    policy.load_state_dict(interop.policy_from_jax(params))
    stats = interop.running_stats_from_jax(*jax.device_get((jstats.mean, jstats.var, jstats.count)), device="cpu")
    with torch.no_grad():
        mu, log_std, value = policy(stats.normalize(torch.tensor(obs)))
    _close(mu, jmu, 1e-5, 1e-5, "mu")
    _close(log_std, jlog_std, 1e-5, 1e-5, "log_std")
    _close(value, jvalue, 1e-5, 1e-5, "value")
