"""The port's Quadcopter slice against the JAX package on the CPU, N = 8 envs.

Quadcopter is the fused kernel's (B1's) scene with no contact geoms and a
body wrench per step: each rotor's thrust along its local +z, turned into
the world by the rotor's pose in the body caches of the step's start.  Both
packages build its procedural model once, in a module-scoped fixture.  The
JAX side runs its XLA path at -O0, one substep of `engine.step` compiled
with a body wrench and chained (tests/jax_reference.py); the JAX env step is
compiled with that chain in place of its physics and with the reset draws
it makes from its state's key, which are handed to the port.  The port runs
B1's plain version.  States are seeded with numpy, in flight.

Tolerances (rtol / atol), fp32 throughout:
- model leaves 1e-5 / 1e-6, as tests/test_torch_anymal.py;
- the physics those of tests/test_fused.py: q 2e-4 / 2e-4, qd and
  dof_force 2e-3 / 2e-3; the contact force and torque exactly 0 (no geoms);
- env steps: obs 2e-3 / 5e-3, rew 1e-3 / 1e-3, the dof targets and thrusts
  1e-6 / 1e-6, done and time_outs exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.envs.quadcopter import Quadcopter as JaxQuadcopter  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import types as jax_types  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.ops import maths  # noqa: E402
from isaacgymenv_tpu_torch.physics import engine, fused, types  # noqa: E402

N = 8
STEP_TOLS = (("q", 2e-4, 2e-4), ("qd", 2e-3, 2e-3), ("dof_force", 2e-3, 2e-3))
OBS_TOL, REW_TOL = (2e-3, 5e-3), (1e-3, 1e-3)


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    return (JaxQuadcopter(jax_task_config("Quadcopter", num_envs=N)),
            isaacgymenv_tpu_torch.make(task="Quadcopter", num_envs=N, device="cpu"))


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of Quadcopter, one compiled substep chained, with
    a body wrench."""
    jm = envs[0].model
    ctrl = jax_engine.Control.zero(jm, N).replace(body_wrench=jnp.zeros((N, jm.nb, 6)))
    return substep_chain(jm, None, jax_types.make_zero_state(jm, N), ctrl)


def _flight(env, seed):
    """A port SimState in flight with refreshed body caches: the chassis
    tilted and moving, the hinges anywhere within their limits and turning."""
    rng = np.random.default_rng(seed)
    m = env.model
    lo, hi = m.dof_lower.numpy(), m.dof_upper.numpy()
    q = np.zeros((N, m.nq), np.float32)
    q[:, 0:3] = rng.uniform(-1.0, 1.0, (N, 3)) + [0.0, 0.0, 1.0]
    quat = rng.normal(size=(N, 4)) * 0.1 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(lo, hi, (N, m.nd))
    qd = np.concatenate([rng.uniform(-2.0, 2.0, (N, 3)), rng.uniform(-1.0, 1.0, (N, 3)),
                         rng.uniform(-3.0, 3.0, (N, m.nd))], -1).astype(np.float32)
    state = dataclasses.replace(types.make_zero_state(m, N), q=torch.tensor(q), qd=torch.tensor(qd))
    return engine.forward(m, None, state), rng


def test_model_matches_jax_field_by_field(envs):
    """The model's tables against the JAX model's leaves, field by field."""
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
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng) == (9, 15, 14, 8, 0)
    assert port_env.rotor_bodies == jax_env.rotor_bodies == [2, 4, 6, 8]


def _wrench_step(env, seed):
    """A state in flight, position targets within the limits, and a body
    wrench: the thrusts along the rotors' axes and small wrenches on every
    body."""
    m = env.model
    state, rng = _flight(env, seed)
    tgt = torch.tensor(rng.uniform(m.dof_lower.numpy(), m.dof_upper.numpy(), (N, m.nd)), dtype=torch.float32)
    bw = torch.tensor(np.concatenate([rng.normal(size=(N, m.nb, 3)) * 1e-3, rng.normal(size=(N, m.nb, 3)) * 1e-2],
                                     -1), dtype=torch.float32)
    thrust = torch.zeros(N, 3)
    for b in env.rotor_bodies:
        thrust[:, 2] = torch.tensor(rng.uniform(0.0, 2.0, N), dtype=torch.float32)
        bw[:, b, 3:] += maths.quat_rotate(state.body_quat[:, b], thrust)
    return state, tgt, bw


def test_b1_plain_with_body_wrench_without_geoms_matches_jax(envs, jax_physics):
    """B1's plain version (`fused_substep_plain(body_wrench=)`) on the scene
    without geoms against JAX `engine.step` with the same wrench."""
    jax_env, port_env = envs
    jm, tm = jax_env.model, port_env.model
    state, tgt, bw = _wrench_step(port_env, 3)
    js0 = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(state.q.numpy()), qd=jnp.asarray(state.qd.numpy()))
    jctrl = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt.numpy()),
                                                   body_wrench=jnp.asarray(bw.numpy()))
    ref = jax_physics(js0, jctrl, port_env.dt, port_env.substeps)

    tables = fused.tables_for(tm, "cpu")
    zero = torch.zeros_like(tgt)
    h = port_env.dt / port_env.substeps
    out = fused.fused_substep_plain(tables, state.q, state.qd, tgt, zero, zero, None, h, port_env.substeps,
                                    body_wrench=bw)
    for (field, rtol, atol), got in zip(STEP_TOLS, out):
        _close(got, getattr(ref, field), rtol, atol, field)
    for got, field in zip(out[3:5], ("contact_force", "contact_torque")):
        assert not got.any() and not np.asarray(getattr(ref, field)).any(), f"{field}: no geoms, no contact"
    assert out[5] is None and out[6] is None  # no slip state, no sensors


def test_gate_sends_the_wrench_to_b1_without_geoms(envs):
    """`engine.step` sends the scene without geoms and its wrench to B1,
    whose wrapper on a CPU state runs the plain version with no launch; the
    packed table has no geoms; the wrench moves the quadcopter."""
    port_env = envs[1]
    tm = port_env.model
    state, tgt, bw = _wrench_step(port_env, 4)
    tables = fused.tables_for(tm, "cpu")
    zero = torch.zeros_like(tgt)
    h = port_env.dt / port_env.substeps
    out = fused.fused_substep_plain(tables, state.q, state.qd, tgt, zero, zero, None, h, port_env.substeps,
                                    body_wrench=bw)
    assert fused.pack_model(tm).ng == 0
    before = fused.fused_substep.launches
    wrapped = fused.fused_substep(tables, state.q, state.qd, tgt, zero, zero, None, h, port_env.substeps,
                                  body_wrench=bw)
    assert fused.fused_substep.launches == before
    assert len(wrapped) == 7 and all(torch.equal(a, b) for a, b in zip(wrapped[:5], out[:5]))
    assert wrapped[5] is None and wrapped[6] is None  # no slip state, no sensors
    ctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=tgt, body_wrench=bw)
    assert engine._use_fused(tm, state.q) == "mono" and fused.fused_structural_ok(tm, N)
    engine._check_supported(tm, None, "mono", "cuda")  # the gate takes no control: B1 has the wrench mode
    before = fused.fused_substep.launches
    stepped = engine.step(tm, None, state, ctrl, port_env.dt, port_env.substeps)
    assert fused.fused_substep.launches == before and stepped.slip_g is None
    assert torch.equal(stepped.q, out[0]) and torch.equal(stepped.qd, out[1])
    moved = (out[0] - fused.fused_substep_plain(tables, state.q, state.qd, tgt, zero, zero, None, h,
                                                port_env.substeps)[0]).abs().max()
    assert moved > 1e-4, "the body wrench moves the quadcopter"


def _jax_reset_draws(key, n):
    """The whole-batch draws of `Quadcopter._reset_envs(state, mask, key)`."""
    k_xyz, k_dof = jax.random.split(key)
    return {"root_noise": jax.random.uniform(k_xyz, (n, 3), minval=jnp.array([-1.5, -1.5, -0.2]),
                                             maxval=jnp.array([1.5, 1.5, 1.5])),
            "dof_pos": jax.random.uniform(k_dof, (n, 8), minval=-0.2, maxval=0.2)}


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    """3 env steps in flight (two envs 3 steps from their time limit, one
    below 0.3 m): obs, reward, done and time_outs, the integrated dof targets
    and thrusts (whose wrench turns with the rotors' cached poses), through a
    reset."""
    jax_env, port_env = envs
    jm = jax_env.model
    state, rng = _flight(port_env, 5)
    q = state.q.numpy().copy()
    q[4, 0:3] = (0.0, 0.0, 0.25)
    state = engine.forward(port_env.model, None, dataclasses.replace(state, q=torch.tensor(q)))
    progress = np.where(np.isin(np.arange(N), [1, 6]), jax_env.max_episode_length - 3, 0).astype(np.int32)
    key = jax.random.PRNGKey(7)
    sim_fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    sim = jax_types.make_zero_state(jm, N).replace(**{
        k: jnp.asarray(v.numpy()) for k, v in sim_fields.items() if v is not None and k != "slip_g"})
    ts = {"dof_targets": jnp.asarray(q[:, 7:]), "thrusts": jnp.asarray(rng.uniform(0.0, 2.0, (N, 4)), jnp.float32)}
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool),
                                        rng=key, ts=ts))
    fn = lambda st, a: (jax_env.step(st, a), _jax_reset_draws(jax.random.split(st.rng, 3)[1], N))  # noqa: E731
    jstep = env_step(fn, jax_physics, jstate, jnp.zeros((N, 12)))
    tstate = interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")

    seen = {"reset": False, "timeout": False}
    for i in range(3):
        actions = rng.uniform(-1.0, 1.0, size=(N, 12)).astype(np.float32)
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
        _close(tobs["obs"], jobs["obs"], *OBS_TOL, f"obs, step {i}")
        _close(trew, jrew, *REW_TOL, f"rew, step {i}")
        for k in ("dof_targets", "thrusts"):
            _close(tstate.ts[k], jstate.ts[k], 1e-6, 1e-6, f"{k}, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        seen["reset"] |= bool(np.asarray(jdone)[4]) and i == 0
        seen["timeout"] |= bool(np.asarray(jextras["time_outs"]).any())
    assert all(seen.values()), f"every branch must run: {seen}"
    assert np.asarray(jstate.progress)[4] == 1, "the fallen env must have been reset"
    assert float(np.asarray(jstate.ts["thrusts"]).max()) > 0.0
