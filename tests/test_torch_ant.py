"""The port's Ant slice against the JAX package on the CPU, N = 8 envs.

Both packages build Ant once, in a module-scoped fixture.  The JAX side runs
its XLA path (`engine.step` on the CPU backend), which tests/test_fused.py
holds the Pallas kernel's sensor output against; the port runs the fused
kernel's plain version, whose force sensors are the ABA's joint forces.
The JAX physics is compiled once, as one substep of `engine.step` chained
(tests/jax_reference.py); the JAX env step is compiled with that chain in
place of its physics and with the draws it makes from its state's key,
which are handed to the port.  States are seeded with
numpy, the torso low enough for feet on the ground.

Tolerances (rtol / atol), fp32 throughout:
- model leaves 1e-5 / 1e-6, as tests/test_torch_anymal.py;
- engine.step those of tests/test_fused.py: q 2e-4 / 2e-4, qd and
  dof_force 2e-3 / 2e-3, contact_force 2e-3 / 2e-2, joint_wrench 2e-3 / 5e-2
  (tests/test_fused.py:126-130), body_pos 2e-4, slip 2e-4 as a position;
- the static hanging link's joint wrench 1e-4 absolute, as
  tests/test_dynamics.py:439, and 1e-5 against JAX's `aba_lp`;
- env steps: obs 2e-3 / 5e-3 (the sensor entries are the wrenches times
  0.1: 5e-2 x 0.1), rew 1e-3 / 1e-2 (the progress term is a difference of
  two potentials of about 6e4, -|to_target| / dt, whose fp32 spacing is
  0.0039), done and time_outs exact;
- the PPO rollout's policy outputs 1e-5 (the same fp32 matmuls), its
  rewards, values and episode statistics as the env step's rew, obs as above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from isaacgymenv_tpu.envs.ant import Ant as JaxAnt  # noqa: E402
from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.learning import networks as jax_networks  # noqa: E402
from isaacgymenv_tpu.learning.running_stats import RunningStats as JaxRunningStats  # noqa: E402
from isaacgymenv_tpu.physics import builder as jax_builder  # noqa: E402
from isaacgymenv_tpu.physics import dynamics as jax_dynamics  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import kinematics as jax_kinematics  # noqa: E402
from isaacgymenv_tpu.physics import types as jax_types  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import compiled, env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.learning.ppo import PPO  # noqa: E402
from isaacgymenv_tpu_torch.physics import builder, dynamics, engine, fused, kinematics, types  # noqa: E402
from isaacgymenv_tpu_torch.utils.config import load_train_config  # noqa: E402

N = 8
STEP_TOLS = (("q", 2e-4, 2e-4), ("qd", 2e-3, 2e-3), ("dof_force", 2e-3, 2e-3), ("contact_force", 2e-3, 2e-2),
             ("joint_wrench", 2e-3, 5e-2), ("body_pos", 2e-4, 2e-4), ("slip_g", 2e-4, 2e-4))
OBS_TOL, REW_TOL = (2e-3, 5e-3), (1e-3, 1e-2)
SENSORS = slice(28, 52)  # the 24 sensor entries of the 60-wide obs


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    return (JaxAnt(jax_task_config("Ant", num_envs=N)),
            isaacgymenv_tpu_torch.make(task="Ant", num_envs=N, device="cpu"))


def _contact_state(env, seed):
    """q, qd, effort: the torso 0.28-0.33 m up, the legs spread at random."""
    rng = np.random.default_rng(seed)
    m = env.model
    q = np.zeros((N, m.nq), np.float32)
    q[:, 2] = 0.28 + 0.05 * rng.random(N)
    quat = rng.normal(size=(N, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = 0.3 * rng.normal(size=(N, m.nd))
    qd = (0.3 * rng.normal(size=(N, m.nv))).astype(np.float32)
    effort = (15.0 * rng.uniform(-1.0, 1.0, size=(N, m.nd))).astype(np.float32)
    return q, qd, effort


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
    assert (tm.nb, tm.nq, tm.nv, tm.nd, tm.ng) == (9, 15, 14, 8, 37)
    assert tm.sensor_body == (2, 4, 6, 8) == tuple(jax_env.feet_indices)
    _close(port_env.joint_gears, jax_env.joint_gears, 0, 0, "gears")
    _close(port_env.initial_dof_pos, jax_env.initial_dof_pos, 0, 0, "initial_dof_pos")


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step of Ant, one compiled substep chained."""
    jm = envs[0].model
    return substep_chain(jm, None, jax_types.make_zero_state(jm, N), jax_engine.Control.zero(jm, N))


def test_engine_step_with_sensors_matches_jax_xla_path(envs, jax_physics):
    jax_env, port_env = envs
    q, qd, effort = _contact_state(port_env, 3)
    jm, tm = jax_env.model, port_env.model
    js0 = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    jctrl = jax_engine.Control.zero(jm, N).replace(effort=jnp.asarray(effort))
    ref = jax_physics(js0, jctrl, port_env.dt, port_env.substeps)

    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd),
                              joint_wrench=None)  # a state made before the sensors: normalized by step
    assert engine._use_fused(tm, ts0.q) == "mono"
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), effort=torch.tensor(effort))
    out = engine.step(tm, None, ts0, tctrl, port_env.dt, port_env.substeps)

    in_contact = (np.linalg.norm(np.asarray(ref.contact_force), axis=-1) > 0).any(-1)
    assert in_contact.sum() >= N // 4, "the feet must be loaded by ground contacts"
    assert tuple(out.joint_wrench.shape) == (N, 4, 6)
    for field, rtol, atol in STEP_TOLS:
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def test_joint_wrench_static_weight():
    """tests/test_dynamics.py:439 as a parity case: a static hanging link's
    inbound-joint wrench is its weight, in the port's `aba` and JAX's
    `aba_lp`."""
    models = []
    for b, t in ((jax_builder, jax_types), (builder, types)):
        mb = b.ModelBuilder()
        base = mb.add_body("base", -1, t.JT_FIXED, joint_pos=(0, 0, 1.0), mass=1.0, inertia=np.diag([0.01] * 3))
        mb.add_body("arm", base, t.JT_REVOLUTE, joint_pos=(0, 0, 0), joint_axis=(0, 1, 0), mass=2.0,
                    com=(0, 0, -0.5), inertia=np.diag([0.1, 0.1, 0.01]))
        models.append(mb.finalize())
    jm, tm = models
    z = lambda m, k: np.zeros((4, k), np.float32)  # noqa: E731
    args = (z(jm, jm.nq), z(jm, jm.nv), z(jm, jm.nv))
    _, fj_j = compiled(lambda q, qd, tau: jax_dynamics.aba_lp(
        jm, jax_kinematics.fk(jm, q, qd), tau, return_joint_forces=True), *args)(*args)
    qdd, fj = dynamics.aba(tm, kinematics.fk(tm, torch.zeros(4, tm.nq), torch.zeros(4, tm.nv)),
                           torch.zeros(4, tm.nv), return_joint_forces=True)
    _close(qdd, 0.0, 0, 1e-5, "qdd")
    # rows [n(3), f(3)], body frame: the pure vertical support force m g
    _close(fj[:, 1], np.tile([0, 0, 0, 0, 0, 2.0 * 9.81], (4, 1)), 0, 1e-4, "arm wrench")
    _close(fj, fj_j, 0, 1e-5, "against aba_lp")


def _jax_reset_draws(key, n, nd):
    """The whole-batch draws of `Ant._reset_envs(state, mask, key)`."""
    k1, k2 = jax.random.split(key)
    return {"dof_pos": jax.random.uniform(k1, (n, nd), minval=-0.2, maxval=0.2),
            "dof_vel": jax.random.uniform(k2, (n, nd), minval=-0.1, maxval=0.1)}


@pytest.fixture(scope="module")
def jax_env_step(envs, jax_physics):
    """The JAX env step compiled together with the reset draws it makes from
    its state's key (step: key, k_reset, k_noise = split(state.rng, 3)), and
    a start state carried to both packages: the seeded contact state, two
    envs three steps from their time limit, one torso below the
    termination height."""
    jax_env, port_env = envs
    q, qd, _ = _contact_state(port_env, 5)
    q[3, 2] = 0.2
    progress = np.where(np.isin(np.arange(N), [1, 6]), jax_env.max_episode_length - 3, 0).astype(np.int32)
    key = jax.random.PRNGKey(7)
    ts = jax.device_get(jax_env._initial_ts(key))
    jm = jax_env.model
    # the body caches are refreshed by the step's physics before any use
    sim = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    jstate = jax.device_get(JaxEnvState(sim=sim, progress=jnp.asarray(progress), reset=jnp.zeros(N, bool),
                                        rng=key, ts=ts))
    fn = lambda st, a: (jax_env.step(st, a), _jax_reset_draws(jax.random.split(st.rng, 3)[1], N, jm.nd))  # noqa: E731
    return env_step(fn, jax_physics, jstate, jnp.zeros((N, 8))), jstate


def _port_state(jstate):
    return interop.env_state_from_jax({
        "sim": {f.name: getattr(jstate.sim, f.name) for f in dataclasses.fields(jstate.sim)},
        "progress": jstate.progress, "reset": jstate.reset, "ts": jstate.ts,
    }, device="cpu")


def test_env_steps_match_jax_with_injected_draws(envs, jax_env_step):
    _, port_env = envs
    jstep, jstate = jax_env_step
    tstate = _port_state(jstate)
    rng = np.random.default_rng(6)
    seen = {"reset": False, "timeout": False, "fallen": False}
    for i in range(5):
        actions = rng.uniform(-1.0, 1.0, size=(N, 8)).astype(np.float32)
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
        _close(tobs["obs"], jobs["obs"], *OBS_TOL, f"obs, step {i}")
        _close(tobs["obs"][:, SENSORS], np.asarray(jobs["obs"])[:, SENSORS], *OBS_TOL, f"sensor obs, step {i}")
        _close(trew, jrew, *REW_TOL, f"rew, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(textras["true_objective"], jextras["true_objective"], 2e-3, 2e-3, f"true_objective, step {i}")
        seen["reset"] |= bool(np.asarray(jdone).any()) and i < 4
        seen["timeout"] |= bool(np.asarray(jextras["time_outs"]).any())
        seen["fallen"] |= bool((np.asarray(jdone) & ~np.asarray(jextras["time_outs"])).any())
        assert np.abs(np.asarray(jobs["obs"])[:, SENSORS]).max() > 0.5, "the sensor entries must carry loads"
    assert all(seen.values()), f"every branch must run: {seen}"


def test_gate_sends_sensors_to_b1_and_refuses_them_off_it(envs):
    _, port_env = envs
    model = port_env.model
    q = torch.zeros(N, model.nq)
    assert engine._use_fused(model, q) == "mono" and fused.fused_structural_ok(model, N)
    assert not fused.fused_structural_ok(dataclasses.replace(model, sensor_body=(1,) * (fused.MAX_SENSORS + 1)), N)
    table = fused.pack_model(model)
    assert table.ns == 4 and list(table.sensor_body[:4]) == [2, 4, 6, 8]
    ctrl = engine.Control.zero(model, N)
    engine._check_supported(model, None, ctrl, "mono", "cuda")
    engine._check_supported(model, None, ctrl, None, "cpu")  # the plain loop has sensors
    for kind in ("split", None):  # on the card only B1 has them
        with pytest.raises(NotImplementedError, match="force sensors off B1"):
            engine._check_supported(model, None, ctrl, kind, "cuda")
    with pytest.raises(NotImplementedError, match="force sensors on the split pair"):
        engine._check_supported(model, None, ctrl, "split", "cpu")
    # the wrapper on a CPU state: the plain version, sensor wrenches last
    q, qd, effort = (torch.tensor(a) for a in _contact_state(port_env, 9))
    zero = torch.zeros_like(effort)
    args = (fused.tables_for(model, "cpu"), q, qd, zero, zero, effort, torch.zeros(N, model.ng, 3), 0.004, 2)
    before = fused.fused_substep.launches
    out, ref = fused.fused_substep(*args), fused.fused_substep_plain(*args)
    assert fused.fused_substep.launches == before and len(out) == 7 and tuple(out[6].shape) == (N, 4, 6)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_ppo_rollout_bookkeeping_matches_jax_loop(envs, jax_env_step):
    """The port's `PPO._rollout` (3 steps, the time-out bootstrap on)
    against a loop of the JAX env step and `ActorCritic.apply` with the same
    policy noise and reset draws, and the bookkeeping of JAX's `_rollout`
    (reward scale, bootstrap, episode statistics) written out here."""
    _, port_env = envs
    jstep, jstate = jax_env_step
    cfg = load_train_config("Ant")
    c = cfg["params"]["config"]
    c.update(horizon_length=3, minibatch_size=24, value_bootstrap=True)
    agent = PPO(port_env, cfg)
    gamma, scale = agent.cfg.gamma, agent.cfg.reward_scale

    rng = np.random.default_rng(11)
    net = jax_networks.ActorCritic(num_actions=8, units=(256, 128, 64), activation="elu")
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 60)))
    params = jax.tree_util.tree_map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    params["params"]["log_std"] = (0.3 * rng.normal(size=8) - 0.5).astype(np.float32)
    batch = (rng.normal(size=(64, 60)) * 3.0).astype(np.float32)
    jstats = JaxRunningStats.create((60,)).update(jnp.asarray(batch))
    vstats = JaxRunningStats.create(()).update(jnp.asarray(rng.normal(size=64).astype(np.float32) * 2.0 + 1.0))
    noise = [rng.normal(size=(N, 8)).astype(np.float32) for _ in range(3)]
    stats = lambda s: jax.device_get((s.mean, s.var, s.count))  # noqa: E731

    ts = interop.train_state_from_jax(agent, params, stats(jstats), stats(vstats), 3e-4)
    env_state = _port_state(jstate)
    obs = port_env.observations(env_state)["obs"]
    ts = dataclasses.replace(ts, env_state=env_state, last_obs=obs)

    @jax.jit
    def policy(p, o, eps):
        mu, log_std, value_n = net.apply(p, jstats.normalize(o))
        action = mu + jnp.exp(log_std) * eps
        return mu, action, jax_networks.gaussian_logp(mu, log_std, action), vstats.denormalize(value_n)

    # the JAX loop from the same state and first obs
    obs = jnp.asarray(obs.numpy())
    ep_ret, ep_len, m_ret, m_len = np.zeros(N), np.zeros(N), 0.0, 0.0
    want, draws = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done", "mu")}, []
    for t in range(3):
        mu, action, logp, value = policy(params, obs, noise[t])
        (jstate, obs_d, rew_raw, done, extras), d = jstep(jstate, action)
        draws.append({k: torch.tensor(np.asarray(v)) for k, v in d.items()})
        rew = np.asarray(rew_raw) * scale + gamma * np.asarray(value) * np.asarray(extras["time_outs"])
        dn = np.asarray(done).astype(np.float32)
        ep_ret, ep_len = ep_ret + np.asarray(rew_raw), ep_len + 1.0
        a = 0.99 ** dn.sum()
        m_ret = a * m_ret + (1 - a) * (ep_ret * dn).sum() / max(dn.sum(), 1.0)
        m_len = a * m_len + (1 - a) * (ep_len * dn).sum() / max(dn.sum(), 1.0)
        ep_ret, ep_len = ep_ret * (1 - dn), ep_len * (1 - dn)
        for k, v in zip(want, (obs, action, logp, value, rew, done, mu)):
            want[k].append(np.asarray(v))
        obs = obs_d["obs"]

    ts, got, metrics = agent._rollout(ts, noise=[torch.tensor(x) for x in noise], reset_draws=draws)
    tols = {"obs": OBS_TOL, "action": (1e-5, 1e-5), "mu": (1e-5, 1e-5), "logp": (1e-5, 1e-4),
            "value": (1e-5, 1e-4), "reward": REW_TOL, "done": (0, 0)}
    for k, (rtol, atol) in tols.items():
        _close(got[k], np.stack(want[k]), rtol, atol, k)
    assert np.asarray(want["done"]).any(), "episodes must end inside the horizon"
    assert any(np.asarray(jstate.progress) == 0), "a time-out and a reset must happen"
    _close(ts.last_obs, obs, *OBS_TOL, "last_obs")
    _close(ts.ep_return, ep_ret, *REW_TOL, "ep_return")
    _close(ts.ep_length, ep_len, 0, 0, "ep_length")
    _close(ts.mean_return, m_ret, *REW_TOL, "mean_return")
    _close(ts.mean_length, m_len, 1e-6, 1e-5, "mean_length")
    assert tuple(metrics["true_objective"].shape) == (3,)
