"""The port's AnymalTerrain slice against the JAX package on the CPU, N = 8 envs.

Both packages build AnymalTerrain once, in a module-scoped fixture, on a
2 levels x 5 types trimesh grid (`env.terrain.terrainType=trimesh`; the
config's own width of 10 x 20 runs on the card in chip_smoke.py) with the
per-env friction buckets.  The JAX side runs its XLA path (`engine.step` on
the CPU backend), which looks the heightfield up every substep; so does the
port's CPU path.  The fused kernel's held ground (sampled once per control
step) is tested through its plain version, `fused_substep_plain`, at one
substep, where the held and the per-substep semantics coincide.  States are
seeded with numpy on the top level, off the flat spawn platforms, with the
feet in contact on slopes, stairs and obstacles; reset, push and noise draws
repeat the JAX package's key splits and are handed to both packages.

Tolerances (rtol = atol unless stated), fp32 throughout:
- the terrain grid bitwise (the same numpy code and seed); height_at and
  terrain_normal atol 1e-6 (the same lookup; a normal is a difference of
  two heights over 0.2 m);
- model leaves 1e-5 relative / 1e-6 absolute, as tests/test_torch_anymal.py;
- engine.step those of tests/test_fused.py: q 2e-4, qd and dof_force 2e-3,
  contact_force rtol 2e-3 / atol 2e-2, body_pos 2e-4; slip 2e-4 as a position;
- env steps: obs rtol 1e-3 / atol 1e-2, rew and the per-term episode sums
  rtol 1e-3 / atol 1e-4, as the Anymal slice's card-vs-CPU check (the obs
  holds qd-scaled velocities and the height scan); done, time_outs and
  terrain levels exact;
- the policy 1e-5: the same fp32 matmuls.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.envs.anymal_terrain import AnymalTerrain as JaxAnymalTerrain  # noqa: E402
from isaacgymenv_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from isaacgymenv_tpu.learning.networks import ActorCritic as JaxActorCritic  # noqa: E402
from isaacgymenv_tpu.learning.running_stats import RunningStats as JaxRunningStats  # noqa: E402
from isaacgymenv_tpu.physics import contact as jax_contact  # noqa: E402
from isaacgymenv_tpu.physics import engine as jax_engine  # noqa: E402
from isaacgymenv_tpu.physics import types as jax_types  # noqa: E402
from isaacgymenv_tpu.utils import terrain as jax_terrain  # noqa: E402
from isaacgymenv_tpu.utils.config import load_task_config as jax_task_config  # noqa: E402
from tests.jax_reference import env_step, substep_chain  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop  # noqa: E402
from isaacgymenv_tpu_torch.learning.networks import ActorCritic  # noqa: E402
from isaacgymenv_tpu_torch.envs.anymal_terrain import REW_TERMS  # noqa: E402
from isaacgymenv_tpu_torch.physics import contact, engine, fused, kinematics, types  # noqa: E402
from isaacgymenv_tpu_torch.utils import terrain  # noqa: E402

N = 8
GRID = {"env.terrain.terrainType": "trimesh", "env.terrain.numLevels": 2, "env.terrain.numTerrains": 5}
TOP = 1  # the top level: difficulty 0.5, slopes 0.2, steps 0.1375 m, obstacles 0.1 m
STEP_TOLS = (("q", 2e-4, 2e-4), ("qd", 2e-3, 2e-3), ("dof_force", 2e-3, 2e-3),
             ("contact_force", 2e-3, 2e-2), ("body_pos", 2e-4, 2e-4), ("slip_g", 2e-4, 2e-4))


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    jax_env = JaxAnymalTerrain(jax_task_config("AnymalTerrain", num_envs=N, **GRID))
    port_env = isaacgymenv_tpu_torch.make(task="AnymalTerrain", num_envs=N, device="cpu", **GRID)
    # the anymal_minimal.urdf model, with its per-env friction, field by field
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
    assert (tm.nb, tm.nd, tm.ng) == (13, 12, 19) and tuple(tm.geom_friction.shape) == (N, 19)
    return jax_env, port_env


def _terrain_state(env, seed):
    """q, qd, pos_target: every env on the top level, 1.8-3 m off its
    sub-terrain's center (past the flat spawn platform), near the standing
    pose, lowered until its lowest geom is 0-5 mm into the ground."""
    rng = np.random.default_rng(seed)
    model, default = env.model, env.default_dof_pos.numpy()
    origins = env.terrain_origins[TOP, np.arange(N) % env.num_types].numpy()
    q = np.zeros((N, model.nq), np.float32)
    side = rng.choice([-1.0, 1.0], size=(N, 2))
    q[:, 0] = origins[:, 0] + side[:, 0] * rng.uniform(1.8, 3.0, N)
    q[:, 1] = origins[:, 1] + side[:, 1] * rng.uniform(0.0, 2.0, N)
    quat = rng.normal(size=(N, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = default + 0.2 * rng.normal(size=(N, model.nd))
    _, _, _, _, gpos, _ = engine._geom_world(model, kinematics.fk(model, torch.tensor(q), torch.zeros(N, model.nv)))
    clearance = gpos[..., 2] - model.geom_radius - contact.height_at(env.terrain, gpos[..., 0], gpos[..., 1])
    q[:, 2] -= clearance.min(-1).values.numpy() + rng.uniform(0.0, 0.005, N)
    qd = (0.3 * rng.normal(size=(N, model.nv))).astype(np.float32)
    tgt = (default + 0.3 * rng.normal(size=(N, model.nd))).astype(np.float32)
    return q, qd, tgt


@pytest.fixture(scope="module")
def jax_physics(envs):
    """The JAX engine.step on the heightfield, one compiled substep chained
    (tests/jax_reference.py).  The JAX env's model carries the per-env
    friction."""
    jax_env, _ = envs
    jm = jax_env.model
    # zero slip: the carry of the XLA path's scan, as engine.step starts it
    js0 = jax_types.make_zero_state(jm, N).replace(slip_g=jnp.zeros((N, jm.ng, 3)))
    return substep_chain(jm, jax_env.terrain, js0, jax_engine.Control.zero(jm, N))


@pytest.fixture(scope="module")
def jax_step(envs, jax_physics):
    """substeps -> (q, qd, pos_target, the JAX XLA path after one control
    step) from the seeded terrain state of seed 4 + substeps."""
    jax_env, port_env = envs
    jm = jax_env.model

    @functools.lru_cache(maxsize=None)
    def run(substeps):
        q, qd, tgt = _terrain_state(port_env, 4 + substeps)
        js = jax_types.make_zero_state(jm, N).replace(q=jnp.asarray(q), qd=jnp.asarray(qd),
                                                       slip_g=jnp.zeros((N, jm.ng, 3)))
        c = jax_engine.Control.zero(jm, N).replace(pos_target=jnp.asarray(tgt))
        return q, qd, tgt, jax.device_get(jax_physics(js, c, jax_env.dt, substeps))

    return run


def test_terrain_grid_bitwise_equal_to_jax(envs):
    jax_env, port_env = envs
    cfg = port_env.cfg["env"]["terrain"]
    ours, ref = terrain.TerrainGrid(cfg, N, seed=0), jax_terrain.TerrainGrid(dict(cfg), N, seed=0)
    np.testing.assert_array_equal(ours.height_field_raw, ref.height_field_raw)
    np.testing.assert_array_equal(ours.env_origins, ref.env_origins)
    np.testing.assert_array_equal(port_env.terrain.heights.numpy(), np.asarray(jax_env.terrain.heights))
    np.testing.assert_array_equal(port_env.terrain_origins.numpy(), np.asarray(jax_env.terrain_origins))
    assert np.ptp(ours.height_field_raw[:, :]) > 0


def test_height_lookup_and_normal_match_jax(envs):
    jax_env, port_env = envs
    jt = jax_env.terrain
    H, W = jt.heights.shape
    rng = np.random.default_rng(1)
    lo, hi = np.array([jt.border_x, jt.border_y]), np.array([jt.border_x, jt.border_y]) + jt.hscale * np.array([H, W])
    inside = rng.uniform(lo, hi, size=(512, 2))
    # cell edges: multiples of hscale from the border, and points just off them
    edges = lo + jt.hscale * rng.integers(1, [H - 1, W - 1], size=(256, 2))
    edges = np.concatenate([edges, edges + 1e-5, edges - 1e-5])
    outside = np.concatenate([lo - rng.uniform(0.01, 5.0, size=(64, 2)), hi + rng.uniform(0.0, 5.0, size=(64, 2))])
    pts = np.concatenate([inside, edges, outside]).astype(np.float32)
    x, y = pts[:, 0], pts[:, 1]
    want_h = jax_contact.height_at(jt, jnp.asarray(x), jnp.asarray(y))
    want_n = jax_contact.terrain_normal(jt, jnp.asarray(x), jnp.asarray(y))
    got_h = contact.height_at(port_env.terrain, torch.tensor(x), torch.tensor(y))
    got_n = contact.terrain_normal(port_env.terrain, torch.tensor(x), torch.tensor(y))
    _close(got_h, want_h, 0, 1e-6, "height_at")
    _close(got_n, want_n, 0, 1e-6, "terrain_normal")
    assert (np.abs(np.asarray(want_n)[:, 2]) < 0.999).sum() > 10, "the points must meet slopes or steps"


@pytest.mark.parametrize("substeps", [1, 8])
def test_engine_step_on_terrain_matches_jax_xla_path(envs, jax_step, substeps):
    _, port_env = envs
    q, qd, tgt, ref = jax_step(substeps)
    tm = port_env.model
    ts0 = dataclasses.replace(types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd))
    ts0 = engine.forward(tm, port_env.terrain, ts0)
    tctrl = dataclasses.replace(engine.Control.zero(tm, N), pos_target=torch.tensor(tgt))
    out = engine.step(tm, port_env.terrain, ts0, tctrl, port_env.dt, substeps)

    in_contact = (np.linalg.norm(np.asarray(ref.contact_force), axis=-1) > 0).any(-1)
    assert in_contact.sum() >= N // 4, "the ground-contact path must be exercised"
    for field, rtol, atol in STEP_TOLS:
        _close(getattr(out, field), getattr(ref, field), rtol, atol, field)


def test_held_ground_plain_version_matches_jax_at_one_substep(envs, jax_step):
    """The kernel's plain version with the ground held from the cached body
    poses (JAX engine.step's sampling for its kernel) against the XLA path at
    one substep, where holding and looking up every substep coincide."""
    _, port_env = envs
    q, qd, tgt, ref = jax_step(1)
    tm = port_env.model
    s0 = engine.forward(tm, port_env.terrain, dataclasses.replace(
        types.make_zero_state(tm, N), q=torch.tensor(q), qd=torch.tensor(qd)))
    held = contact.held_ground(tm, port_env.terrain, s0.body_pos, s0.body_quat)
    assert (held.normal[..., 2] < 0.999).any(), "the held normals must include slopes or steps"
    zero = torch.zeros(N, tm.nd)
    tables = fused.tables_for(tm, "cpu")
    args = (tables, s0.q, s0.qd, torch.tensor(tgt), zero, zero, s0.slip_g, port_env.dt, 1)
    kw = dict(ground_h=held.height, ground_n=held.normal, geom_fric=tm.geom_friction)
    out = fused.fused_substep_plain(*args, **kw)
    before = fused.fused_substep.launches
    wrapped = fused.fused_substep(*args, **kw)  # a CPU state: the plain version, no launch
    assert fused.fused_substep.launches == before
    assert out[6] is None and wrapped[6] is None  # no force sensors
    assert all(torch.equal(a, b) for a, b in zip(out[:6], wrapped[:6]))
    got = {"q": out[0], "qd": out[1], "dof_force": out[2], "contact_force": out[3], "slip_g": out[5]}
    for field, rtol, atol in STEP_TOLS:
        if field in got:
            _close(got[field], getattr(ref, field), rtol, atol, f"held {field}")


def _jax_draws(rng, env):
    """The whole-batch draws of one JAX `TaskEnv.step` from its state's key:
    those of `AnymalTerrain._reset_envs(state, mask, key)` and the push and
    noise draws of `AnymalTerrain._post_physics`."""
    n, nd, r = env.num_envs, env.model.nd, env.command_ranges
    k_pos, k_vel, k_cmd, k_xy = jax.random.split(jax.random.split(rng, 3)[1], 4)
    kx, ky, kw = jax.random.split(k_cmd, 3)
    cmd = [jax.random.uniform(k, (n,), minval=r[name][0], maxval=r[name][1])
           for k, name in ((kx, "linear_x"), (ky, "linear_y"), (kw, "yaw"))]
    reset = {
        "pos_offset": jax.random.uniform(k_pos, (n, nd), minval=0.5, maxval=1.5),
        "vel": jax.random.uniform(k_vel, (n, nd), minval=-0.1, maxval=0.1),
        "commands": jnp.stack(cmd, axis=-1),
        "xy": jax.random.uniform(k_xy, (n, 2), minval=-0.5, maxval=0.5),
    }
    step = {
        "push": jax.random.uniform(jax.random.fold_in(rng, 1234), (n, 2), minval=-1.0, maxval=1.0),
        "noise": jax.random.uniform(jax.random.split(rng, 3)[2], (n, env.num_obs)),
    }
    return reset, step


def test_env_steps_match_jax_with_injected_draws(envs, jax_physics):
    jax_env, port_env = envs
    jm = jax_env.model
    # the port's initial state with injected levels, 6 of 8 envs on the top
    # level, whose robots are moved 2.5 m off their spawn platform onto the
    # slopes, stairs and obstacles; two envs near their time limit; a push
    # due at the third step.  It is carried to the JAX side as numpy; the
    # resets inside the steps run both packages' reset code.
    levels = torch.tensor(np.where(np.arange(N) % 4 == 0, 0, TOP))
    tstate = port_env.initial_state(seed=5, initial_draws={
        "terrain_levels": levels, "terrain_types": torch.arange(N) % port_env.num_types})
    tm = port_env.model
    rs = types.root_state(tm, tstate.sim)[:, 0].clone()
    rs[:, 0] += 2.5 * (levels == TOP)
    rs[:, 2] = contact.height_at(port_env.terrain, rs[:, 0], rs[:, 1]) + 0.56
    sim = engine.forward(tm, port_env.terrain, types.set_root_state(tm, tstate.sim, rs))
    progress = torch.where(torch.isin(torch.arange(N), torch.tensor([1, 6])), port_env.max_episode_length - 3, 0)
    tstate = dataclasses.replace(tstate, sim=sim, progress=progress.to(torch.int32), ts=dict(
        tstate.ts, common_step=torch.tensor(port_env.push_interval - 3, dtype=torch.int32)))
    jnp_of = lambda t: jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64 else t.numpy())  # noqa: E731
    jstate = JaxEnvState(
        sim=jax_types.SimState(**{f.name: None if getattr(sim, f.name) is None else jnp_of(getattr(sim, f.name))
                                  for f in dataclasses.fields(sim)}),
        progress=jnp_of(tstate.progress), reset=jnp_of(tstate.reset), rng=jax.random.PRNGKey(5),
        ts={k: jnp_of(v) for k, v in tstate.ts.items()},
    )

    rng = np.random.default_rng(6)
    # one compile: the step (its physics the compiled substep chain) and the
    # draws it makes from the state's key
    jstep = env_step(lambda st, a: (jax_env.step(st, a), _jax_draws(st.rng, jax_env)), jax_physics,
                     jstate, jnp.zeros((N, 12)))
    torch_of = lambda d: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    seen = {"reset": False, "move": False, "push": False, "contact": False}
    for i in range(5):
        actions = rng.uniform(-1.0, 1.0, size=(N, 12)).astype(np.float32)
        levels_before = np.asarray(jstate.ts["terrain_levels"])
        (jstate, jobs, jrew, jdone, jextras), draws = jstep(jstate, jnp.asarray(actions))
        reset_draws, step_draws = map(torch_of, draws)
        tstate, tobs, trew, tdone, textras = port_env.step(
            tstate, torch.tensor(actions), reset_draws=reset_draws, step_draws=step_draws)
        _close(tobs["obs"], jobs["obs"], 1e-3, 1e-2, f"obs, step {i}")
        _close(trew, jrew, 1e-3, 1e-4, f"rew, step {i}")
        # the 13 terms before the clip at 0 (the clipped reward is often 0 here)
        for k in REW_TERMS:
            _close(tstate.ts[f"epsum_{k}"], jstate.ts[f"epsum_{k}"], 1e-3, 1e-4, f"epsum_{k}, step {i}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), f"done, step {i}")
        np.testing.assert_array_equal(textras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        np.testing.assert_array_equal(tstate.ts["terrain_levels"].numpy(), np.asarray(jstate.ts["terrain_levels"]))
        _close(tstate.ts["commands"], jstate.ts["commands"], 1e-4, 1e-4, f"commands, step {i}")
        seen["reset"] |= bool(np.asarray(jdone).any())
        seen["move"] |= bool((np.asarray(jstate.ts["terrain_levels"]) != levels_before).any())
        seen["push"] |= int(jstate.ts["common_step"]) % jax_env.push_interval == 0
        seen["contact"] |= bool((np.linalg.norm(np.asarray(jstate.sim.contact_force), axis=-1) > 0).any())
    assert all(seen.values()), f"every branch must run: {seen}"


def test_acting_step_with_carried_weights(envs):
    rng = np.random.default_rng(8)
    obs = (rng.normal(size=(N, 188)) * 2.0).astype(np.float32)
    batch = (rng.normal(size=(64, 188)) * 3.0 + 1.0).astype(np.float32)

    units = (512, 256, 128)  # cfg/train/AnymalTerrainPPO.yaml
    net = JaxActorCritic(num_actions=12, units=units, activation="elu")
    # the network's parameter tree, filled from the numpy seed
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(9), jnp.zeros((1, 188)))
    params = jax.tree_util.tree_map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    params["params"]["log_std"] = (0.3 * rng.normal(size=12)).astype(np.float32)

    def forward(p, b, o):
        stats = JaxRunningStats.create((188,)).update(b)
        return stats, net.apply(p, stats.normalize(o))

    jstats, (jmu, jlog_std, jvalue) = jax.jit(forward)(params, jnp.asarray(batch), jnp.asarray(obs))

    policy = ActorCritic(188, 12, units=units, activation="elu")
    policy.load_state_dict(interop.policy_from_jax(params))
    stats = interop.running_stats_from_jax(*jax.device_get((jstats.mean, jstats.var, jstats.count)), device="cpu")
    with torch.no_grad():
        mu, log_std, value = policy(stats.normalize(torch.tensor(obs)))
    _close(mu, jmu, 1e-5, 1e-5, "mu")
    _close(log_std, jlog_std, 1e-5, 1e-5, "log_std")
    _close(value, jvalue, 1e-5, 1e-5, "value")


def test_gate_takes_terrain_to_b1_and_refuses_it_on_the_split_pair(envs):
    jax_env, port_env = envs
    model = port_env.model
    # a JAX heightfield and a 2-D friction carried across as numpy
    jt = jax_env.terrain
    hf = interop.heightfield_from_jax(np.asarray(jt.heights), jt.hscale, jt.border_x, jt.border_y, device="cpu")
    assert torch.equal(hf.heights, port_env.terrain.heights) and hf.hscale == port_env.terrain.hscale
    carried = interop.with_geom_friction(model, np.asarray(jax_env.model.geom_friction))
    assert torch.equal(carried.geom_friction, model.geom_friction)

    assert model.geom_friction.ndim == 2 and fused.fused_structural_ok(model, N)
    assert engine._use_fused(model, torch.zeros(N, model.nq)) == "mono"
    # per-env friction of another batch: no kernel takes it (kind None)
    assert not fused.fused_structural_ok(model, N + 1)
    assert engine._use_fused(model, torch.zeros(N + 1, model.nq)) is None
    assert fused.pack_model(model).geom_mu[0] == 0.0  # per-env friction is a kernel input
    state = port_env.initial_state(seed=0)
    ctrl = engine.Control.zero(model, N)
    engine.step(model, port_env.terrain, state.sim, ctrl, port_env.dt, 1)  # accepted
    split = dataclasses.replace(model, no_ground=True)
    assert engine._use_fused(split, state.sim.q) == "split"
    # on the card, terrain or per-env friction off B1 (the split pair, or
    # kind None) raises; on the CPU the plain loop runs both
    engine._check_supported(model, port_env.terrain, "mono", "cuda")
    for kind in ("split", None):
        with pytest.raises(NotImplementedError, match="heightfield terrain off B1"):
            engine._check_supported(model, port_env.terrain, kind, "cuda")
        with pytest.raises(NotImplementedError, match="per-env friction off B1"):
            engine._check_supported(model, None, kind, "cuda")
        engine._check_supported(model, port_env.terrain, kind, "cpu")
