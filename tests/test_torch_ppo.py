"""The port's PPO learner, config overrides and training CLI against the JAX
package on the CPU.

The learner is held to JAX's `PPO` on fixed batches: the Gaussian
functions, GAE, and one `_update` (2 mini-epochs of 2 minibatches of 16)
from a state carried across (`interop.train_state_from_jax`) with JAX's own
minibatch permutations injected; and the same for the asymmetric
actor-critic of ShadowHandOpenAI_FF (obs 42, states 211): the central value
network, GAE on its values, and one `_update` with its own 2 mini-epochs
and permutations, from a state whose Adam moments (both networks') JAX's
first update made.  Every train config the port ships is read into the
learner's config as JAX's `PPO` reads it.  The JAX learner
is built on an object that only carries the env's sizes: no JAX env is
built here.  The CLI runs the port
alone: Ant at 8 envs on the CPU for 2 epochs, then a resume from the
checkpoint it wrote; ShadowHandOpenAI_FF at 8 envs for one epoch, then a
resume.

Tolerances (rtol / atol), fp32 throughout:
- the Gaussian functions 1e-6 / 1e-5, GAE 1e-6 / 1e-5: the same
  elementwise formulas;
- the update: parameters 1e-4 / 2e-6 (four Adam steps of at most about
  lr each; an element whose gradient is near zero moves by
  lr * g / (|g| + eps), sensitive to the last bits of g), the learning
  rate after the adaptive steps 1e-6, the losses and kl 1e-4 / 1e-6, the
  normalizers 1e-5 / 1e-6; the central value's parameters as the policy's,
  its forward 1e-5 / 1e-5 (the same fp32 matmuls).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.learning import networks as jax_networks  # noqa: E402
from isaacgymenv_tpu.learning.ppo import PPO as JaxPPO  # noqa: E402
from isaacgymenv_tpu.learning.ppo import TrainState as JaxTrainState  # noqa: E402
from isaacgymenv_tpu.learning.running_stats import RunningStats as JaxRunningStats  # noqa: E402
from isaacgymenv_tpu.utils import config as jax_config  # noqa: E402
from tests.jax_reference import compiled as _jax_compiled  # noqa: E402

import isaacgymenv_tpu_torch  # noqa: E402
from isaacgymenv_tpu_torch import interop, train  # noqa: E402
from isaacgymenv_tpu_torch.learning import checkpoint, networks  # noqa: E402
from isaacgymenv_tpu_torch.learning.ppo import PPO, PPOConfig  # noqa: E402
from isaacgymenv_tpu_torch.utils import config  # noqa: E402

N, H, OBS, ACT = 8, 4, 60, 8


def _close(got, want, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


class _Sizes:
    """What JAX's `PPO` reads of its env outside a rollout."""
    num_envs, num_obs, num_actions, num_states = N, OBS, ACT, 0


def _train_cfg():
    cfg = config.load_train_config("Ant")
    cfg["params"]["config"].update(horizon_length=H, minibatch_size=16, mini_epochs=2, learning_rate=3e-3,
                                   kl_threshold=2e-4)
    return cfg


@pytest.fixture(scope="module")
def learners():
    """JAX's learner and a JAX state (numpy-seeded policy, normalizers fitted
    to a batch), the port's learner on Ant at N envs and the same state
    carried across, and a fixed rollout batch made with the JAX policy."""
    cfg = _train_cfg()
    jagent = JaxPPO(_Sizes(), cfg)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(jagent.network.init, jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    params = jax.tree_util.tree_map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    params["params"]["log_std"] = (0.2 * rng.normal(size=ACT) - 0.7).astype(np.float32)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731

    def state(params, obs_batch, value_batch, last_obs):
        return JaxTrainState(
            params=params, opt_state=jagent.tx.init(params), obs_stats=JaxRunningStats.create((OBS,)).update(obs_batch),
            value_stats=JaxRunningStats.create(()).update(value_batch), lr=jnp.asarray(3e-3, jnp.float32),
            env_state=None, last_obs=last_obs, key=jax.random.PRNGKey(5), epoch=jnp.asarray(0, jnp.int32),
            ep_return=jnp.zeros(N), ep_length=jnp.zeros(N), mean_return=jnp.zeros(()), mean_length=jnp.zeros(()),
        )

    inputs = (params, f32(64, OBS) * 2.0 + 0.5, f32(64) * 3.0 + 1.0, f32(N, OBS) * 2.0)
    jts = _jax_compiled(state, *inputs)(*inputs)  # one program instead of many eager ones
    obs_stats, value_stats = jts.obs_stats, jts.value_stats

    def rollout_batch(params, obs, eps):
        mu, log_std, value_n = jagent.network.apply(params, obs_stats.normalize(obs))
        action = mu + jnp.exp(log_std) * eps
        return {"obs": obs, "action": action, "logp": jax_networks.gaussian_logp(mu, log_std, action),
                "value": value_stats.denormalize(value_n), "mu": mu, "log_std": log_std}

    inputs = (params, jnp.asarray(f32(H, N, OBS) * 2.0), jnp.asarray(f32(H, N, ACT)))
    batch = dict(_jax_compiled(rollout_batch, *inputs)(*inputs))
    batch["reward"] = jnp.asarray(f32(H, N))
    batch["done"] = jnp.asarray(rng.random((H, N)) < 0.2)
    jgae = _jax_compiled(jagent._gae, jts, batch)

    port_env = isaacgymenv_tpu_torch.make(task="Ant", num_envs=N, device="cpu")
    agent = PPO(port_env, cfg)
    stats = lambda s: jax.device_get((s.mean, s.var, s.count))  # noqa: E731
    ts = interop.train_state_from_jax(agent, params, stats(obs_stats), stats(value_stats), np.asarray(jts.lr))
    ts = dataclasses.replace(ts, last_obs=torch.tensor(np.asarray(jts.last_obs)))
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    return jagent, jts, batch, jgae, agent, ts, tbatch


OBS_SH, ACT_SH, STATES_SH = 42, 20, 211  # ShadowHandOpenAI_FF


class _SizesCV:
    """The env sizes JAX's `PPO` reads, with the asymmetric states."""
    num_envs, num_obs, num_actions, num_states = N, OBS_SH, ACT_SH, STATES_SH


def _cv_train_cfg():
    cfg = config.load_train_config("ShadowHandOpenAI_FF")
    cfg["params"]["config"].update(horizon_length=H, minibatch_size=16, mini_epochs=2, learning_rate=3e-3,
                                   kl_threshold=2e-4)
    cfg["params"]["config"]["central_value_config"].update(mini_epochs=2, learning_rate=3e-3)
    return cfg


def _perms(key, mini_epochs, B, M):
    """JAX's minibatch permutations of its actor update: per mini-epoch,
    key, k_perm = split(key); permutation(k_perm, B).  Returns (key, perms)."""
    perms = []
    for _ in range(mini_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k_perm, B)).reshape(M, B // M))
    return key, np.stack(perms)


@pytest.fixture(scope="module")
def cv_learners():
    """JAX's asymmetric learner and a JAX state after one JAX `_update`
    (numpy-seeded policy and central value, normalizers fitted to a batch;
    the update gives both Adam states their moments), the compiled update,
    a fixed rollout batch with the central value's values, and the port's
    learner on ShadowHandOpenAI_FF at N envs with the state carried across."""
    cfg = _cv_train_cfg()
    jagent = JaxPPO(_SizesCV(), cfg)
    assert jagent.central_value and jagent.cv_mini_epochs == 2
    rng = np.random.default_rng(30)
    seeded = lambda tree, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (s * rng.normal(size=a.shape)).astype(np.float32), tree)
    params = seeded(jax.eval_shape(jagent.network.init, jax.random.PRNGKey(0), jnp.zeros((1, OBS_SH))), 0.1)
    params["params"]["log_std"] = (0.2 * rng.normal(size=ACT_SH) - 0.7).astype(np.float32)
    cv_params = seeded(jax.eval_shape(jagent.cv_network.init, jax.random.PRNGKey(0), jnp.zeros((1, STATES_SH))), 0.05)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731

    def state(params, cv_params, obs_batch, states_batch, value_batch, last_obs, last_states):
        return JaxTrainState(
            params=params, opt_state=jagent.tx.init(params),
            obs_stats=JaxRunningStats.create((OBS_SH,)).update(obs_batch),
            value_stats=JaxRunningStats.create(()).update(value_batch), lr=jnp.asarray(3e-3, jnp.float32),
            env_state=None, last_obs=last_obs, key=jax.random.PRNGKey(31), epoch=jnp.asarray(0, jnp.int32),
            ep_return=jnp.zeros(N), ep_length=jnp.zeros(N), mean_return=jnp.zeros(()), mean_length=jnp.zeros(()),
            cv_params=cv_params, cv_opt_state=jagent.cv_tx.init(cv_params),
            states_stats=JaxRunningStats.create((STATES_SH,)).update(states_batch), last_states=last_states,
        )

    inputs = (params, cv_params, f32(64, OBS_SH) * 2.0 + 0.5, f32(64, STATES_SH) * 3.0 - 0.5, f32(64) * 3.0 + 1.0,
              f32(N, OBS_SH) * 2.0, f32(N, STATES_SH) * 3.0)
    jts = _jax_compiled(state, *inputs)(*inputs)  # one program instead of many eager ones
    obs_stats, states_stats, value_stats = jts.obs_stats, jts.states_stats, jts.value_stats

    def rollout_batch(params, cv_params, obs, states, eps):
        mu, log_std, _ = jagent.network.apply(params, obs_stats.normalize(obs))
        action = mu + jnp.exp(log_std) * eps
        value_n = jagent.cv_network.apply(cv_params, states_stats.normalize(states))
        return {"obs": obs, "states": states, "action": action, "mu": mu, "log_std": log_std,
                "logp": jax_networks.gaussian_logp(mu, log_std, action), "value": value_stats.denormalize(value_n)}

    inputs = (jnp.asarray(f32(H, N, OBS_SH) * 2.0), jnp.asarray(f32(H, N, STATES_SH) * 3.0),
              jnp.asarray(f32(H, N, ACT_SH)))
    rollout = _jax_compiled(rollout_batch, params, cv_params, *inputs)
    outcome = {"reward": jnp.asarray(f32(H, N)), "done": jnp.asarray(rng.random((H, N)) < 0.2)}
    batch = {**rollout(params, cv_params, *inputs), **outcome}
    jgae = _jax_compiled(jagent._gae, jts, batch)
    advs, returns = jgae(jts, batch)
    jupdate = _jax_compiled(jagent._update, jts, batch, advs, returns)
    jts, _ = jupdate(jts, batch, advs, returns)  # the Adam moments of a first update
    batch = {**rollout(jts.params, jts.cv_params, *inputs), **outcome}  # on-policy for the state it now holds

    agent = PPO(isaacgymenv_tpu_torch.make(task="ShadowHandOpenAI_FF", num_envs=N, device="cpu"), cfg)
    host = jax.device_get(jts)
    stats = lambda s: (s.mean, s.var, s.count)  # noqa: E731
    adam = host.opt_state[1].inner_state[0]      # clip, inject_hyperparams(adam): (scale_by_adam, lr)
    cv_adam = host.cv_opt_state[1][0]            # clip, adam: (scale_by_adam, lr)
    ts = interop.train_state_from_jax(
        agent, host.params, stats(host.obs_stats), stats(host.value_stats), host.lr,
        adam=(adam.mu, adam.nu, adam.count), cv_params_np=host.cv_params,
        cv_adam=(cv_adam.mu, cv_adam.nu, cv_adam.count), states_stats=stats(host.states_stats))
    ts = dataclasses.replace(ts, last_obs=torch.tensor(host.last_obs),
                             cv=dataclasses.replace(ts.cv, last_states=torch.tensor(host.last_states)))
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    return jagent, jts, batch, jgae, jupdate, agent, ts, tbatch


def test_gaussian_functions_match_jax():
    rng = np.random.default_rng(1)
    mu0, mu1, a = (rng.normal(size=(N, ACT)).astype(np.float32) for _ in range(3))
    ls0, ls1 = ((0.3 * rng.normal(size=(N, ACT)) - 0.5).astype(np.float32) for _ in range(2))
    t = torch.tensor
    _close(networks.gaussian_logp(t(mu0), t(ls0), t(a)), jax_networks.gaussian_logp(mu0, ls0, a), 1e-6, 1e-5, "logp")
    _close(networks.gaussian_entropy(t(ls0)), jax_networks.gaussian_entropy(ls0), 1e-6, 1e-5, "entropy")
    _close(networks.gaussian_kl(t(mu0), t(ls0), t(mu1), t(ls1)), jax_networks.gaussian_kl(mu0, ls0, mu1, ls1),
           1e-6, 1e-5, "kl")


def test_gae_matches_jax(learners):
    jagent, jts, batch, jgae, agent, ts, tbatch = learners
    want_adv, want_ret = jgae(jts, batch)
    adv, ret = agent._gae(ts, tbatch)
    assert bool(np.asarray(batch["done"]).any()), "episode ends must cut the recursion"
    _close(adv, want_adv, 1e-6, 1e-5, "advantages")
    _close(ret, want_ret, 1e-6, 1e-5, "returns")


def test_update_from_carried_state_matches_jax(learners):
    jagent, jts, batch, jgae, agent, ts, tbatch = learners
    assert agent.num_minibatches == jagent.num_minibatches == 2
    advs, returns = jgae(jts, batch)
    want_ts, want = _jax_compiled(jagent._update, jts, batch, advs, returns)(jts, batch, advs, returns)
    # JAX's permutations: per mini-epoch, key, k_perm = split(key); permutation(k_perm, B)
    key, perms = jts.key, []
    B, M = H * N, jagent.num_minibatches
    for _ in range(jagent.cfg.mini_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k_perm, B)).reshape(M, B // M))
    got_ts, got = agent._update(ts, tbatch, torch.tensor(np.asarray(advs)), torch.tensor(np.asarray(returns)),
                                perms=torch.tensor(np.stack(perms)))

    ref_params = interop.policy_from_jax(jax.device_get(want_ts.params))
    for name, value in got_ts.params.items():
        _close(value, ref_params[name], 1e-4, 2e-6, name)
    moved = max(float((got_ts.params[k] - ts.params[k]).abs().max()) for k in ts.params)
    assert moved > 1e-3, "the update must move the parameters"
    # lr: 3e-3 scaled by 1.5 or 1 / 1.5 per minibatch step from its kl
    _close(got["lr"], want["lr"], 1e-6, 0, "lr")
    assert float(want["lr"]) != 3e-3
    for k in ("loss", "kl", "a_loss", "v_loss", "entropy"):
        _close(got[k], want[k], 1e-4, 1e-6, k)
    for name in ("obs_stats", "value_stats"):
        for f in ("mean", "var", "count"):
            _close(getattr(getattr(got_ts, name), f), getattr(getattr(want_ts, name), f), 1e-5, 1e-6, f"{name}.{f}")
    assert got_ts.epoch == 1 and int(got_ts.opt_state["count"]) == 4


def test_central_value_forward_with_carried_weights(cv_learners):
    jagent, jts, batch, _, _, agent, ts, _ = cv_learners
    assert tuple(agent.cv_network.state_dict()["cv_dense.0.weight"].shape) == (512, STATES_SH)
    states = np.asarray(batch["states"][0])
    forward = jax.jit(jagent.cv_network.apply)
    want = forward(jts.cv_params, states)
    net = networks.CentralValueNet(STATES_SH, units=(512, 512, 256, 128), activation="elu")
    net.load_state_dict(interop.central_value_from_jax(jax.device_get(jts.cv_params)))
    with torch.no_grad():
        _close(net(torch.tensor(states)), want, 1e-5, 1e-5, "value")
    _close(agent.apply_cv(ts.cv, torch.tensor(states)),
           forward(jts.cv_params, np.asarray(jts.states_stats.normalize(states))), 1e-5, 1e-5, "normalized")


def test_gae_with_central_value_matches_jax(cv_learners):
    _, jts, batch, jgae, _, agent, ts, tbatch = cv_learners
    want_adv, want_ret = jgae(jts, batch)  # bootstrapped from the central value of the last states
    adv, ret = agent._gae(ts, tbatch)
    _close(adv, want_adv, 1e-6, 1e-5, "advantages")
    _close(ret, want_ret, 1e-6, 1e-5, "returns")


def test_update_with_central_value_matches_jax(cv_learners):
    jagent, jts, batch, jgae, jupdate, agent, ts, tbatch = cv_learners
    advs, returns = jgae(jts, batch)
    want_ts, want = jupdate(jts, batch, advs, returns)
    # the actor's permutations, then the central value's: key, k_cv = split(key);
    # one permutation per cv mini-epoch from split(k_cv, cv_mini_epochs)
    B, M = H * N, jagent.num_minibatches
    key, perms = _perms(jts.key, jagent.cfg.mini_epochs, B, M)
    cv_perms = np.stack([np.asarray(jax.random.permutation(k, B)).reshape(M, B // M)
                         for k in jax.random.split(jax.random.split(key)[1], jagent.cv_mini_epochs)])
    got_ts, got = agent._update(ts, tbatch, torch.tensor(np.asarray(advs)), torch.tensor(np.asarray(returns)),
                                perms=torch.tensor(perms), cv_perms=torch.tensor(cv_perms))

    host = jax.device_get(want_ts)
    for label, ref, ours, before in (
        ("policy", interop.policy_from_jax(host.params), got_ts.params, ts.params),
        ("central value", interop.central_value_from_jax(host.cv_params), got_ts.cv.params, ts.cv.params),
    ):
        for name, value in ours.items():
            _close(value, ref[name], 1e-4, 2e-6, f"{label} {name}")
        assert max(float((ours[k] - before[k]).abs().max()) for k in before) > 1e-3, f"the {label} must move"
    # the actor's value head is unused: no gradient, zero moments, no move
    for name in ("value.weight", "value.bias"):
        assert torch.equal(got_ts.params[name], ts.params[name]) and not got_ts.opt_state["mu"][name].any()
    _close(got["lr"], want["lr"], 1e-6, 0, "lr")
    for k in ("loss", "kl", "a_loss", "v_loss", "entropy"):
        _close(got[k], want[k], 1e-4, 1e-6, k)
    for name, ours in (("obs_stats", got_ts.obs_stats), ("value_stats", got_ts.value_stats),
                       ("states_stats", got_ts.cv.stats)):
        for f in ("mean", "var", "count"):
            _close(getattr(ours, f), getattr(getattr(want_ts, name), f), 1e-5, 1e-6, f"{name}.{f}")
    assert int(got_ts.opt_state["count"]) == int(got_ts.cv.opt_state["count"]) == 8


def test_slim_checkpoint_with_central_value_refills(cv_learners, tmp_path):
    *_, agent, ts, _ = cv_learners
    path = str(tmp_path / "best.ckpt")
    checkpoint.save_train_state(ts, path, slim=True)
    slim = checkpoint.load_train_state(agent, path)
    assert slim.env_state is None and slim.last_obs is None and slim.cv.last_states is None
    for what, ours, want in (("params", slim.cv.params, ts.cv.params), ("mu", slim.cv.opt_state["mu"],
                             ts.cv.opt_state["mu"]), ("nu", slim.cv.opt_state["nu"], ts.cv.opt_state["nu"])):
        assert all(torch.equal(ours[k], v) for k, v in want.items()), what
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(slim.cv.stats, f), getattr(ts.cv.stats, f)), f
    full = checkpoint.refill_slim(agent, slim, seed=3)
    assert full.env_state is not None and full.last_obs.shape == (N, 42)
    assert full.cv.last_states.shape == (N, 211) and full.cv.params is slim.cv.params
    assert torch.equal(full.cv.last_states, agent.env.observations(full.env_state)["states"])


@pytest.mark.parametrize("value", ["3e-4", "[1, 2]", "True", "abc", "7"])
def test_cli_overrides_parse_like_the_jax_package(value):
    ours, ref = {"a": {"b": 1}}, {"a": {"b": 1}}
    config.apply_cli_overrides(ours, [f"++a.c.d={value}", f"a.b={value}", "ignored"])
    jax_config.apply_cli_overrides(ref, [f"++a.c.d={value}", f"a.b={value}", "ignored"])
    assert ours == ref
    assert config.get_dotted(ours, "a.c.d") == jax_config.get_dotted(ref, "a.c.d")
    assert config.get_dotted(ours, "a.x.y", "missing") == "missing"


def agent_for(num_envs: int) -> PPO:
    """A CPU learner of the CLI test's config over `num_envs` Ant envs."""
    train_cfg = config.load_train_config("Ant")
    train_cfg["params"]["config"].update(horizon_length=4, minibatch_size=16)
    return PPO(isaacgymenv_tpu_torch.make(task="Ant", num_envs=num_envs, device="cpu"), train_cfg)


def test_cli_trains_saves_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["task=Ant", "sim_device=cpu", "num_envs=8", "experiment=ant", "seed=3",
            "train.params.config.horizon_length=4", "train.params.config.minibatch_size=16"]
    # every epoch writes last_ant.ckpt, and the second a slim best-return one
    ts = train.main(args + ["max_iterations=2", "train.params.config.save_frequency=1",
                            "train.params.config.save_best_after=1"])
    nn = tmp_path / "runs" / "ant" / "nn"
    path, best = nn / "ant.ckpt", nn / "ant_best.ckpt"
    assert ts.epoch == 2 and path.exists() and best.exists()
    assert checkpoint.load_train_state(agent_for(8), str(nn / "last_ant.ckpt")).epoch == 2
    rows = (tmp_path / "runs" / "ant" / "summaries" / "metrics.csv").read_text().splitlines()
    assert {r.split(",")[1] for r in rows} >= {"loss", "kl", "lr", "mean_return"}
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows)

    payload = torch.load(path, weights_only=True)  # before a resume writes ant.ckpt again
    agent = agent_for(8)
    loaded = checkpoint.load_train_state(agent, str(path))
    assert all(torch.equal(loaded.params[k], v) for k, v in ts.params.items())
    assert torch.equal(loaded.env_state.sim.q, ts.env_state.sim.q) and loaded.epoch == 2
    assert torch.equal(loaded.rng.get_state(), ts.rng.get_state())
    obs = loaded.last_obs
    mu = agent.apply(loaded.params, agent._norm_obs(loaded.obs_stats, obs))[0]
    assert torch.equal(agent.act(loaded, obs), mu)
    assert not torch.equal(agent.act(loaded, obs, False, torch.Generator().manual_seed(0)), mu)
    resumed = train.main(args + ["max_iterations=1", f"checkpoint={path}"])
    assert resumed.epoch == 3
    # the slim best-return checkpoint resumes at another env count: env state,
    # last obs and episode statistics come from a fresh reset
    slim = checkpoint.load_train_state(agent_for(4), str(best))
    assert slim.env_state is None and slim.last_obs is None
    resumed = train.main(args[:2] + ["num_envs=4"] + args[3:] + ["max_iterations=1", f"checkpoint={best}"])
    assert resumed.epoch == 3 and resumed.ep_return.shape == (4,) and resumed.env_state.sim.q.shape[0] == 4
    # a checkpoint written on the card (a CUDA generator's 16-byte state) resumes on the CPU
    for holder in (payload["state"], payload["state"]["env_state"]):
        holder["rng"] = torch.arange(16, dtype=torch.uint8)
    moved = tmp_path / "from_card.ckpt"
    torch.save(payload, moved)
    crossed = checkpoint.load_train_state(agent, str(moved))
    assert crossed.rng.device.type == "cpu" and crossed.env_state.rng.device.type == "cpu"
    assert torch.equal(crossed.rng.get_state(), checkpoint.load_train_state(agent, str(moved)).rng.get_state())
    assert train.main(args + ["max_iterations=1", f"checkpoint={moved}"]).epoch == 3
    assert torch.allclose(train._override_sigma(resumed, 0.5).params["log_std"], torch.log(torch.tensor(0.5)))
    # a checkpoint of another network is refused at the boundary
    train_cfg = config.load_train_config("Ant")
    train_cfg["params"]["config"].update(horizon_length=4, minibatch_size=16)
    train_cfg["params"]["network"]["mlp"]["units"] = [32, 32]
    with pytest.raises(ValueError, match="another network"):
        checkpoint.load_train_state(PPO(agent.env, train_cfg), str(path))
    for key in ("test=True", "multi_gpu=True", "pbt=pbt_default", "capture_video=True"):
        with pytest.raises(NotImplementedError, match="not ported"):
            train.main(args + [key])


def test_learner_config_and_refusals():
    cfg = config.load_train_config("Ant")
    ours, ref = PPOConfig.from_train_cfg(cfg), jax.device_get(JaxPPO(_Sizes(), cfg).cfg)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.horizon_length, ours.minibatch_size, ours.mini_epochs, ours.reward_scale) == (16, 32768, 4, 0.01)
    # a central_value_config with an env that has states builds the asymmetric critic
    env = types.SimpleNamespace(num_envs=N, num_obs=OBS, num_actions=ACT, num_states=12, device=torch.device("cpu"))
    asym = {**cfg, "params": {**cfg["params"], "config": {**cfg["params"]["config"], "central_value_config": {}}}}
    asym["params"]["config"]["central_value_config"] = {"network": {"mlp": {"units": [64]}}}
    with pytest.raises(ValueError, match="not divisible"):
        PPO(env, asym)
    asym["params"]["config"].update(horizon_length=4, minibatch_size=16)
    cv = PPO(env, asym)
    assert cv.central_value and cv.cv_mini_epochs == 4 and cv.cv_lr == 1e-4
    assert [tuple(v.shape) for v in cv.cv_network.state_dict().values()] == [(64, 12), (64,), (1, 64), (1,)]
    assert not PPO(types.SimpleNamespace(**{**vars(env), "num_states": 0}), asym).central_value
    # the learners that wait name their ROADMAP item
    lstm = {**cfg, "params": {**cfg["params"], "network": {**cfg["params"]["network"], "rnn": {"units": 64}}}}
    with pytest.raises(NotImplementedError, match="LSTM.*Queue A item 6"):
        PPO(env, lstm)
    with pytest.raises(ValueError, match="not divisible"):
        PPO(env, cfg)  # 16 x 8 envs against minibatches of 32768


@pytest.mark.parametrize("task,name", [
    ("Anymal", None), ("AnymalTerrain", None), ("ShadowHand", None), ("ShadowHand", "ShadowHandPPOAsymm"),
    ("ShadowHandOpenAI_FF", None), ("BallBalance", None), ("Quadcopter", None), ("FrankaCubeStack", None),
])
def test_learner_config_matches_jax(task, name):
    """The learner reads each train config the port ships (Ant's in
    `test_learner_config_and_refusals`) field by field as JAX's `PPO` does."""
    cfg = config.load_train_config(task, name)
    assert cfg == jax_config.load_train_config(task, name)
    ours, ref = PPOConfig.from_train_cfg(cfg), jax.device_get(JaxPPO(_Sizes(), cfg).cfg)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.normalize_value and ours.value_bootstrap and ours.lr_schedule == "adaptive"


def test_cli_trains_shadow_hand_openai_with_central_value(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["task=ShadowHandOpenAI_FF", "sim_device=cpu", "num_envs=8", "experiment=sh", "seed=4",
            "train.params.config.horizon_length=2", "train.params.config.minibatch_size=8",
            "train.params.config.mini_epochs=2", "train.params.config.central_value_config.mini_epochs=2"]
    ts = train.main(args + ["max_iterations=1"])
    assert ts.epoch == 1 and ts.last_obs.shape == (8, 42) and ts.cv.last_states.shape == (8, 211)
    path = tmp_path / "runs" / "sh" / "nn" / "sh.ckpt"
    saved = torch.load(path, weights_only=True)["state"]
    assert all(torch.equal(saved["cv"]["params"][k], v) for k, v in ts.cv.params.items())
    assert saved["cv"]["stats"]["mean"].shape == (211,) and int(saved["cv"]["opt_state"]["count"]) == 4
    rows = (tmp_path / "runs" / "sh" / "summaries" / "metrics.csv").read_text().splitlines()
    vals = {r.split(",")[1]: float(r.split(",")[2]) for r in rows}
    assert all(np.isfinite(vals[k]) for k in ("loss", "a_loss", "v_loss", "kl")) and vals["v_loss"] > 0
    resumed = train.main(args + ["max_iterations=1", f"checkpoint={path}"])
    assert resumed.epoch == 2 and int(resumed.cv.opt_state["count"]) == 8
    # a checkpoint with a central value does not load into an agent without one
    cfg = config.load_train_config("ShadowHandOpenAI_FF")
    cfg["params"]["config"].update(horizon_length=4, minibatch_size=16)
    del cfg["params"]["config"]["central_value_config"]
    plain = PPO(isaacgymenv_tpu_torch.make(task="ShadowHandOpenAI_FF", num_envs=8, device="cpu"), cfg)
    with pytest.raises(ValueError, match="central value"):
        checkpoint.load_train_state(plain, str(path))
