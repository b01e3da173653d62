"""The PyTorch port stands alone: no JAX import, no silent CPU fallback,
its own config copies, and the fused-substep gate and wrapper on the CPU.

No test here builds the JAX Anymal model or compiles anything."""

import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from isaacgymenv_tpu.utils import config as jax_config  # noqa: E402
from isaacgymenv_tpu_torch.physics import fused  # noqa: E402
from isaacgymenv_tpu_torch.utils import config as port_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "isaacgymenv_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import isaacgymenv_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(isaacgymenv_tpu_torch.__path__, "isaacgymenv_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15  # every module of the port imported


def test_make_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: make() with no device runs on the card")
    import isaacgymenv_tpu_torch

    with pytest.raises(RuntimeError, match="CUDA"):
        isaacgymenv_tpu_torch.make(task="Anymal", num_envs=8)


@pytest.mark.parametrize("kind,name", [
    ("task", "Anymal"), ("train", "AnymalPPO"), ("task", "ShadowHand"), ("train", "ShadowHandPPO"),
    ("task", "AnymalTerrain"), ("train", "AnymalTerrainPPO"), ("task", "Ant"), ("train", "AntPPO"),
    ("task", "ShadowHandOpenAI_LSTM"), ("task", "ShadowHandOpenAI_FF"), ("train", "ShadowHandPPOAsymm"),
    ("train", "ShadowHandOpenAI_FFPPO"), ("task", "BallBalance"), ("train", "BallBalancePPO"), ("task", "Quadcopter"),
    ("train", "QuadcopterPPO"), ("task", "FrankaCubeStack"), ("train", "FrankaCubeStackPPO"),
])
def test_cfg_copy_parses_like_the_jax_package(kind, name):
    ours = port_config.load_yaml(os.path.join(port_config.CFG_ROOT, kind, f"{name}.yaml"))
    ref = jax_config.load_yaml(os.path.join(jax_config.CFG_ROOT, kind, f"{name}.yaml"))
    assert ours == ref


@pytest.fixture(scope="module")
def anymal_cpu():
    import isaacgymenv_tpu_torch

    return isaacgymenv_tpu_torch.make(task="Anymal", num_envs=8, device="cpu")


def test_fused_gate(anymal_cpu):
    from isaacgymenv_tpu_torch.physics import engine
    from isaacgymenv_tpu_torch.physics.types import JT_FREE, JT_SCREW

    model = anymal_cpu.model
    assert (model.nb, model.nq, model.nv, model.nd, model.ng) == (13, 19, 18, 12, 143)
    assert fused.fused_structural_ok(model, 4096)
    # joints the kernel lacks, and scenes above its caps, take the plain path
    assert not fused.fused_structural_ok(model, 0)
    assert not fused.fused_structural_ok(dataclasses.replace(model, jtype=model.jtype[:-1] + (JT_SCREW,)), 4096)
    assert not fused.fused_structural_ok(dataclasses.replace(model, jtype=model.jtype[:-1] + (JT_FREE,)), 4096)
    many_geoms = dataclasses.replace(model, geom_body=model.geom_body * 2)
    assert not fused.fused_structural_ok(many_geoms, 4096)
    # features the scene's path has not are refused before the gate: B1 has no anchors
    sim = anymal_cpu.initial_state(seed=0).sim
    ctrl = engine.Control.zero(model, anymal_cpu.num_envs)
    for m, terrain, match in [(model, object(), "terrain other than"),
                              (dataclasses.replace(model, anchor_body=(1,)), None, "world anchors on B1")]:
        with pytest.raises(NotImplementedError, match=f"not ported yet: {match}"):
            engine.step(m, terrain, sim, ctrl, 0.005, 2)
    # body wrenches go to B1 (its wrench mode); a CPU state runs its plain version
    wrench = torch.zeros(anymal_cpu.num_envs, model.nb, 6)
    wrench[:, 0, 5] = 50.0
    pushed = engine.step(model, None, sim, dataclasses.replace(ctrl, body_wrench=wrench), 0.005, 2)
    lift = pushed.body_linvel[:, 0, 2] - engine.step(model, None, sim, ctrl, 0.005, 2).body_linvel[:, 0, 2]
    assert bool((lift > 0).all()), "50 N up on the base lifts it in every env"
    # force sensors go to B1 (its sensor output); a CPU state runs the plain loop
    sensed = dataclasses.replace(model, sensor_body=(1,))
    assert fused.fused_structural_ok(sensed, 4096) and engine._use_fused(sensed, sim.q) == "mono"
    out = engine.step(sensed, None, sim, ctrl, 0.005, 1)
    assert tuple(out.joint_wrench.shape) == (anymal_cpu.num_envs, 1, 6)


def test_pack_model_table(anymal_cpu):
    model = anymal_cpu.model
    table = fused.pack_model(model)
    # every field of the C struct is 4 bytes wide: no padding
    n_words = sum(getattr(t, "_length_", 1) for _, t in fused.FusedModel._fields_)
    assert ctypes.sizeof(table) == 4 * n_words
    assert list(table.parent[: model.nb]) == list(model.parent)
    assert list(table.geom_body[: model.ng]) == list(model.geom_body)
    np.testing.assert_allclose(np.asarray(table.geom_meff_el[: model.ng]), model.geom_meff_el.numpy())
    I6 = np.asarray(table.inertia[:36]).reshape(6, 6)
    np.testing.assert_allclose(I6, I6.T, atol=1e-6)
    np.testing.assert_allclose(I6[3:, 3:], float(model.body_mass[0]) * np.eye(3), rtol=1e-6)
    assert table.body_dof[0] == -1 and table.body_dof[model.dof_body[0]] == 0


def test_wrapper_runs_plain_version_on_cpu(anymal_cpu):
    env = anymal_cpu
    model, n = env.model, env.num_envs
    rng = np.random.default_rng(0)
    q = env.initial_state(seed=0).sim.q
    qd = torch.tensor(0.3 * rng.normal(size=(n, model.nv)), dtype=torch.float32)
    tgt = env.default_dof_pos.expand(n, -1)
    zero = torch.zeros_like(tgt)
    slip = torch.zeros(n, model.ng, 3)
    tables = fused.tables_for(model, "cpu")
    before = fused.fused_substep.launches
    out = fused.fused_substep(tables, q, qd, tgt, zero, zero, slip, 0.005, 2)
    ref = fused.fused_substep_plain(tables, q, qd, tgt, zero, zero, slip, 0.005, 2)
    assert fused.fused_substep.launches == before  # no kernel ran
    assert out[6] is None and ref[6] is None  # no force sensors
    for a, b in zip(out[:6], ref[:6]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_substep(tables, q.to("meta"), qd, tgt, zero, zero, slip, 0.005, 2)
