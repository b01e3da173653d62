"""The port's quaternion helpers (ops/maths.py) and spatial algebra
(physics/spatial.py) against the JAX package's, on numpy-seeded inputs;
a helper with several outputs is held to each.

Tolerance: fp32 elementwise formulas written the same way in both packages;
1e-5 absolute on unit-scale outputs (5e-5 for rotmat_to_quat, whose
branch-free Shepperd form divides by a square root)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from isaacgymenv_tpu.ops import maths as jm  # noqa: E402
from isaacgymenv_tpu.physics import spatial as js  # noqa: E402
from isaacgymenv_tpu_torch.ops import maths as tm  # noqa: E402
from isaacgymenv_tpu_torch.physics import spatial as ts  # noqa: E402

N = 64


def _quat(rng):
    q = rng.normal(size=(N, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _vec(rng, scale=1.0):
    return (scale * rng.normal(size=(N, 3))).astype(np.float32)


def _rotmat(rng):
    return np.array(jm.quat_to_rotmat(jnp.asarray(_quat(rng))))


def _sym6(rng):
    a = rng.normal(size=(N, 6, 6))
    return (a @ np.swapaxes(a, -1, -2) + 6 * np.eye(6)).astype(np.float32)


# name -> (args from rng, tolerance)
MATHS = {
    "normalize": (lambda r: (_vec(r),), 1e-5),
    "quat_mul": (lambda r: (_quat(r), _quat(r)), 1e-5),
    "quat_conjugate": (lambda r: (_quat(r),), 0.0),
    "quat_unit": (lambda r: ((2.0 * _quat(r)).astype(np.float32),), 1e-5),
    "quat_apply": (lambda r: (_quat(r), _vec(r)), 1e-5),
    "quat_rotate_inverse": (lambda r: (_quat(r), _vec(r)), 1e-5),
    "quat_to_rotmat": (lambda r: (_quat(r),), 1e-5),
    "rotmat_to_quat": (lambda r: (_rotmat(r),), 5e-5),
    "quat_integrate": (lambda r: (_quat(r), _vec(r, 3.0), 0.005), 1e-5),
    "quat_from_angle_axis": (lambda r: ((3.0 * r.normal(size=N)).astype(np.float32), _vec(r)), 1e-5),
    "scale": (lambda r: (_vec(r), -1.0 - r.random(3).astype(np.float32), 1.0 + r.random(3).astype(np.float32)), 1e-5),
    "unscale": (lambda r: (_vec(r), -1.0 - r.random(3).astype(np.float32), 1.0 + r.random(3).astype(np.float32)), 1e-5),
    # Ant's observation helpers (tuples of outputs)
    "normalize_angle": (lambda r: ((3.0 * r.normal(size=N)).astype(np.float32),), 1e-5),
    "get_euler_xyz": (lambda r: (_quat(r),), 1e-5),
    "compute_heading_and_up": (lambda r: (_quat(r), _quat(r), _vec(r, 5.0), _vec(r), _vec(r), 2), 1e-5),
    "compute_rot": (lambda r: (_quat(r), _vec(r), _vec(r), _vec(r, 100.0), _vec(r)), 1e-5),
}

SPATIAL = {
    "skew": lambda r: (_vec(r),),
    "mot_to_child": lambda r: (_rotmat(r), _vec(r), r.normal(size=(N, 6)).astype(np.float32)),
    "frc_to_parent": lambda r: (_rotmat(r), _vec(r), r.normal(size=(N, 6)).astype(np.float32)),
    "crm": lambda r: (r.normal(size=(N, 6)).astype(np.float32), r.normal(size=(N, 6)).astype(np.float32)),
    "crf": lambda r: (r.normal(size=(N, 6)).astype(np.float32), r.normal(size=(N, 6)).astype(np.float32)),
    "spatial_inertia": lambda r: (
        (1.0 + r.random(N)).astype(np.float32), _vec(r, 0.1),
        np.tile(np.diag([0.1, 0.2, 0.3]).astype(np.float32), (N, 1, 1)),
    ),
    "xform_frc_matrix": lambda r: (_rotmat(r), _vec(r)),
    "inertia_to_parent": lambda r: (_rotmat(r), _vec(r, 0.3), _sym6(r)),
}


def _compare(jfn, tfn, args, tol):
    want = jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = tfn(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(MATHS))
def test_maths_matches_jax(name):
    make_args, tol = MATHS[name]
    _compare(getattr(jm, name), getattr(tm, name), make_args(np.random.default_rng(7)), tol)


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_matches_jax(name):
    # 6x6 products of O(10) entries: 1e-5 relative, 1e-4 absolute
    args = SPATIAL[name](np.random.default_rng(11))
    want = np.asarray(getattr(js, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(ts, name)(*[torch.as_tensor(a) for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
