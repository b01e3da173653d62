"""The JAX package's XLA path as the port's CPU tests run it: compiled at
XLA backend optimization level 0, the physics compiled once per model.

`substep_chain` compiles one substep of `engine.step` with dt an argument
and chains it: the XLA path scans that substep `substeps` times at
dt / substeps, carrying the slip, and each call's final `forward` refreshes
only the body caches, which the next substep does not read (bitwise the
scanned step on the CPU).  `env_step` compiles a function of a JAX env's
step with that chain in the place of `engine.step`, through a host
callback, so the env step's program holds the task logic and no second
copy of the physics.
"""

import jax

from isaacgymenv_tpu.physics import engine as jax_engine


def compiled(fn, *args):
    """fn jitted and compiled for args at XLA backend optimization level 0:
    it halves the reference's compile time on the CPU and leaves its fp32
    arithmetic to the same XLA program."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def substep_chain(model, terrain, state, ctrl):
    """run(state, ctrl, dt, substeps): `engine.step(model, terrain, state,
    ctrl, dt, substeps)` as `substeps` compiled one-substep steps; `state`
    and `ctrl` give the shapes to compile for."""
    one = compiled(lambda s, c, h: jax_engine.step(model, terrain, s, c, h, 1), state, ctrl, 0.0)

    def run(s, c, dt, substeps):
        for _ in range(substeps):
            s = one(s, c, dt / substeps)
        return s

    return run


def env_step(fn, run, *args):
    """`fn(*args)` compiled with every `engine.step(model, terrain, state,
    ctrl, dt, substeps)` inside it computed by `run` (a `substep_chain`) in
    a host callback."""
    def step(model, terrain, state, ctrl, dt, substeps=2):
        shapes = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        return jax.pure_callback(lambda s, c: run(s, c, dt, substeps), shapes, state, ctrl)

    original, jax_engine.step = jax_engine.step, step
    try:
        return compiled(fn, *args)
    finally:
        jax_engine.step = original
