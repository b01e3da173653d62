"""The JAX package's XLA path as the port's CPU tests run it: compiled at
XLA backend optimization level 0, the physics compiled once per model.

`substep_chain` compiles one substep of the XLA path (`engine._substep`,
under `engine.step`'s fp32 matmul scope) with its size an argument, and
`engine.forward`, and chains them as `engine.step` runs them on the CPU:
`substeps` substeps of dt / substeps carrying the slip, then one refresh of
the body caches.  `env_step` compiles a function of a JAX env's step with
that chain in the place of `engine.step` and the compiled `forward` in the
place of `engine.forward`, both through host callbacks, so the env step's
program holds the task logic and no second copy of the physics.
"""

import jax

from isaacgymenv_tpu.ops import maths as jax_maths
from isaacgymenv_tpu.physics import engine as jax_engine


# XLA:CPU options of every program the port's tests compile: backend
# optimization level 0 halves the compile time and leaves the fp32
# arithmetic to the same XLA program; the loop emitters instead of the fusion
# emitters take about a third less CPU time to compile for the same results
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def compiled(fn, *args):
    """fn jitted and compiled for args with COMPILE_OPTIONS."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE_OPTIONS)


def substep_chain(model, terrain, state, ctrl):
    """run(state, ctrl, dt, substeps): `engine.step(model, terrain, state,
    ctrl, dt, substeps)` as `substeps` compiled substeps and one compiled
    `forward`; `state` and `ctrl` give the shapes to compile for.
    `run.forward(state)` is that compiled `engine.forward` of the model."""
    substep = jax_maths.f32_matmul(jax_engine._substep)
    one = compiled(lambda s, c, h: substep(model, terrain, s, c, h), state, ctrl, 0.0)
    forward = compiled(lambda s: jax_engine.forward(model, terrain, s), state)

    def run(s, c, dt, substeps):
        for _ in range(substeps):
            s = one(s, c, dt / substeps)
        return forward(s)

    run.model, run.forward = model, forward
    return run


def env_step(fn, run, *args):
    """`fn(*args)` compiled with every `engine.step(model, terrain, state,
    ctrl, dt, substeps)` inside it computed by `run` (a `substep_chain`) and
    every `engine.forward(model, terrain, state)` by `run.forward`, in host
    callbacks."""
    shapes_of = lambda tree: jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)  # noqa: E731

    def step(model, terrain, state, ctrl, dt, substeps=2):
        assert model is run.model, "the env steps another model than the chain's"
        return jax.pure_callback(lambda s, c: run(s, c, dt, substeps), shapes_of(state), state, ctrl)

    def forward(model, terrain, state):
        assert model is run.model, "the env refreshes another model than the chain's"
        return jax.pure_callback(run.forward, shapes_of(state), state)

    originals = jax_engine.step, jax_engine.forward
    jax_engine.step, jax_engine.forward = step, forward
    try:
        return compiled(fn, *args)
    finally:
        jax_engine.step, jax_engine.forward = originals
