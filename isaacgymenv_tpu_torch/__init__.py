"""isaacgymenv_tpu_torch: the PyTorch + CUDA port of isaacgymenv_tpu.

The port runs on an NVIDIA GPU (H100, sm_90a).  Plain tensor code is
PyTorch; the physics substep loop is a hand-written CUDA kernel
(csrc/fused_substep.cu) with a plain PyTorch version beside it, which runs
when the state lies on the CPU.  The JAX package stays the reference that
the tests hold this package against.  Nothing here imports JAX.
"""

__version__ = "0.1.0"

from isaacgymenv_tpu_torch.api import make  # noqa: F401
