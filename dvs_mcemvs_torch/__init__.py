"""PyTorch + CUDA port of the event-camera multi-view stereo pipeline.

Mirrors the layout of `dvs_mcemvs_tpu` module for module; the JAX package is
the reference each part is tested against.  Plain tensor code is PyTorch;
the voting kernels are hand-written CUDA C++ for Hopper (`csrc/`), each with
a plain PyTorch version beside it (`kernels/`).  Nothing here imports JAX.
"""

from . import device  # noqa: F401  (sets the fp32 matmul policy once)
