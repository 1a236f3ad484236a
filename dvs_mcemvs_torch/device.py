"""Device choice and the fp32 matmul policy, in one place.

Geometry runs in full fp32: the JAX reference multiplies its homographies at
`Precision.HIGHEST` because bf16 products cut golden within1 from 0.80 to
0.62 (dvs_mcemvs_tpu/ops/voting.py:127-131).  TF32 keeps ~3 decimal digits,
so it is switched off for matmuls and cuDNN alike.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required and none is available")
    return torch.device("cuda", 0)
