"""Depth-plane sampling: linear or inverse-depth spacing.

Port of dvs_mcemvs_tpu/ops/depth_vector.py.  Formulas match the reference,
including its use of N (not N-1) in the spacing multiplier:
  linear :  d_i = min + i * (max - min) / N
  inverse:  1/d_i = 1/max + i * (1/min - 1/max) / N
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LINEAR = "linear"
INVERSE = "inverse"


@dataclasses.dataclass(frozen=True)
class DepthVector:
    kind: str
    min_depth: float
    max_depth: float
    n: int

    def __post_init__(self):
        if self.kind not in (LINEAR, INVERSE):
            raise ValueError(f"depth sampling must be {LINEAR!r} or {INVERSE!r}")
        if not (self.min_depth > 0 and self.max_depth > 0 and self.n >= 1):
            raise ValueError("depths must be positive and n >= 1")
        if self.min_depth > self.max_depth:
            lo, hi = self.max_depth, self.min_depth
            object.__setattr__(self, "min_depth", lo)
            object.__setattr__(self, "max_depth", hi)

    @property
    def _mult(self) -> float:
        if self.kind == LINEAR:
            return self.n / (self.max_depth - self.min_depth)
        return self.n / (1.0 / self.min_depth - 1.0 / self.max_depth)

    def depths(self) -> np.ndarray:
        """All plane depths, shape (n,), float32 (built in f64, then cast)."""
        i = np.arange(self.n, dtype=np.float64)
        if self.kind == LINEAR:
            return (self.min_depth + i / self._mult).astype(np.float32)
        return (1.0 / (1.0 / self.max_depth + i / self._mult)).astype(np.float32)

    def cell_index_to_depth(self, i) -> torch.Tensor:
        """Depths of integer cell indices, gathered from the `depths()`
        table (on the device of `i` when it is a tensor)."""
        i = torch.as_tensor(i)
        return torch.as_tensor(self.depths(), device=i.device)[i.long()]

    def depth_at_index(self, i: torch.Tensor) -> torch.Tensor:
        """Closed-form depths for an integer index tensor, in float32 (within
        1 ulp of the `depths()` table)."""
        i = i.to(torch.float32)
        step = float(np.float32(1.0 / self._mult))
        if self.kind == LINEAR:
            return i * step + float(np.float32(self.min_depth))
        return 1.0 / (i * step + float(np.float32(1.0 / self.max_depth)))

    def depth_to_cell(self, depth: torch.Tensor) -> torch.Tensor:
        """Fractional cell coordinate of `depth`."""
        if self.kind == LINEAR:
            return (depth - self.min_depth) * self._mult
        return (1.0 / depth - 1.0 / self.max_depth) * self._mult

    def depth_to_cell_index(self, depth: torch.Tensor) -> torch.Tensor:
        """Nearest cell index, int32: floor(cell + 0.5) rounds halves up, as
        the reference's +0.5 cast (torch.round would round them to even)."""
        return torch.floor(self.depth_to_cell(depth) + 0.5).to(torch.int32)
