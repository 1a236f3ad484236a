"""Depth map -> point cloud, with radius outlier removal.

Port of dvs_mcemvs_tpu/ops/pointcloud.py (the reference's getPointcloud).
Unprojection runs on the host in numpy, as the JAX package's does, so both
packages write the same clouds.  Outlier removal has two backends:
  - 'kdtree': exact PCL-equivalent RadiusOutlierRemoval through scipy's
    cKDTree on the host (post-processing, off the hot path);
  - 'voxel': an approximate filter in PyTorch that counts neighbours over
    the 27 cells of a voxel grid (cell = radius), on the card unless the
    caller passes device="cpu".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import require_cuda
from .camera import PinholeCamera


class PointCloud(NamedTuple):
    xyz: np.ndarray        # (N, 3) float32
    intensity: np.ndarray  # (N,) float32 = 1/z


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def depth_map_to_pointcloud(depth, mask, vcam: PinholeCamera) -> PointCloud:
    """Unproject the masked pixels through the virtual camera:
    xyz = ((x - cx) / fx * d, (y - cy) / fy * d, d).  `depth` and `mask`
    may be tensors on any device or host arrays."""
    ys, xs = np.nonzero(_host(mask) > 0)
    d = _host(depth)[ys, xs]
    bx = (xs - vcam.cx) / vcam.fx
    by = (ys - vcam.cy) / vcam.fy
    xyz = np.stack([bx * d, by * d, d], axis=-1)
    return PointCloud(xyz=xyz.astype(np.float32), intensity=(1.0 / d).astype(np.float32))


def radius_outlier_removal(pc: PointCloud, radius: float, min_neighbors: int,
                           backend: str = "kdtree", device=None) -> PointCloud:
    """pcl::RadiusOutlierRemoval: keep the points with at least
    `min_neighbors` OTHER points within `radius`.  `device` places the voxel
    backend's tensors (the card when None)."""
    if pc.xyz.shape[0] == 0:
        return pc
    if backend == "kdtree":
        keep = _ror_kdtree(pc.xyz, radius, min_neighbors)
    elif backend == "voxel":
        dev = require_cuda() if device is None else torch.device(device)
        keep = _ror_voxel(torch.as_tensor(pc.xyz, device=dev), radius,
                          min_neighbors).cpu().numpy()
    else:
        raise ValueError(f"unknown ROR backend {backend}")
    return PointCloud(pc.xyz[keep], pc.intensity[keep])


def _ror_kdtree(xyz: np.ndarray, radius: float, min_neighbors: int) -> np.ndarray:
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    counts = tree.query_ball_point(xyz, r=radius, return_length=True)
    # PCL counts neighbours excluding the query point itself.
    return (counts - 1) >= min_neighbors


def _ror_voxel(xyz: torch.Tensor, radius: float, min_neighbors: int) -> torch.Tensor:
    """Approximate ROR: neighbour count over the 27 adjacent voxels of a
    grid with cell size = radius.  It overcounts distant-corner neighbours
    (an upper bound), so it keeps a little more than the exact filter."""
    n = xyz.shape[0]
    cell = torch.floor(xyz / radius).to(torch.int64)
    cell = cell - torch.amin(cell, dim=0)
    dims = torch.amax(cell, dim=0) + 3
    d1, d2 = int(dims[1]), int(dims[2])
    key = (cell[:, 0] + 1) * d1 * d2 + (cell[:, 1] + 1) * d2 + (cell[:, 2] + 1)
    size = int(dims[0]) * d1 * d2
    counts = torch.zeros(size, dtype=torch.int32, device=xyz.device)
    counts.index_add_(0, key, torch.ones(n, dtype=torch.int32, device=xyz.device))
    total = torch.zeros(n, dtype=torch.int32, device=xyz.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nk = key + dx * d1 * d2 + dy * d2 + dz
                total = total + counts[torch.clamp(nk, 0, size - 1)]
    return (total - 1) >= min_neighbors


def save_pcd(path: str, pc: PointCloud) -> None:
    """ASCII PCD writer (pcl::savePCDFileASCII)."""
    n = pc.xyz.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for (x, y, z), i in zip(pc.xyz, pc.intensity):
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {i:.6f}\n")
