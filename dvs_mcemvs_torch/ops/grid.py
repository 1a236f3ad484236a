"""DSI voxel-grid operations: fusion, Z-collapse and 2D filtering.

Port of the parts of dvs_mcemvs_tpu/ops/grid.py that process_1, process_2
and process_5 run.  A DSI is a (Z, H, W) float32 tensor; the two-grid
fusion ops keep the reference's epsilon semantics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# Fusion-method enum values of the `stereo_fusion` flag.
FUSE_MIN = 1
FUSE_HM = 2
FUSE_GM = 3
FUSE_AM = 4
FUSE_RMS = 5
FUSE_MAX = 6


def fuse_min(g1, g2):
    return torch.minimum(g1, g2)


def fuse_max(g1, g2):
    return torch.maximum(g1, g2)


def fuse_harmonic_mean(g1, g2, eps=1e-1):
    """2 g1 g2 / (g1 + g2 + eps)."""
    return 2.0 * g1 * g2 / (g1 + g2 + eps)


def fuse_harmonic_mean_nary(g1, g2, n, eps=1e-1):
    """Recursive n-ary HM step: g1 is the HM of (n-1) grids, g2 the n-th;
    a = g1/(n-1), out = n*a*g2 / (a + g2 + eps)."""
    a = g1 / float(n - 1)
    return float(n) * a * g2 / (a + g2 + eps)


def fuse_geometric_mean(g1, g2):
    return torch.sqrt(g1 * g2)


def fuse_arithmetic_mean(g1, g2):
    return 0.5 * (g1 + g2)


def fuse_rms(g1, g2):
    return torch.sqrt(0.5 * (g1 * g1 + g2 * g2))


_PAIR_FUSIONS = {
    FUSE_MIN: fuse_min,
    FUSE_HM: fuse_harmonic_mean,
    FUSE_GM: fuse_geometric_mean,
    FUSE_AM: fuse_arithmetic_mean,
    FUSE_RMS: fuse_rms,
    FUSE_MAX: fuse_max,
}


def fuse_pair(g1, g2, method: int):
    """Dispatch on the `stereo_fusion` enum."""
    if method not in _PAIR_FUSIONS:
        raise ValueError(f"unknown fusion method {method}")
    return _PAIR_FUSIONS[method](g1, g2)


def fuse_many(grids: Sequence[torch.Tensor], method: int) -> torch.Tensor:
    """Fuse >= 1 grids: plain reduction for min/max, the reference's
    recursive n-ary chain for HM, and the true n-ary mean for GM/AM/RMS."""
    grids = list(grids)
    n = len(grids)
    if n == 1:
        return grids[0]
    if method in (FUSE_MIN, FUSE_MAX):
        out = grids[0]
        for g in grids[1:]:
            out = fuse_pair(out, g, method)
        return out
    if method == FUSE_HM:
        out = fuse_harmonic_mean(grids[0], grids[1])
        for k in range(2, n):
            out = fuse_harmonic_mean_nary(out, grids[k], k + 1)
        return out
    stack = torch.stack(grids, dim=0)
    if method == FUSE_AM:
        return torch.mean(stack, dim=0)
    if method == FUSE_GM:
        return torch.exp(torch.mean(torch.log(torch.clamp(stack, min=1e-30)), dim=0))
    if method == FUSE_RMS:
        return torch.sqrt(torch.mean(stack * stack, dim=0))
    raise ValueError(f"unknown fusion method {method}")


def collapse_max(dsi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(confidence, depth_index int32) per pixel; ties go to the lowest
    index, as std::max_element (torch.argmax returns the first maximum)."""
    return torch.amax(dsi, dim=0), torch.argmax(dsi, dim=0).to(torch.int32)


# Streaming accumulators of temporal fusion (process_2/5): the harmonic mean
# sums inverses, the arithmetic mean sums values; each is normalised once by
# the count of sub-intervals that voted.  The sums run in place, with the
# JAX package's f32 arithmetic and order.


def fuse_add_(acc, g):
    """acc += g: the AM running accumulator."""
    return acc.add_(g)


def inverse(g, eps=1e-2):
    """1/(eps + g): one sub-interval's term of the HM accumulator."""
    return 1.0 / (eps + g)


def add_inverse_(acc, g, eps=1e-2):
    """acc += 1/(eps + g): the HM running accumulator."""
    return acc.add_(inverse(g, eps))


def hm_from_sum_of_inv(acc, n: int):
    return float(n) / acc


def am_from_sum(acc, n: int):
    return acc / float(n)


def collapse(dsi: torch.Tensor, method: int = -1):
    """Z-collapse by `collapse_method`; only -1 (argmax of votes) is ported."""
    if method != -1:
        raise ValueError(f"collapse method {method} is not ported (only -1; the focus "
                         "collapses 0-4 are ROADMAP Queue 1 item 2)")
    return collapse_max(dsi)


def _pad_index(n: int, before: int, after: int, border: str) -> np.ndarray:
    """Source index of every position of an axis padded by (before, after);
    -1 marks a zero pad."""
    i = np.arange(-before, n + after)
    if border == "replicate":
        return np.clip(i, 0, n - 1)
    if border == "reflect":       # cv BORDER_REFLECT: edge pixel duplicated
        period = 2 * n
        i = np.mod(i, period)
        return np.where(i < n, i, period - 1 - i)
    if border == "reflect101":    # cv BORDER_DEFAULT
        period = 2 * n - 2 if n > 1 else 1
        i = np.mod(i, period)
        return np.where(i < n, i, period - i)
    if border == "zero":
        return np.where((i >= 0) & (i < n), i, -1)
    raise ValueError(f"unknown border {border!r}")


def _pad2d(img: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int],
           border: str) -> torch.Tensor:
    H, W = img.shape[-2:]
    out = img
    for dim, n, (b, a) in ((-2, H, ph), (-1, W, pw)):
        idx = _pad_index(n, b, a, border)
        sel = torch.as_tensor(np.maximum(idx, 0), device=img.device)
        out = torch.index_select(out, dim, sel)
        if (idx < 0).any():
            keep = torch.as_tensor(idx >= 0, device=img.device)
            shape = [1] * out.ndim
            shape[dim] = -1
            out = out * keep.reshape(shape).to(out.dtype)
    return out


def conv2d_same(img: torch.Tensor, kernel, border: str = "reflect") -> torch.Tensor:
    """2D correlation with `same` output on (..., H, W), as a weighted sum of
    shifted slices in the JAX package's loop order (exact in f32).

    border: 'reflect' = cv BORDER_REFLECT, 'reflect101' = cv BORDER_DEFAULT,
    'replicate', 'zero'.
    """
    kconst = np.asarray(kernel, dtype=np.float64)
    kh, kw = kconst.shape
    ph, pw = kh // 2, kw // 2
    H, W = img.shape[-2:]
    x = _pad2d(img, (ph, kh - 1 - ph), (pw, kw - 1 - pw), border)
    out = None
    for i in range(kh):
        for j in range(kw):
            w = float(kconst[i, j])
            if w == 0.0:
                continue
            sl = x[..., i:i + H, j:j + W]
            term = sl if w == 1.0 else w * sl
            out = term if out is None else out + term
    if out is None:
        return torch.zeros_like(img)
    return out


def sep_conv2d_same(img: torch.Tensor, kx, ky, border: str = "reflect") -> torch.Tensor:
    """Separable correlation (rows by kx, columns by ky) as one dense
    outer-product kernel through `conv2d_same`, as the JAX package does."""
    kxc = np.asarray(kx, dtype=np.float64)
    kyc = np.asarray(ky, dtype=np.float64)
    return conv2d_same(img, np.outer(kyc, kxc).astype(np.float32), border)


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for CV_32F/CV_64F inputs."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64)
    x = i - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)
