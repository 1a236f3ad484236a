"""DSI voxel-grid operations: fusion, Z-collapse, statistics, filtering.

Port of dvs_mcemvs_tpu/ops/grid.py: the two-grid fusions and the
temporal-fusion accumulators, the argmax / argmin collapses, the five
focus-measure collapses with their 2D filters, the local-focus harmonic
mean, the grid statistics and the 3D filters (Laplacian, diffusion,
separable Gaussian, Moran's I).  A DSI is a (Z, H, W) float32 tensor; the
two-grid fusion ops keep the reference's epsilon semantics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Fusion-method enum values of the `stereo_fusion` flag.
FUSE_MIN = 1
FUSE_HM = 2
FUSE_GM = 3
FUSE_AM = 4
FUSE_RMS = 5
FUSE_MAX = 6

FUSION_NAMES = {
    FUSE_MIN: "min",
    FUSE_HM: "harmonic_mean",
    FUSE_GM: "geometric_mean",
    FUSE_AM: "arithmetic_mean",
    FUSE_RMS: "rms",
    FUSE_MAX: "max",
}


def fuse_add(g1, g2):
    return g1 + g2


def fuse_subtract(g1, g2):
    return g1 - g2


def fuse_ratio(g1, g2, eps=1e-1):
    return g1 / (torch.abs(g2) + eps)


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


def fuse_quadratic_mean(g1, g2):
    """The root mean square, as `fuse_rms`."""
    return fuse_rms(g1, g2)


def fuse_cubic_mean(g1, g2):
    """Real cube root of the mean cube; a negative mean keeps its sign, as
    jnp.cbrt does (a fractional power of it would be NaN)."""
    m = 0.5 * (g1 ** 3 + g2 ** 3)
    return torch.sign(m) * torch.abs(m) ** (1.0 / 3.0)


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


def collapse_min(dsi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(minimum, depth_index int32) per pixel; ties go to the lowest index."""
    return torch.amin(dsi, dim=0), torch.argmin(dsi, dim=0).to(torch.int32)


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


def add_inverse(acc, g, eps=1e-2):
    """acc + 1/(eps + g), out of place."""
    return acc + inverse(g, eps)


def add_inverse_(acc, g, eps=1e-2):
    """acc += 1/(eps + g): the HM running accumulator."""
    return acc.add_(inverse(g, eps))


def hm_from_sum_of_inv(acc, n: int):
    return float(n) / acc


def am_from_sum(acc, n: int):
    return acc / float(n)


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


_PAD_TABLES: Dict[tuple, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}


def _pad_tables(n: int, before: int, after: int, border: str,
                device: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`_pad_index` on `device`: the gather index (sources of the zero pad
    at 0) and, where the pad has zeros, the mask of kept positions.  Made
    once per key and kept, so a call reads no host array: the first call
    on a device (a program's eager warm-up) builds them outside any
    capture."""
    key = (n, before, after, border, device)
    tables = _PAD_TABLES.get(key)
    if tables is None:
        idx = _pad_index(n, before, after, border)
        keep = torch.as_tensor(idx >= 0, device=device) if (idx < 0).any() else None
        tables = _PAD_TABLES[key] = (torch.as_tensor(np.maximum(idx, 0), device=device), keep)
    return tables


def _pad2d(img: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int],
           border: str) -> torch.Tensor:
    H, W = img.shape[-2:]
    out = img
    for dim, n, (b, a) in ((-2, H, ph), (-1, W, pw)):
        sel, keep = _pad_tables(n, b, a, border, img.device)
        out = torch.index_select(out, dim, sel)
        if keep is not None:
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


def gaussian_ksize_from_sigma(sigma: float, depth_is_8u: bool = False) -> int:
    """cv::GaussianBlur(Size(0,0), sigma) kernel-size rule."""
    factor = 3 if depth_is_8u else 4
    k = int(round(sigma * factor * 2 + 1)) | 1
    return max(k, 1)


def gaussian_blur(img: torch.Tensor, sigma: float, border: str = "reflect") -> torch.Tensor:
    """cv::GaussianBlur(src, dst, Size(0,0), sigma) on float32 images."""
    k = gaussian_kernel_1d(gaussian_ksize_from_sigma(sigma), sigma)
    return sep_conv2d_same(img, k, k, border)


_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)
# getDerivKernels(2, 0, ksize=5): second derivative and smoothing taps.
_DERIV2_5 = np.array([1.0, 0.0, -2.0, 0.0, 1.0], dtype=np.float32)
_SMOOTH_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32)


def sobel_grad_mag_sq(img: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    """grad_x^2 + grad_y^2 with cv::Sobel 3x3 kernels (BORDER_DEFAULT)."""
    gx = sep_conv2d_same(img, _SOBEL_D, _SOBEL_S, border)
    gy = sep_conv2d_same(img, _SOBEL_S, _SOBEL_D, border)
    return gx * gx + gy * gy


def laplacian5(img: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    """cv::Laplacian(..., ksize=5): d2x (x) smooth_y + smooth_x (x) d2y."""
    a = sep_conv2d_same(img, _DERIV2_5, _SMOOTH_5, border)
    b = sep_conv2d_same(img, _SMOOTH_5, _DERIV2_5, border)
    return a + b


def box_mean(img: torch.Tensor, half: int) -> torch.Tensor:
    """Plain (2*half+1)^2 patch mean, zero outside the image."""
    size = 2 * half + 1
    return conv2d_same(img, np.full((size, size), 1.0 / (size * size), np.float32),
                       border="zero")


# Focus-measure collapses (src/cartesian3dgrid.cpp:192-414): a focus image a
# plane, then the per-pixel maximum over depth.  A pixel where no plane's
# focus beats 0 keeps (conf 0, index 0), the reference's zero-initialised
# best.


def _collapse_by_focus(focus: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    conf, idx = collapse_max(focus)
    return conf, torch.where(conf > 0, idx, torch.zeros_like(idx))


def collapse_by_grad_mag(dsi: torch.Tensor, half_patchsize: int = 2):
    """Sobel gradient-magnitude focus, patch-averaged (cpp:192-240); pixels
    within `half_patchsize` of the border have zero focus, as the reference
    updates only the interior."""
    focus = box_mean(sobel_grad_mag_sq(dsi), half_patchsize)
    _, H, W = dsi.shape
    ys = torch.arange(H, device=dsi.device)[:, None]
    xs = torch.arange(W, device=dsi.device)[None, :]
    interior = ((ys >= half_patchsize) & (ys < H - half_patchsize)
                & (xs >= half_patchsize) & (xs < W - half_patchsize))
    conf, idx = _collapse_by_focus(torch.where(interior[None], focus, torch.zeros_like(focus)))
    return torch.sqrt(conf), idx


def collapse_by_laplacian(dsi: torch.Tensor):
    """Squared 5-tap Laplacian focus (cpp:243-281)."""
    hf = laplacian5(dsi)
    conf, idx = _collapse_by_focus(hf * hf)
    return torch.sqrt(conf), idx


def collapse_by_dog(dsi: torch.Tensor, sigma: float = 0.5, sigma2_ratio: float = 1.6):
    """|DoG| focus with sigma and 1.6 sigma Gaussians (cpp:284-327)."""
    return _collapse_by_focus(torch.abs(gaussian_blur(dsi, sigma)
                                        - gaussian_blur(dsi, sigma * sigma2_ratio)))


def _local_mean_square(dsi: torch.Tensor, sigma: float) -> torch.Tensor:
    return gaussian_blur(dsi * dsi, sigma)


def _local_variance(dsi: torch.Tensor, sigma: float) -> torch.Tensor:
    m = gaussian_blur(dsi, sigma)
    return torch.clamp(_local_mean_square(dsi, sigma) - m * m, min=0.0)


def collapse_by_local_var(dsi: torch.Tensor, sigma: float = 0.5):
    """Gaussian local variance focus (cpp:330-372)."""
    return _collapse_by_focus(_local_variance(dsi, sigma))


def collapse_by_local_mean_square(dsi: torch.Tensor, sigma: float = 0.5):
    """Gaussian local mean-square focus (cpp:375-414)."""
    return _collapse_by_focus(_local_mean_square(dsi, sigma))


def local_focus_in_place(dsi: torch.Tensor, focus_method: int = 0, sigma: float = 0.5):
    """computeLocalFocusInPlace (cpp:417-483): the per-plane focus
    transform, 1 = local mean square, any other value local std-dev."""
    if focus_method == 1:
        return _local_mean_square(dsi, sigma)
    return torch.sqrt(_local_variance(dsi, sigma))


def fuse_harmonic_mean_of_local_focus(g1, g2, focus_method: int = 0,
                                      sigma: float = 0.5, eps: float = 1e-1):
    """HM of the local focus transforms of two DSIs
    (fuseDSIs_HarmonicMeanOfLocalFocus, utils.cpp:155-181)."""
    return fuse_harmonic_mean(local_focus_in_place(g1, focus_method, sigma),
                              local_focus_in_place(g2, focus_method, sigma), eps)


_COLLAPSES = {0: collapse_by_local_var, 1: collapse_by_local_mean_square,
              2: collapse_by_grad_mag, 3: collapse_by_laplacian, 4: collapse_by_dog}


def collapse(dsi: torch.Tensor, method: int = -1):
    """Z-collapse by `collapse_method`, getDepthMapFromDSI's switch
    (src/mapper_emvs_stereo.cpp:348-370): 0 local variance, 1 local mean
    square, 2 gradient magnitude, 3 Laplacian, 4 difference of Gaussians;
    any other value the argmax of votes."""
    return _COLLAPSES.get(method, collapse_max)(dsi)


# Statistics (src/cartesian3dgrid.cpp:164-188).


def mean_square(dsi: torch.Tensor) -> torch.Tensor:
    """Mean of the squares, squared in float32."""
    return torch.mean(dsi.to(torch.float32) ** 2)


def min_max(dsi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.amin(dsi), torch.amax(dsi)


def mean_std(dsi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid mean and population standard deviation (computeMeanStd)."""
    m = torch.mean(dsi)
    return m, torch.sqrt(torch.mean((dsi - m) ** 2))


# 3D filters: the reference ships them but leaves them out of its build
# (cartesian3dgrid_filter.cpp, gaussianiir3d.cpp).


def laplacian3d(dsi: torch.Tensor) -> torch.Tensor:
    """6-neighbour 3D Laplacian with homogeneous Neumann boundaries
    (filter.cpp:72-110): edge-replicate padding on all three axes."""
    pad = torch.nn.functional.pad(dsi[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    out = -6.0 * dsi
    out = out + pad[:-2, 1:-1, 1:-1] + pad[2:, 1:-1, 1:-1]
    out = out + pad[1:-1, :-2, 1:-1] + pad[1:-1, 2:, 1:-1]
    out = out + pad[1:-1, 1:-1, :-2] + pad[1:-1, 1:-1, 2:]
    return out


def diffuse(dsi: torch.Tensor, sigma: float) -> torch.Tensor:
    """Heat-equation smoothing to Gaussian scale `sigma` (filter.cpp:19-69):
    explicit Euler steps g += dt * laplacian3d(g) with the reference's step
    rule dt = min(1/24, t_final/2), t_final = sigma^2/2; sigma 0 takes no
    step."""
    dt_cfl = 1.0 / 12.0
    t_final = 0.5 * sigma * sigma
    dt = min(0.5 * dt_cfl, 0.5 * t_final)
    steps = int(np.ceil(t_final / dt)) if t_final > 0 else 0
    g = dsi
    for _ in range(steps):
        g = g + dt * laplacian3d(g)
    return g


def gaussian_blur_3d(dsi: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable 3D Gaussian along (Z, H, W): each axis in turn is moved
    last and filtered by `conv2d_same` with replicated borders."""
    k = gaussian_kernel_1d(gaussian_ksize_from_sigma(sigma), sigma)[None, :]
    out = dsi
    for axis in range(3):
        moved = torch.movedim(out, axis, -1)
        shape = moved.shape
        conv = conv2d_same(moved.reshape(-1, 1, shape[-1]), k, border="replicate")
        out = torch.movedim(conv[:, 0, :].reshape(shape), -1, axis)
    return out


def moran_index_gaussian_weights(dsi: torch.Tensor, sigma: float) -> torch.Tensor:
    """Moran's I of the grid under a Gaussian neighbour-weight kernel
    (filter.cpp:113-199): I = sum(z (blur(z) - w0 z)) / ((1 - w0)(N - 1))
    for the standardised grid z, with w0 the 3D kernel's centre tap (the
    cube of the 1D kernel's).  sigma is clamped at 0.2.  An exact separable
    FIR Gaussian stands in for the reference's IIR one, as in the JAX
    package."""
    sigma = max(float(sigma), 0.2)
    m, sd = mean_std(dsi)
    z = (dsi - m) / torch.clamp(sd, min=1e-30)
    z_smooth = gaussian_blur_3d(z, sigma)
    k1 = gaussian_kernel_1d(gaussian_ksize_from_sigma(sigma), sigma)
    w0 = float(k1[len(k1) // 2]) ** 3
    numer = torch.sum(z * (z_smooth - w0 * z))
    denom = (1.0 - w0) * (dsi.numel() - 1.0)
    return numer / (denom + 1e-6)
