"""Depth-map extraction from a DSI: collapse, threshold, median, border.

Port of dvs_mcemvs_tpu/ops/extract.py (the reference's getDepthMapFromDSI):
confidence normalization, the adaptive Gaussian threshold, the masked Huang
median (a rank binary search up to 256 levels, a per-pixel sort above),
border removal and index-to-depth on the device; Telea inpainting (`densify_host`) on the host.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import grid as gridops
from .depth_vector import DepthVector

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DepthMapOptions:
    """Mirrors EMVS::OptionsDepthMap."""

    adaptive_threshold_kernel_size: int = 5
    adaptive_threshold_c: float = 5.0
    median_filter_size: int = 5
    full_sequence: bool = False
    save_conf_stats: bool = False
    max_confidence: float = 0.0
    rv_pos: float = 0.0
    collapse_method: int = -1  # -1 = argmax of votes; 0-4 the focus collapses


class DepthMapResult(NamedTuple):
    depth: torch.Tensor        # (H, W) float32 metric depth (semi-dense values)
    confidence: torch.Tensor   # (H, W) float32 raw vote confidence
    mask: torch.Tensor         # (H, W) uint8 semi-dense support
    depth_dense: Optional[torch.Tensor]  # inpainted dense depth (None here)
    depth_indices: torch.Tensor  # (H, W) int32 filtered depth cell indices


def normalize_confidence(confidence: torch.Tensor,
                         max_confidence: float = 0.0) -> torch.Tensor:
    """Min-max normalize to [0, 255] and round half to even (cvRound), with
    the reference's (0,0)-pixel pinning when `max_confidence > 0`."""
    conf = confidence
    # (fill_, not item assignment: assigning a number copies it from the
    # host, which a CUDA graph capture refuses)
    if max_confidence > 0:
        conf = conf.clone()
        conf[0, 0].fill_(max_confidence)
    cmin = torch.min(conf)
    cmax = torch.max(conf)
    scale = 255.0 / torch.clamp(cmax - cmin, min=1e-30)
    norm = (conf - cmin) * scale
    norm[0, 0].fill_(0.0)
    return torch.clamp(torch.round(norm), 0.0, 255.0)


def adaptive_threshold_mask(conf_u8: torch.Tensor, kernel_size: int,
                            c: float) -> torch.Tensor:
    """mask = conf > round(gaussian_mean(conf)) - round(-c), OpenCV's
    adaptiveThreshold on a u8 image (replicated border)."""
    k1 = gridops.gaussian_kernel_1d(kernel_size, sigma=-1.0)
    mean = gridops.sep_conv2d_same(conf_u8, k1, k1, border="replicate")
    mean_u8 = torch.round(mean)
    ci = float(np.round(np.float32(-c)))
    return (conf_u8 > (mean_u8 - ci)).to(torch.uint8)


def _masked_median_bsearch(img: torch.Tensor, mask: torch.Tensor,
                           patch_size: int, levels: int) -> torch.Tensor:
    """Huang's masked lower median as a data-parallel rank binary search over
    the patch_size^2 shifted neighbour planes (int16; masked-out neighbours
    get sentinel `levels`, out-of-image ones `levels+1`)."""
    H, W = img.shape
    m = mask > 0
    v = torch.clamp(img.to(torch.int32), 0, levels - 1).to(torch.int16)
    v = torch.where(m, v, torch.full_like(v, levels))
    p = patch_size // 2
    planes = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            s = torch.full((H, W), levels + 1, dtype=torch.int16, device=img.device)
            ys = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, -dx), min(W, W - dx))
            src_ys = slice(max(0, dy), min(H, H + dy))
            src_xs = slice(max(0, dx), min(W, W + dx))
            s[ys, xs] = v[src_ys, src_xs]
            planes.append(s)
    V = torch.stack(planes)
    n = torch.sum((V < levels).to(torch.int32), dim=0)
    rank = (n + 1) // 2
    lo = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    hi = torch.full((H, W), levels - 1, dtype=torch.int32, device=img.device)
    for _ in range(int(np.ceil(np.log2(max(levels, 2))))):
        mid = (lo + hi) >> 1
        cnt = torch.sum((V <= mid[None].to(torch.int16)).to(torch.int32), dim=0)
        ge = cnt >= rank
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return torch.where(n > 0, lo, torch.zeros_like(lo)).to(torch.float32)


def masked_median_filter(img_u8: torch.Tensor, mask: torch.Tensor, patch_size: int,
                         levels: Optional[int] = None) -> torch.Tensor:
    """Masked lower median over the (patch x patch) neighbourhood, as
    huangMedianFilter: only pixels with mask > 0 count, the median is the
    value of rank (n+1)/2 among the n of them, and a pixel with none gets 0.

    For integer values in [0, `levels`) with `levels` <= 256 it is a rank
    binary search (`_masked_median_bsearch`); otherwise (more levels, or
    None) every pixel's neighbours are gathered and sorted, exact for any
    float input."""
    if levels is not None and levels <= 256:
        return _masked_median_bsearch(img_u8, mask, patch_size, levels)
    H, W = img_u8.shape
    p = patch_size // 2
    m = mask > 0
    img = img_u8.to(torch.float32)
    # Out-of-image and unmasked neighbours sort to the end.
    big = 1e30
    vals = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            shifted = torch.full((H, W), big, dtype=torch.float32, device=img.device)
            ys = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, -dx), min(W, W - dx))
            src_ys = slice(max(0, dy), min(H, H + dy))
            src_xs = slice(max(0, dx), min(W, W + dx))
            shifted[ys, xs] = torch.where(m[src_ys, src_xs], img[src_ys, src_xs],
                                          torch.full_like(img[src_ys, src_xs], big))
            vals.append(shifted)
    stack = torch.stack(vals, dim=-1)                 # (H, W, p^2)
    n = torch.sum(stack < big, dim=-1)
    rank = torch.clamp((n + 1) // 2 - 1, min=0)       # 0-based lower median
    med = torch.gather(torch.sort(stack, dim=-1).values, -1, rank[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def masked_median_filter_u8(img_u8: torch.Tensor, mask: torch.Tensor, patch_size: int,
                            levels: int = 256) -> torch.Tensor:
    """`masked_median_filter` as int32."""
    return masked_median_filter(img_u8, mask, patch_size, levels=levels).to(torch.int32)


def remove_mask_boundary(mask: torch.Tensor, border_size: int) -> torch.Tensor:
    """Zero the mask where x <= b, x >= W-b, y <= b or y >= H-b."""
    H, W = mask.shape
    ys = torch.arange(H, device=mask.device)[:, None]
    xs = torch.arange(W, device=mask.device)[None, :]
    keep = (xs > border_size) & (xs < W - border_size) & \
           (ys > border_size) & (ys < H - border_size)
    return torch.where(keep, mask, torch.zeros_like(mask))


def extract_from_collapsed(confidence: torch.Tensor, depth_indices: torch.Tensor,
                           depth_vec: DepthVector,
                           options: DepthMapOptions) -> DepthMapResult:
    """Extraction chain after the Z-collapse: confidence normalization,
    adaptive threshold, masked median of the indices, border removal,
    closed-form index -> depth."""
    conf_u8 = normalize_confidence(confidence, options.max_confidence)
    mask = adaptive_threshold_mask(
        conf_u8, options.adaptive_threshold_kernel_size, options.adaptive_threshold_c)
    # Depth indices are integers in [0, Z): the rank search up to 256 planes,
    # the gather + sort above.
    filtered_idx = masked_median_filter_u8(
        depth_indices.to(torch.float32), mask, options.median_filter_size,
        levels=depth_vec.n)
    border = max(options.adaptive_threshold_kernel_size // 2, 1)
    mask = remove_mask_boundary(mask, border)
    depth = depth_vec.depth_at_index(torch.clamp(filtered_idx, 0, depth_vec.n - 1))
    return DepthMapResult(depth=depth, confidence=confidence, mask=mask,
                          depth_dense=None, depth_indices=filtered_idx)


def get_depth_map_from_dsi(dsi: torch.Tensor, depth_vec: DepthVector,
                           options: DepthMapOptions) -> DepthMapResult:
    """Collapse a (Z, H, W) DSI and run the extraction chain."""
    confidence, depth_indices = gridops.collapse(dsi, options.collapse_method)
    return extract_from_collapsed(confidence, depth_indices, depth_vec, options)


def densify_host(result: DepthMapResult, depth_vec: DepthVector) -> np.ndarray:
    """Telea inpainting of the filtered depth indices on the host (OpenCV),
    off the hot path; returns dense metric depth as a host array.

    Up to 256 planes the indices are inpainted as uint8, as the reference
    does; above, as float32 rounded back to indices.  Without OpenCV the
    indices are used as they are (no inpainting), with a warning.
    """
    idx_raw = result.depth_indices.cpu().numpy()
    mask = result.mask.cpu().numpy().astype(np.uint8)
    depths = depth_vec.depths()
    n_planes = len(depths)
    try:
        import cv2
    except ImportError:
        log.warning("OpenCV is not installed: the dense depth map is not inpainted")
        return depths[np.clip(idx_raw, 0, n_planes - 1)]
    inpaint_mask = (1 - mask).astype(np.uint8)
    if n_planes <= 256:
        inpainted = cv2.inpaint(idx_raw.astype(np.uint8), inpaint_mask, 3,
                                cv2.INPAINT_TELEA)
    else:
        inpainted = np.rint(cv2.inpaint(idx_raw.astype(np.float32),
                                        inpaint_mask, 3, cv2.INPAINT_TELEA))
    return depths[np.clip(inpainted.astype(np.int64), 0, n_planes - 1)]


def confidence_range_stats(confidence: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min and max over the nonzero confidences (the save_conf_stats probe)."""
    nz = confidence > 0
    big = torch.amax(confidence)
    cmin = torch.amin(torch.where(nz, confidence, big))
    cmax = torch.amax(torch.where(nz, confidence, torch.zeros_like(confidence)))
    return cmin, cmax
