"""The comparison that decides `correct`.

What the timed path produced for each judged chunk is held, end to end and
at the vote's own resolution, to the plain reference (`reference/emvs.py`)
worked out from the raw inputs:

  - `dsi_l1`: each camera's DSI (process_1) or each camera's mean over the
    sub-intervals (process_2) against the exact vote's, voxel by voxel,
    relative L1;
  - `fused_l1`: each DSI the program extracted (process_1: the cameras'
    fusion; process_2: the mean of the sub-intervals' fusions and the
    fusion of the cameras' means, `camera_time`) against the reference's,
    voxel by voxel, relative L1;
  - `maps_off`: each depth map on the host against the reference's maps of
    its own DSIs: the share of the pixels masked on either side whose mask
    differs or, masked on both, whose depth plane differs.

Each number is the worst over the judged chunks and their cameras or maps.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch


def rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b|_1 / |b|_1, in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.abs(a - b).sum() / torch.clamp(torch.abs(b).sum(), min=1e-300))


def _plane_index(depth: np.ndarray, depths: np.ndarray) -> np.ndarray:
    inc = np.sort(depths)
    return np.searchsorted(0.5 * (inc[1:] + inc[:-1]), np.asarray(depth, np.float64))


def maps_off(prog: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor],
             depths: np.ndarray) -> float:
    """Share of the pixels masked on either side whose mask differs or,
    masked on both, whose depth plane differs (0 where neither masks any)."""
    pm = np.asarray(prog["mask"]) > 0
    rm = ref["mask"].cpu().numpy() > 0
    pi = _plane_index(prog["depth"], depths)
    ri = _plane_index(ref["depth"].float().cpu().numpy(), depths)
    union = pm | rm
    if not union.any():
        return 0.0
    return float(((pm != rm) | (pm & rm & (pi != ri)))[union].mean())


def numbers(prog: dict, ref: dict, depths: np.ndarray) -> Dict[str, float]:
    """The gaps of one chunk.  Both sides give "cams" (each camera's DSI or
    temporal mean) and "extractions" ([(dsi, maps)], in the same order: the
    program's maps as host arrays)."""
    return {
        "dsi_l1": max(rel_l1(p, r) for p, r in zip(prog["cams"], ref["cams"])),
        "fused_l1": max(rel_l1(p, r) for (p, _), (r, _) in
                        zip(prog["extractions"], ref["extractions"])),
        "maps_off": max(maps_off(pm, rm, depths) for (_, pm), (_, rm) in
                        zip(prog["extractions"], ref["extractions"])),
    }


def worst(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over the rows (NaN where any is NaN)."""
    rows = list(rows)
    return {k: max((r[k] for r in rows), key=lambda v: math.inf if math.isnan(v) else v)
            for k in rows[0]} if rows else {}


def verdict(worst_numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every held number lies within its limit (NaN fails)."""
    return bool(worst_numbers) and all(
        k in worst_numbers and not math.isnan(worst_numbers[k]) and worst_numbers[k] <= limits[k]
        for k in limits)


def check_lines(worst_numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each held number beside its limit."""
    return {k: {"value": worst_numbers.get(k, float("nan")), "limit": limits[k]}
            for k in limits}
