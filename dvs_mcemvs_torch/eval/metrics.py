"""Depth-accuracy metrics matching the reference evaluation suite.

Reimplements the metric definitions of
`mapper_emvs_stereo/scripts/depth_metrics.py:4-37` (inlier ratios delta <
1.25^n, SILog, absolute relative error, log RMSE, bad-p with baseline b and
focal f) and the cumulative precision/completeness/F1/outlier curves of
`scripts/precision_completeness.py:8-103`, as library functions returning
numbers instead of printing/plotting.  Pure numpy, on the host: a copy of
dvs_mcemvs_tpu/eval/metrics.py, so the port imports nothing of the JAX
package.

Inputs are paired arrays of estimated and ground-truth depth with a shared
validity mask (or np.ma masked arrays, as the reference uses).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


def _as_masked(est, gt, mask=None):
    est = np.ma.asarray(est, dtype=np.float64)
    gt = np.ma.asarray(gt, dtype=np.float64)
    joint = np.ma.getmaskarray(est) | np.ma.getmaskarray(gt)
    if mask is not None:
        joint = joint | ~np.asarray(mask, bool)
    est = np.ma.array(est, mask=joint)
    gt = np.ma.array(gt, mask=joint)
    return est, gt


@dataclasses.dataclass(frozen=True)
class DepthMetrics:
    """The metric set of depth_metrics.py plus count and mean/median."""

    delta1: float
    delta2: float
    delta3: float
    silog: float
    abs_rel: float
    log_rmse: float
    bad_p: float
    mean_err: float
    median_err: float
    count: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def error_metrics(
    est, gt, b: float, f: float, mask: Optional[np.ndarray] = None
) -> DepthMetrics:
    """All metrics over jointly-valid pixels.

    `b` and `f` are the stereo baseline (m) and focal length (px) used by
    the disparity-style bad-p threshold (err > 5 px AND relative err > 5 %,
    depth_metrics.py:27-30).
    """
    est, gt = _as_masked(est, gt, mask)
    data = est.compressed()
    g = gt.compressed()
    n = data.size
    if n == 0:
        nan = float("nan")
        return DepthMetrics(*([nan] * 9), 0)

    delta = np.maximum(data / g, g / data)
    delta1 = float(np.mean(delta < 1.25))
    delta2 = float(np.mean(delta < 1.25 ** 2))
    delta3 = float(np.mean(delta < 1.25 ** 3))

    di = np.log(g) - np.log(data)
    silog = float(np.mean(di ** 2) - np.mean(di) ** 2)

    # Note: the reference normalizes by the *estimate* (data), not gt
    # (depth_metrics.py:22) — kept for parity.
    abs_rel = float(np.mean(np.abs(data - g) / data))

    log_rmse = float(np.sqrt(np.mean(di ** 2)))

    err_px = np.abs(1.0 / data - 1.0 / g) * b * f
    rel_err = err_px * g / (b * f)
    bad_p = float(np.mean((err_px > 5) & (rel_err > 0.05)))

    abs_err = np.abs(data - g)
    return DepthMetrics(
        delta1=delta1, delta2=delta2, delta3=delta3, silog=silog,
        abs_rel=abs_rel, log_rmse=log_rmse, bad_p=bad_p,
        mean_err=float(np.mean(abs_err)),
        median_err=float(np.median(abs_err)),
        count=int(n),
    )


def mean_median_error(est, gt, mask=None) -> Tuple[float, float]:
    """Consolidated mean/median absolute error
    (evaluate_mcemvs_dsec.py:135-141)."""
    est, gt = _as_masked(est, gt, mask)
    err = np.ma.abs(est - gt).compressed()
    if err.size == 0:
        return float("nan"), float("nan")
    return float(np.mean(err)), float(np.median(err))


def precision_completeness(
    est, gt, mask=None, bin_width: float = 0.01, max_err: Optional[float] = None
) -> Dict[str, np.ndarray]:
    """Cumulative curves over the absolute-error histogram
    (precision_completeness.py:40-101).

    precision(e) = % of ESTIMATED points with error <= e
    recall(e)    = % of GT points with error <= e (completeness)
    f1(e)        = harmonic mean of the two
    outliers(e)  = % of error points beyond e
    Returns {"edges", "precision", "recall", "f1", "outliers"}; counts use
    the reference's denominators: estimated-point count for precision,
    gt-point count for recall, valid error pairs for outliers.
    """
    est_m, gt_m = _as_masked(est, gt, mask)
    err = np.ma.abs(est_m - gt_m).compressed()
    n_est = int(np.ma.count(np.ma.asarray(est)) if mask is None
                else np.sum(np.asarray(mask, bool) & ~np.ma.getmaskarray(np.ma.asarray(est))))
    n_gt = int(np.ma.count(np.ma.asarray(gt)))
    if err.size == 0:
        z = np.zeros(0)
        return {"edges": z, "precision": z, "recall": z, "f1": z, "outliers": z}
    top = max_err if max_err is not None else float(np.max(err))
    nbins = max(1, int(top / bin_width))
    values, base = np.histogram(err, bins=nbins)
    cum = np.cumsum(values)
    precision = cum / max(n_est, 1) * 100.0
    recall = cum / max(n_gt, 1) * 100.0
    denom = np.where(precision + recall > 0, precision + recall, 1.0)
    f1 = 2 * precision * recall / denom
    outliers = (err.size - cum) / err.size * 100.0
    return {"edges": base[:-1], "precision": precision, "recall": recall,
            "f1": f1, "outliers": outliers}
