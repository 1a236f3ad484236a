"""The consolidation step of the DSEC ground-truth protocol.

Port of the parts of dvs_mcemvs_tpu/eval/dsec.py that score depth maps the
caller already holds: the evaluation rig (`DsecEvalRig`) and the metrics
consolidated over matched frames (`evaluate_sequence`, as the reference's
scripts/evaluate_mcemvs_dsec.py:129-145 does).  Pure numpy, on the host.
The file loaders of the JAX module (GT disparity PNGs, depth-point files,
timestamp matching) are ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from .metrics import error_metrics, mean_median_error


@dataclasses.dataclass(frozen=True)
class DsecEvalRig:
    """Geometry needed by the protocol (from cam_to_cam.yaml)."""

    Q: np.ndarray          # (4, 4) disparity-to-depth for the GT stereo pair
    T_rect0_0: np.ndarray  # (4, 4) rectification rotation of cam0
    K_target: np.ndarray   # (3, 3) projection into the left event camera
    baseline: float = 0.6

    @property
    def focal(self) -> float:
        return float(self.K_target[0, 0])


def evaluate_sequence(
    est_maps: Sequence[np.ma.MaskedArray],
    gt_maps: Sequence[np.ma.MaskedArray],
    rig: DsecEvalRig,
) -> Dict[str, object]:
    """Consolidated metrics over matched frame pairs."""
    est = np.ma.array([np.ma.asarray(m) for m in est_maps])
    gt = np.ma.array([np.ma.asarray(m) for m in gt_maps])
    mean_err, median_err = mean_median_error(est, gt)
    metrics = error_metrics(est, gt, b=rig.baseline, f=rig.focal)
    return {
        "frames": len(est_maps),
        "mean_err": mean_err,
        "median_err": median_err,
        "metrics": metrics,
    }
