"""Offline accuracy evaluation: depth metrics, PR curves, DSEC protocol."""

from .metrics import (  # noqa: F401
    DepthMetrics,
    error_metrics,
    mean_median_error,
    precision_completeness,
)
