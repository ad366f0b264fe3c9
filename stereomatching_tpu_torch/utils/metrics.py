"""Disparity quality metrics (the port's own copy of
``stereomatching_tpu/utils/metrics.py``, numpy only) — the BASELINE.md
acceptance metrics
("bad-pixel rate vs serial reference", "bit-comparable maps ... <=1-px
bad-match-rate bound").

The reference has no quality metrics at all (its oracle is bitwise
artifact equality); these serve the modern pipeline, whose sub-pixel
output has no bitwise ground truth.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def bad_pixel_rate(
    disparity: np.ndarray,
    ground_truth: np.ndarray,
    threshold: float = 1.0,
    valid: Optional[np.ndarray] = None,
) -> float:
    """Fraction of (valid) pixels whose |disparity - truth| > threshold —
    the standard Middlebury-style bad-pixel metric.  Non-finite ground
    truth (NaN == unknown, the data/formats.py contract) is excluded."""
    gt = np.asarray(ground_truth, np.float64)
    err = np.abs(np.asarray(disparity, np.float64) - gt)
    mask = np.isfinite(gt)
    if valid is not None:
        mask &= np.asarray(valid, bool)
    if not mask.any():
        return 0.0
    return float((err[mask] > threshold).mean())


def end_point_error(
    disparity: np.ndarray,
    ground_truth: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> float:
    """Mean absolute disparity error (EPE); non-finite ground truth is
    excluded."""
    gt = np.asarray(ground_truth, np.float64)
    err = np.abs(np.asarray(disparity, np.float64) - gt)
    mask = np.isfinite(gt)
    if valid is not None:
        mask &= np.asarray(valid, bool)
    if not mask.any():
        return 0.0
    return float(err[mask].mean())


def disparity_report(
    disparity: np.ndarray,
    ground_truth: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    return {
        "bad1": bad_pixel_rate(disparity, ground_truth, 1.0, valid),
        "bad2": bad_pixel_rate(disparity, ground_truth, 2.0, valid),
        "epe": end_point_error(disparity, ground_truth, valid),
        "coverage": float(np.asarray(valid, bool).mean()) if valid is not None else 1.0,
    }
