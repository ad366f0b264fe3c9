"""Synthetic stereo fixtures with ground-truth disparity (the port's own
copy of ``stereomatching_tpu/utils/synthetic.py``: numpy only, the same
names, defaults, seeds and arrays).

The reference ships one rendered scene at six resolutions
(test/imgs/{1..6}-WxH, SURVEY.md §2 #22) but no ground truth — its
oracle is implementation equality, not scene accuracy.  These
generators add the missing piece for the modern pipeline's quality
metrics (utils/metrics.py): pairs with exact per-pixel disparity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def blob_scene(
    h: int = 135,
    w: int = 240,
    seed: int = 0,
    max_disparity: int = 8,
    n_blobs: int = 6,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Piecewise-constant blobs at random depths over a gradient
    background -> (left u8, right u8, disparity i32).

    right[y, x] = left[y, x + d(y, x)] (wrapped), so a left-reference
    matcher recovers d.  Blob interiors have exact ground truth; blob
    boundaries are occlusion-ambiguous, as in real stereo.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    left = (32 + 128 * (xx / w) + 64 * (yy / h)).astype(np.float64)
    disparity = np.zeros((h, w), dtype=np.int32)
    for _ in range(n_blobs):
        y0 = int(rng.integers(0, max(h - 8, 1)))
        x0 = int(rng.integers(0, max(w - 12, 1)))
        bh = int(rng.integers(6, max(h // 3, 7)))
        bw = int(rng.integers(8, max(w // 3, 9)))
        val = int(rng.integers(60, 250))
        d = int(rng.integers(1, max_disparity))
        left[y0 : y0 + bh, x0 : x0 + bw] = val
        disparity[y0 : y0 + bh, x0 : x0 + bw] = d
    left = np.clip(left, 0, 255).astype(np.uint8)
    cols = (xx + disparity) % w
    right = left[yy, cols]
    return left, right, disparity


def textured_shift(
    h: int,
    w: int,
    shift: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense random texture under a constant horizontal shift —
    the sharpest possible quality probe (every pixel matchable).
    -> (left u8, right u8, disparity i32 == shift)."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = np.roll(left, -shift, axis=1)
    return left, right, np.full((h, w), shift, dtype=np.int32)


def random_dot_stereogram(
    h: int,
    w: int,
    seed: int = 0,
    max_disparity: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classic random-dot stereogram (Julesz): dense binary-noise texture
    with a raised central square — matchable ONLY by stereo
    correspondence (no monocular structure at all).
    -> (left u8, right u8, disparity i32)."""
    rng = np.random.default_rng(seed)
    left = (rng.random((h, w)) < 0.5).astype(np.uint8) * 255
    disparity = np.zeros((h, w), dtype=np.int32)
    disparity[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = max_disparity // 2 + 1
    yy, xx = np.mgrid[0:h, 0:w]
    right = left[yy, (xx + disparity) % w]
    return left, right, disparity


def slanted_plane(
    h: int,
    w: int,
    seed: int = 0,
    d_min: float = 1.0,
    d_max: float = 6.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Textured plane whose disparity ramps linearly across x — the
    sub-pixel probe: integer argmax gives a staircase, parabola
    refinement should track the ramp.  The right view is resampled with
    linear interpolation at fractional offsets.
    -> (left u8, right u8, disparity f64 [H, W])."""
    rng = np.random.default_rng(seed)
    # Smooth-ish texture so interpolation stays meaningful.
    base = rng.random((h, w + 16))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    k = np.outer(k, k) / 256.0
    from numpy.lib.stride_tricks import sliding_window_view

    pad = np.pad(base, 2, mode="wrap")
    tex = (sliding_window_view(pad, (5, 5)) * k).sum(axis=(-2, -1))[: h, : w + 16]
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    left = (tex[:, :w] * 255).astype(np.uint8)
    disparity = d_min + (d_max - d_min) * np.arange(w) / max(w - 1, 1)
    disparity = np.broadcast_to(disparity, (h, w)).copy()
    xs = np.arange(w)[None, :] + disparity  # right samples left at x + d
    x0 = np.clip(np.floor(xs).astype(int), 0, w + 14)
    frac = xs - np.floor(xs)
    rows = np.arange(h)[:, None]
    right_f = tex[rows, x0] * (1 - frac) + tex[rows, x0 + 1] * frac
    right = (right_f * 255).astype(np.uint8)
    return left, right, disparity


def occlusion_mask(disparity: np.ndarray) -> np.ndarray:
    """True where a LEFT-view pixel has no correspondence in the right
    view — the ground-truth occlusion mask for generators built by the
    inverse warp right[y, x] = left[y, (x + d(y, x)) % w] (blob_scene,
    random_dot_stereogram).  A left pixel xl is visible iff some right
    pixel samples it: exists xr with (xr + d(y, xr)) % w == xl.
    -> bool [H, W], True = occluded.

    This is exactly the pixel set LR consistency exists to reject, so
    the eval harness can score occlusion RECALL (how many truly
    occluded pixels the check invalidates) instead of only counting
    coverage."""
    h, w = disparity.shape
    vis = np.zeros((h, w), dtype=bool)
    yy, xx = np.mgrid[0:h, 0:w]
    vis[yy, (xx + disparity) % w] = True
    return ~vis


def photometric_perturb(
    left: np.ndarray,
    right: np.ndarray,
    noise_sigma: float = 0.0,
    gain: float = 1.0,
    bias: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Photometric robustness perturbation: independent Gaussian pixel
    noise on BOTH views plus a gain/bias exposure asymmetry applied to
    the RIGHT view only (right' = gain * right + bias + noise) — the
    standard radiometric-difference model census costs are supposed to
    be invariant to and SAD is not.  Values clip back to u8."""
    rng = np.random.default_rng(seed)

    def u8(x):
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    lf = left.astype(np.float64)
    rf = right.astype(np.float64) * gain + bias
    if noise_sigma > 0:
        lf = lf + rng.normal(0.0, noise_sigma, left.shape)
        rf = rf + rng.normal(0.0, noise_sigma, right.shape)
    return u8(lf), u8(rf)


def size_sweep_sizes() -> Tuple[Tuple[int, int], ...]:
    """The reference's fixture resolutions (test/imgs/, SURVEY.md §2 #22),
    including the 8K pair stripped from its mirror."""
    return (
        (135, 240),
        (270, 480),
        (540, 960),
        (1080, 1920),
        (2160, 3840),
        (4320, 7680),
    )
