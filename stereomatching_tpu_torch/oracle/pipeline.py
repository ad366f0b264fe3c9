"""Pure-NumPy serial oracle, phase-for-phase bit-comparable to the C reference.

The port's own copy of ``stereomatching_tpu/oracle/pipeline.py``, function
for function, on the port's ``config``; it runs on no device.

Every function mirrors one phase of the C reference's ``src/stereo.c`` (wrap
mode) / ``src/stereo-ghost.c`` (ghost mode) with identical arithmetic and
identical per-element operation order, vectorized.  Arrays are ``[H, W]``
row-major (C's ``IDX(x, y, w) = y*w + x``), so ``x`` is axis 1 and ``y``
is axis 0.

Float phases default to float64 == C ``double``; pass ``dtype=np.float32``
to get the oracle for an f32 execution tier (same op order, f32
rounding).  Everything downstream of edge extraction is exact integer
arithmetic in both tiers.

Known, documented deviations from the reference (all in code paths the
reference itself never exercises or that are undefined behavior there):

* ``fill_web_holes``: the reference's neighbor reads are raw flat-index
  offsets p±1 / p±w with NO bounds checks — reads past the malloc'd buffer
  are undefined behavior (src/stereo.c:237-243).  We define out-of-buffer
  neighbors as 0.  This never changes pipeline output because the winning-
  shift web contains no zeros (every pixel gets ``i+1`` for some i in
  find_highest_scoring_shifts, src/stereo.c:211-219), so the hole branch
  never fires on pipeline data.
* ``draw_contour``: the reference crashes with a division by zero when the
  elevation range is smaller than ``num_lines`` (``% interval`` with
  interval==0, src/stereo.c:266-271).  We clamp ``interval`` to >= 1.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from stereomatching_tpu_torch.config import (
    BoundaryMode,
    GHOST_BRIGHTNESS_FILL,
    StereoParams,
)

# The four directional edge operators (src/stereo.c:16-70): each compares
# the mean brightness of a 3-pixel strip on one side of the pixel against
# the opposite side.  Offsets are (dx, dy) pairs; the C sums are evaluated
# strictly left-to-right, which we preserve.
_EDGE_OPERATORS = (
    # find_edges_left_right (src/stereo.c:16-28)
    (((-1, -1), (-1, 0), (-1, 1)), ((1, -1), (1, 0), (1, 1))),
    # find_edges_top_bottom (src/stereo.c:30-42)
    (((-1, -1), (0, -1), (1, -1)), ((-1, 1), (0, 1), (1, 1))),
    # find_edges_upleft_downright (src/stereo.c:44-56)
    (((-1, -1), (0, -1), (-1, 0)), ((1, 0), (0, 1), (1, 1))),
    # find_edges_downleft_upright (src/stereo.c:58-70)
    (((-1, 1), (0, 1), (-1, 0)), ((0, -1), (1, -1), (1, 0))),
)


def _pad_for_stencil(
    brightness: np.ndarray, mode: BoundaryMode, dtype: np.dtype
) -> np.ndarray:
    """Pad by 1 pixel: modulo wrap (src/util.h:42-47) or the ghost
    programs' 1-px halo filled with 128.0 (src/stereo-ghost.c:384-385)."""
    b = np.asarray(brightness, dtype=dtype)
    if mode == BoundaryMode.WRAP:
        return np.pad(b, 1, mode="wrap")
    return np.pad(b, 1, mode="constant", constant_values=dtype.type(GHOST_BRIGHTNESS_FILL))


def find_edges(
    brightness: np.ndarray,
    threshold: float,
    mode: BoundaryMode = BoundaryMode.WRAP,
    dtype: np.dtype = np.dtype(np.float64),
    rule: str = "reference",
) -> np.ndarray:
    """Step 1 — binary edge map (``find_all_edges``, src/stereo.c:72-84).

    A pixel is an edge if, for any of the four directional operators, the
    absolute difference of the two 3-pixel side means exceeds
    ``clamp(threshold * overall_mean, 0, 1)`` (src/stereo.c:26-27).
    Returns uint8 in {0, 1}, shape [H, W].

    ``rule="reference"`` follows the C float operation order exactly;
    ``rule="exact"`` evaluates the equivalent real-arithmetic predicate
    2*|ka-kb| > min(f32(threshold)*(ka+kb), 1536) on integer pixel sums
    (ka = 3-pixel sum of brightness*256) — bit-deterministic across every
    backend because the only rounded float op is one IEEE multiply
    (see config.StereoParams.edge_rule).
    """
    if rule == "exact":
        return _find_edges_exact(brightness, threshold, mode)
    dtype = np.dtype(dtype)
    p = _pad_for_stencil(brightness, mode, dtype)
    h, w = brightness.shape
    thr = dtype.type(threshold)
    three = dtype.type(3.0)
    two = dtype.type(2.0)
    zero = dtype.type(0.0)
    one = dtype.type(1.0)

    def nb(dx: int, dy: int) -> np.ndarray:
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    edges = np.zeros((h, w), dtype=bool)
    for side_a, side_b in _EDGE_OPERATORS:
        (a0, a1, a2), (b0, b1, b2) = side_a, side_b
        # Preserve C's ((first + second) + third) / 3.0 grouping.
        avg_a = (nb(*a0) + nb(*a1) + nb(*a2)) / three
        avg_b = (nb(*b0) + nb(*b1) + nb(*b2)) / three
        overall = (avg_a + avg_b) / two
        bound = np.clip(thr * overall, zero, one)
        edges |= np.abs(avg_a - avg_b) > bound
    return edges.astype(np.uint8)


def _find_edges_exact(
    brightness: np.ndarray, threshold: float, mode: BoundaryMode
) -> np.ndarray:
    """The 'exact' edge rule: integer 3-pixel sums, one f32 multiply.

    Derivation: with S = k/256 (k the integer 3-pixel sum of 8-bit pixel
    values; the ghost halo's 128.0 contributes k=32768/pixel), the C
    predicate |Sa/3 - Sb/3| > clamp(t*(Sa/3+Sb/3)/2, 0, 1) rescaled by
    1536 becomes 2*|ka-kb| > min(t*(ka+kb), 1536).  ka+kb < 2^18 is exact
    in f32 and the single multiply is IEEE-rounded identically on every
    backend.
    """
    p = _pad_for_stencil(brightness, mode, np.dtype(np.float64))
    k = np.rint(p * 256.0).astype(np.int32)
    h, w = brightness.shape

    def nb(dx: int, dy: int) -> np.ndarray:
        return k[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    t32 = np.float32(threshold)
    edges = np.zeros((h, w), dtype=bool)
    for side_a, side_b in _EDGE_OPERATORS:
        ka = nb(*side_a[0]) + nb(*side_a[1]) + nb(*side_a[2])
        kb = nb(*side_b[0]) + nb(*side_b[1]) + nb(*side_b[2])
        lhs = (2 * np.abs(ka - kb)).astype(np.float32)
        rhs = np.minimum(t32 * (ka + kb).astype(np.float32), np.float32(1536.0))
        edges |= lhs > rhs
    return edges.astype(np.uint8)


def fill_matches(
    left_edges: np.ndarray,
    right_edges: np.ndarray,
    num_shifts: int,
    mode: BoundaryMode = BoundaryMode.WRAP,
) -> np.ndarray:
    """Step 2a — per-shift match planes (``fillup_matches``, src/stereo.c:113-127).

    ``matches[i][y, x] = (left[y, x] == right[y, x+i])`` where the x+i read
    wraps modulo width in wrap mode (src/stereo.c:120) or lands in the
    zero-filled ghost halo in ghost mode (src/stereo-ghost.c:119-121,
    edge halo = num_shifts filled 0, src/stereo-ghost.c:286-287).
    Returns uint8 {0,1}, shape [num_shifts, H, W].
    """
    h, w = left_edges.shape
    if mode == BoundaryMode.WRAP:
        cols = np.arange(w + num_shifts) % w
        right_ext = right_edges[:, cols]
    else:
        right_ext = np.pad(
            right_edges, ((0, 0), (0, num_shifts)), mode="constant"
        )
    out = np.empty((num_shifts, h, w), dtype=np.uint8)
    for i in range(num_shifts):
        out[i] = (left_edges == right_ext[:, i : i + w]).astype(np.uint8)
    return out


def box_sum(
    plane: np.ndarray,
    square_width: int,
    mode: BoundaryMode = BoundaryMode.WRAP,
) -> np.ndarray:
    """Step 2b — square-window sum (``addup_pixels_in_square``,
    src/stereo.c:132-148): for each pixel, the sum of the ``square_width``²
    window centered on it.  Wrap mode wraps both coordinates modulo the
    image (src/stereo.c:141-142); ghost mode reads the zero-filled match
    halo (src/stereo-ghost.c:140-141, halo width = square_width filled 0,
    src/stereo-ghost.c:93-97).  Computed via summed-area table — exact
    integer arithmetic, O(1) per pixel instead of the reference's
    square_width² reads per pixel.  Returns int32 [H, W].
    """
    h, w = plane.shape
    half = square_width // 2
    if mode == BoundaryMode.WRAP:
        p = np.pad(plane, half, mode="wrap")
    else:
        p = np.pad(plane, half, mode="constant")
    sat = np.zeros((h + 2 * half + 1, w + 2 * half + 1), dtype=np.int64)
    sat[1:, 1:] = p.astype(np.int64).cumsum(axis=0).cumsum(axis=1)
    k = 2 * half + 1
    out = (
        sat[k:, k:]
        - sat[:-k, k:]
        - sat[k:, :-k]
        + sat[:-k, :-k]
    )
    return out.astype(np.int32)


def record_scores(
    matches: np.ndarray,
    sums: np.ndarray,
) -> np.ndarray:
    """Step 2b' — keep the window sum only where a match occurred
    (``record_score``, src/stereo.c:172-182); elsewhere the score stays at
    its zero initialization (src/stereo.c:152-155).  int32 [D, H, W]."""
    return np.where(matches == 1, sums, np.int32(0)).astype(np.int32)


def best_and_winner(scores: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Step 2c — per-pixel best score and winning shift
    (``find_highest_scoring_shifts``, src/stereo.c:196-220).

    best  = max over shifts of the score (the reference folds into a
            zero-initialized buffer, src/stereo.c:311; scores are >= 0 so
            the floor at 0 is a no-op).
    winner = i+1 for the LAST shift i whose score equals best
            (src/stereo.c:211-219; last-wins tie rule).  Where no shift
            ever matched, every score is 0 == best, so winner ends at
            num_shifts — the web therefore never contains zeros.
    Returns (int32 [H, W], int32 [H, W]).
    """
    best = np.maximum(scores.max(axis=0), np.int32(0)).astype(np.int32)
    d = scores.shape[0]
    shift_ids = np.arange(1, d + 1, dtype=np.int32).reshape(d, 1, 1)
    winner = np.where(scores == best, shift_ids, np.int32(0)).max(axis=0)
    return best, winner.astype(np.int32)


def _flat_shift(f: np.ndarray, offset: int) -> np.ndarray:
    """Value at flat index p+offset, 0 outside the buffer.  Mirrors the
    reference's raw flat-pointer neighbor reads (IDX(x±1, y, w) == p±1,
    IDX(x, y±1, w) == p±w — NO wrapping, so x neighbors cross row
    boundaries exactly as the flat offset does, src/stereo.c:237-243)."""
    out = np.zeros_like(f)
    if offset > 0:
        out[: f.size - offset] = f[offset:]
    elif offset < 0:
        out[-offset:] = f[: f.size + offset]
    else:
        out[:] = f
    return out


def fill_web_holes(web: np.ndarray, times: int) -> np.ndarray:
    """Step 3a — diffusion of the disparity web (``fill_web_holes``,
    src/stereo.c:230-251).

    The reference double-buffers with a pointer swap whose net effect is the
    two-history recurrence
        X[t+1][p] = (X[t][p] == 0) ? floor(avg4(X[t])[p]) : X[t-1][p]
    with X[-1] = X[0] = input, and — because the final swap happens before
    the return and ``tmp`` (holding the newest state) is freed — the value
    returned is X[times-1], i.e. ``times-1`` effective steps (pointer trace
    of src/stereo.c:232-250).  We reproduce exactly that.
    """
    h, w = web.shape
    cur = web.astype(np.int32).ravel()
    prev = cur.copy()
    for _ in range(max(times - 1, 0)):
        avg = (
            _flat_shift(cur, 1)  # right neighbor, IDX(x+1, y, w)
            + _flat_shift(cur, w)  # IDX(x, y+1, w)
            + _flat_shift(cur, -1)  # IDX(x-1, y, w)
            + _flat_shift(cur, -w)  # IDX(x, y-1, w)
        ) // 4
        nxt = np.where(cur == 0, avg.astype(np.int32), prev)
        prev, cur = cur, nxt
    return cur.reshape(h, w)


def draw_contour(
    web: np.ndarray, num_lines: int
) -> tuple[np.ndarray, int, int]:
    """Step 3b — contour banding (``draw_contour_map``, src/stereo.c:256-274):
    global min/max reduce, interval = range / num_lines (C integer division),
    pixel on a contour line iff (web - min) % interval == 0.  ``interval``
    is clamped to >= 1 (the reference divides by zero when range < num_lines).
    Returns (uint8 {0,1} [H, W], min, max)."""
    max_e = int(web.max())
    min_e = int(web.min())
    interval = max((max_e - min_e) // num_lines, 1)
    out = (((web.astype(np.int64) - min_e) % interval) == 0).astype(np.uint8)
    return out, min_e, max_e


def run_pipeline(
    left: np.ndarray,
    right: np.ndarray,
    params: Optional[StereoParams] = None,
    dtype: np.dtype = np.dtype(np.float64),
    collect: bool = False,
) -> Dict[str, np.ndarray]:
    """Full pipeline (``algorithm``, src/stereo.c:287-333).

    ``left``/``right`` are brightness images in [0, 1) (uint8 pixel / 256.0,
    src/image.c:8-15), shape [H, W].  Returns a dict of artifacts named
    after the reference's debug dumps (src/stereo.c:302-320).  With
    ``collect=True`` also includes the per-shift planes
    (matches/score_all/scores).
    """
    params = params or StereoParams()
    h, w = left.shape
    params.validate_for_image(w, h)
    mode = params.mode

    edges_l = find_edges(left, params.threshold, mode, dtype, params.edge_rule)
    edges_r = find_edges(right, params.threshold, mode, dtype, params.edge_rule)
    return run_pipeline_from_edges(edges_l, edges_r, params, collect=collect)


def run_pipeline_from_edges(
    edges_l: np.ndarray,
    edges_r: np.ndarray,
    params: Optional[StereoParams] = None,
    collect: bool = False,
) -> Dict[str, np.ndarray]:
    """Everything downstream of edge extraction, seeded with given edge maps.

    Every phase after ``find_all_edges`` is exact integer arithmetic
    (src/stereo.c:90-274), so conditional on the edge maps the pipeline has
    ONE correct output.  The cross-repo parity gate (tools/knife_edge.py)
    uses this to prove an accelerated tier bit-equivalent to the C
    reference modulo provably-tied edge pixels: it seeds this oracle with
    the tier's own edges and byte-diffs all downstream artifacts.
    """
    params = params or StereoParams()
    mode = params.mode
    matches = fill_matches(edges_l, edges_r, params.num_shifts, mode)
    sums = np.stack(
        [box_sum(matches[i], params.square_width, mode) for i in range(params.num_shifts)]
    )
    scores = record_scores(matches, sums)
    best, winner = best_and_winner(scores)
    web = fill_web_holes(winner, params.times)
    out, min_e, max_e = draw_contour(web, params.lines)

    artifacts: Dict[str, np.ndarray] = {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        "web-2": web,
        "output-0": out,
    }
    if collect:
        for i in range(params.num_shifts):
            artifacts[f"matches-{i}"] = matches[i]
            artifacts[f"score_all-{i}"] = sums[i]
            artifacts[f"scores-{i}"] = scores[i]
    return artifacts
