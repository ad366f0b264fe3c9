"""The card's peak rates and the bounds that ``chip_smoke.py``,
``tools/profile_torch_pipeline.py`` and ``bench/roofline.py`` hold the
kernels' times against (each kernel's ``*_work``: bytes, operations and
their unit's peak rate, and its ``*_bound_ms``), the
K7 instances both of them time and the bench kernels whose SASS both
count, kept in one place."""

from __future__ import annotations

import re

# Peaks of one H100 SXM (NVIDIA data sheet and Hopper white paper; 132 SMs
# at 1.98 GHz boost): 3.35 TB/s of HBM3; 64 int32 adds, logic ops or
# compares per SM per clock = 16.7 T int32 ops/s; 16 population counts per
# SM per clock (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0); 67 TFLOP/s float32 outside the
# tensor cores, which counts a fused multiply-add as two operations (132
# SMs x 128 lanes x 1.98 GHz x 2); adds, multiplies and divide steps that
# may not be contracted issue at half that, one per lane and clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
POPC_PER_S = 132 * 16 * 1.98e9
FP32_OPS_PER_S = 67e12
FP32_UNFUSED_OPS_PER_S = 132 * 128 * 1.98e9
# NVLink 4 of the H100 SXM (NVIDIA data sheet): 900 GB/s to the other
# cards of the host in all, which is 450 GB/s each way.
NVLINK_BYTES_PER_S_EACH_WAY = 450e9


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """-> (least ms the card could take, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# K7's timed instances, at 8 x 1024 x 1024: (cost, window, D).  The first
# is the box route's default (the bench instance).  The census ones (codes
# of the 5x5 transform) are those K7's census route rule is read from:
# strips giving 1 to 8 warps per SM, and the tiles staged or read through
# L1 (the last six from census window 31, D=128).
K7_SWEEP = [("sad", 9, 64), ("sad", 1, 64), ("sad", 5, 64), ("sad", 15, 64), ("sad", 31, 64),
            ("sad", 9, 128), ("sad", 9, 256), ("sad", 101, 64)] + [
    ("census", w, d) for w, d in ((9, 64), (9, 128), (9, 192), (15, 128), (21, 64), (31, 64),
                                  (9, 256), (15, 192), (31, 128), (31, 256), (51, 64),
                                  (51, 128), (51, 256), (101, 64))]
# The SAD kernels at D=64 (ND 2) of the strips and the staged tiles, as
# cu++filt shows them (bools as false/true or (bool)0/1) or mangled.
K7_BENCH_KERNELS = re.compile(
    r"strips_kernel(<(false|\(bool\)0), \(int\)2>|ILb0ELi2E)"
    r"|disparity_kernel(<(false|\(bool\)0), (true|\(bool\)1)>|ILb0ELb1E)")


# K5's segment kernels at the bench instance (int16, one word a lane,
# word loads), with and without the second best; K2's fused kernel on
# byte cells in one launch (first and last); K3's staged kernels at int8
# (census: the SGM bench instance); as cu++filt shows them or mangled.
K5_BENCH_KERNELS = re.compile(
    r"seg_kernel(<short, \(int\)1, (true|\(bool\)1), |IsLi1ELb1E)")
K2_BENCH_KERNELS = re.compile(
    r"fused_kernel(<unsigned char, (true|\(bool\)1), (true|\(bool\)1)>|IhLb1ELb1E)")
K3_BENCH_KERNELS = re.compile(
    r"(pixel|vector)_kernel(<signed char, (true|\(bool\)1)>|IaLb1EE)")


def k7_bound_ms(cost: str, npix: int, d: int) -> tuple[float, str]:
    """K7's least time on the card for ``npix`` pixels at ``d``
    disparities: per pixel and disparity 5 int32 instructions, one per
    value and step: the cost (an absolute difference; for census an XOR
    and a population count on its own unit), the column sum's update and
    the row sum's (one 3-input add each: sum + entering - leaving), the
    key ``cost << 8 | d`` (one shift-add) and the running minimum; for
    census the larger of that time and the population counts'.  Sub-word
    SIMD (four differences per ``__vabsdiffu4``, two 16-bit sums per add)
    would go lower and is not counted.  Bytes: 8 in and 12 out per pixel.
    -> (ms, "operations" or "bytes")."""
    pxd = npix * d
    ops_ms = 5 * pxd / INT32_OPS_PER_S * 1e3
    if cost == "census":
        ops_ms = max(ops_ms, pxd / POPC_PER_S * 1e3)
    bytes_ms = 20 * npix / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# The int32 instructions per pixel and shift that the classic matchers'
# shift loop (K1, K8, K9; ``csrc/match_loop.cuh``) needs, one per value
# and step as K7's: the column sum's update and the row sum's (one 3-input
# add each: sum + entering - leaving), the score (the box sum where the
# pixel matches, else 0: one select), the key ``score << 16 | s + 1`` (one
# shift-add) and the running maximum; and the match itself, 32 cells per
# funnel shift and 3-input logic op (``~(L ^ R) & V``).  The sub-pixel
# plane's carries add 5: the compare that takes a new maximum, the select
# that hands the previous step's selection its right neighbour, the
# selects of the left neighbour and of the reset right one, and the
# previous score carried.  Each strip's first window sum is not counted.
LOOP_OPS = 5 + 2 / 32
SUBPIXEL_OPS = 5


def loop_ops(npix: int, d: int, subpixel: bool = False) -> float:
    """The shift loop's int32 instructions for ``npix`` output pixels at
    ``d`` shifts (``LOOP_OPS``, + ``SUBPIXEL_OPS`` with the plane)."""
    return (LOOP_OPS + (SUBPIXEL_OPS if subpixel else 0)) * npix * d


def k1_work(npix: int, d: int, subpixel: bool = False) -> tuple[float, float, float]:
    """K1's work for ``npix`` pixels at ``d`` shifts -> (bytes, ops, the
    ops' peak rate): two float32 brightness planes in, best, winner and
    both edge planes out (24 B per pixel; 28 with the float32 sub-pixel
    plane); the shift loop's ``loop_ops``.  Its exact-rule edge stage (a
    few tens of ops per pixel and view, with float conversions) is left
    out, so this is the loop's floor alone."""
    return (28 if subpixel else 24) * npix, loop_ops(npix, d, subpixel), INT32_OPS_PER_S


def k1_bound_ms(npix: int, d: int, subpixel: bool = False) -> tuple[float, str]:
    """K1's least time on the card (``k1_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k1_work(npix, d, subpixel))


def k8_work(npix: int, d: int, subpixel: bool = False) -> tuple[float, float, float]:
    """K8's work for ``npix`` pixels at ``d`` shifts -> (bytes, ops, the
    ops' peak rate): two int32 edge maps in, best and winner out (16 B
    per pixel; 20 with the float32 sub-pixel plane); the shift loop's
    ``loop_ops``."""
    return (20 if subpixel else 16) * npix, loop_ops(npix, d, subpixel), INT32_OPS_PER_S


def k8_bound_ms(npix: int, d: int, subpixel: bool = False) -> tuple[float, str]:
    """K8's least time on the card (``k8_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k8_work(npix, d, subpixel))


def k9_bound_ms(in_cells: int, kept_px: int, halo_px: int, d: int) -> tuple[float, str]:
    """K9's least time on the card for halo blocks of ``in_cells`` int32
    cells in all (both maps, 4 B each read once), ``kept_px`` output
    pixels (best and winner, 8 B each) and ``halo_px`` cells of the 2 x
    half halo rows its windows reach, at ``d`` shifts: per shift
    ``loop_ops`` per kept pixel, as K8, and per halo cell only its match
    and its row sum's update, 1 + 2/32 (it enters the column sums through
    the kept pixels' adds).  -> (ms, "operations" or "bytes")."""
    return bound(4 * in_cells + 8 * kept_px,
                 loop_ops(kept_px, d) + (1 + 2 / 32) * halo_px * d, INT32_OPS_PER_S)


def k3_work(npix: int, d: int, volume_bytes: int,
            cost: str = "census") -> tuple[float, float, float]:
    """K3's work for ``npix`` pixels at ``d`` disparities -> (bytes, ops,
    the ops' peak rate): two int32 code (or pixel) planes in (8 B per
    pixel), the volume out (``volume_bytes`` per element); per element 2
    int32 ops (an XOR and a population count for census, a difference and
    an absolute value for SAD); for census the population counts on their
    own unit instead where they take longer."""
    nvox = npix * d
    nbytes = 8 * npix + volume_bytes * nvox
    if cost == "census" and nvox / POPC_PER_S > 2 * nvox / INT32_OPS_PER_S:
        return nbytes, nvox, POPC_PER_S
    return nbytes, 2 * nvox, INT32_OPS_PER_S


def k3_bound_ms(npix: int, d: int, volume_bytes: int, cost: str = "census") -> tuple[float, str]:
    """K3's least time on the card (``k3_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k3_work(npix, d, volume_bytes, cost))


# The int32 instructions per element and path of K4's recurrence: the
# candidates at d - 1 and d + 1 plus P1 (2 adds), the minimum of the four
# candidates (3), the cost added and the previous step's minimum
# subtracted (2), the running minimum of the step (1) and the exchange of
# the neighbours' values (1).
K4_STEP_OPS = 9


def k4_work(nvox: int, paths: int, volume_bytes: int,
            agg_bytes: int) -> tuple[float, float, float]:
    """K4's work for ``paths`` passes, one per path, over ``nvox``
    elements -> (bytes, ops, the ops' peak rate): the first pass reads
    the volume and writes the aggregate, each further pass reads the
    volume and the aggregate and writes the aggregate (the one-pass-per-
    path byte floor); ``K4_STEP_OPS`` per element and path."""
    nbytes = ((volume_bytes + agg_bytes) * nvox
              + (paths - 1) * (volume_bytes + 2 * agg_bytes) * nvox)
    return nbytes, K4_STEP_OPS * paths * nvox, INT32_OPS_PER_S


def k4_bound_ms(nvox: int, paths: int, volume_bytes: int, agg_bytes: int) -> tuple[float, str]:
    """K4's least time on the card for one pass per path (``k4_work``).
    -> (ms, "operations" or "bytes")."""
    return bound(*k4_work(nvox, paths, volume_bytes, agg_bytes))


def k5_work(npix: int, d: int, agg_bytes: int,
            uniqueness: bool = False) -> tuple[float, float, float]:
    """K5's work for ``npix`` pixels at ``d`` disparities -> (bytes, ops,
    the ops' peak rate): the aggregate read once (``agg_bytes`` x d per
    pixel) and four 4-byte planes written (disparity, sub-pixel, cost,
    right disparity; the second best a fifth with ``uniqueness``): 16 or
    20 B per pixel.  Per element 2 int32 ops for each first minimum, the
    left view's and the right view's (the key or the compare, and the
    running minimum), and 2 more for the second best (the |d - d*| > 1
    test folded into the select, and the minimum)."""
    nvox = npix * d
    nbytes = agg_bytes * nvox + (20 if uniqueness else 16) * npix
    return nbytes, (6 if uniqueness else 4) * nvox, INT32_OPS_PER_S


def k5_bound_ms(npix: int, d: int, agg_bytes: int, uniqueness: bool = False) -> tuple[float, str]:
    """K5's least time on the card (``k5_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k5_work(npix, d, agg_bytes, uniqueness))


# The int32 instructions per cell and step of the web diffusion (K2): the
# four neighbours' sum as two 3-input adds, the floor division by 4 (one
# shift), the test of the cell's own value against 0 and the select
# between the average and the step before.  Packing four byte cells in a
# word would go lower and is not counted.
K2_CELL_OPS = 5


def k2_work(npix: int, times: int) -> tuple[float, float, float]:
    """K2's work for ``npix`` cells at ``times`` (so ``max(times - 1, 0)``
    Jacobi steps) -> (bytes, ops, the ops' peak rate): ``K2_CELL_OPS`` per
    cell and step; the int32 web read once and the int32 result written
    once (8 B per cell)."""
    return 8 * npix, K2_CELL_OPS * npix * max(times - 1, 0), INT32_OPS_PER_S


def k2_bound_ms(npix: int, times: int) -> tuple[float, str]:
    """K2's least time on the card (``k2_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k2_work(npix, times))


# The float32 operations of one fill of the validity-aware fill (K6): the
# four neighbours' products d * v (4 multiplies), their sum (3 adds), the
# validities' sum (3 adds), max(den, 1) and the divide.  A cell fills once,
# at the sweep where it turns valid (its d never changes again); cells
# valid from the start and cells that never fill do no float work, and the
# sweeps' validity tests are integer work on words of four cells, not
# charged.  None of the float ops may be contracted into a fused
# multiply-add (the result stays bitwise the plain version's), so they
# issue at ``FP32_UNFUSED_OPS_PER_S``.
K6_FILL_OPS = 12


def k6_filled(valid, iterations: int) -> int:
    """The cells of the bool plane ``valid`` [..., H, W] (a torch tensor)
    that K6 fills in ``iterations`` sweeps: an invalid cell turns valid at
    the first sweep after which a 4-neighbour inside the image is valid."""
    v = valid.clone()
    for _ in range(iterations):
        n = v.clone()
        n[..., :, :-1] |= v[..., :, 1:]
        n[..., :, 1:] |= v[..., :, :-1]
        n[..., :-1, :] |= v[..., 1:, :]
        n[..., 1:, :] |= v[..., :-1, :]
        if not bool((n ^ v).any()):
            break
        v = n
    return int((v & ~valid).sum())


def k6_work(npix: int, filled: int) -> tuple[float, float, float]:
    """K6's work for ``npix`` pixels of which ``filled`` turn valid
    (``k6_filled``) -> (bytes, ops, the ops' peak rate): the float32
    disparity and the bool validity in, the float32 result out (9 B per
    pixel); ``K6_FILL_OPS`` per filled cell at the unfused float32 rate,
    whatever the sweeps."""
    return 9 * npix, K6_FILL_OPS * filled, FP32_UNFUSED_OPS_PER_S


def k6_bound_ms(npix: int, filled: int) -> tuple[float, str]:
    """K6's least time on the card (``k6_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k6_work(npix, filled))


# The int32 instructions per neighbour of K10's census: the compare, the
# select of its bit and the or into the code.
K10_NEIGHBOUR_OPS = 3


def k10_work(npix: int, window: int = 5) -> tuple[float, float, float]:
    """K10's work for both views of ``npix`` pixels each at ``window``
    (3 or 5) -> (bytes, ops, the ops' peak rate): each view's int32 plane
    in and its int32 codes out; per pixel and view
    ``K10_NEIGHBOUR_OPS`` for each of the window^2 - 1 neighbours (72 at
    window 5, the SGM work model's census charge)."""
    ops = 2 * K10_NEIGHBOUR_OPS * (window * window - 1) * npix
    return 2 * 8 * npix, ops, INT32_OPS_PER_S


def k10_bound_ms(npix: int, window: int = 5) -> tuple[float, str]:
    """K10's least time on the card (``k10_work``).  -> (ms, "operations"
    or "bytes")."""
    return bound(*k10_work(npix, window))
