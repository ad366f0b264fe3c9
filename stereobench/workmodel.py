"""The yardstick of ``roofline_pct``: the card's peaks and the least time
each stage of a route could take, from the shapes alone.

A frozen copy of ``stereomatching_tpu_torch/utils/bench.py``'s peaks and
``*_work`` functions and of ``stereomatching_tpu_torch/bench/roofline.py``'s
per-pair phase models, so that a change to the program cannot move the
yardstick it is measured by.  Nothing here imports the program.

Assumption stated with the copy: the int32, population-count and
unfused-float32 rates take the H100 SXM's 1.98 GHz boost clock on all
132 SMs; HBM3 is the published 3.35 TB/s.  Both assume the card's full
700 W power limit; the harness prints the card's limit beside every run.

Each stage's least time is max(bytes / HBM rate, ops / their unit's
rate); a route's least time per pair is the sum over its stages.  It
counts the work of the functions the route computes at the cell's
shapes, whatever implements each stage.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Peaks of one H100 SXM (NVIDIA data sheet and Hopper white paper; 132 SMs
# at 1.98 GHz boost): 3.35 TB/s of HBM3; 64 int32 adds, logic ops or
# compares per SM per clock; 16 population counts per SM per clock (CUDA
# C++ Programming Guide, throughput of native arithmetic instructions,
# compute capability 9.0); float32 adds, multiplies and divide steps that
# may not be contracted issue one per lane and clock (128 lanes per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
POPC_PER_S = 132 * 16 * 1.98e9
FP32_UNFUSED_OPS_PER_S = 132 * 128 * 1.98e9

Work = Tuple[float, float, float]  # (bytes, ops, the ops' peak rate)


def least_s(work: Work) -> float:
    """Least seconds of one stage: the larger of its bytes at the HBM
    rate and its operations at their unit's rate."""
    nbytes, ops, rate = work
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


# ---------------------------------------------------------------- classic

# The shift loop's int32 instructions per pixel and shift: the column
# and row sums' updates (one 3-input add each), the score select, the key
# shift-add and the running maximum; the match itself, 32 cells per
# funnel shift and 3-input logic op.
LOOP_OPS = 5 + 2 / 32
# The diffusion's int32 instructions per cell and step: two 3-input adds,
# the floor division by 4, the test against 0 and the select.
K2_CELL_OPS = 5
# The contour's bands, per pixel: subtract, convert, divide, floor,
# convert, multiply, subtract, three compares, two ors.
CONTOUR_OPS = 12


def match_work(npix: int, d: int) -> Work:
    """Edges, per-shift match, box score and argmax (K1's function): two
    float32 brightness planes in, best, winner and both edge planes out
    (24 B per pixel); ``LOOP_OPS`` per pixel and shift."""
    return 24 * npix, LOOP_OPS * npix * d, INT32_OPS_PER_S


def diffusion_work(npix: int, times: int) -> Work:
    """The web diffusion (K2's function): ``max(times - 1, 0)`` Jacobi
    steps of ``K2_CELL_OPS``; the int32 web read and written once."""
    return 8 * npix, K2_CELL_OPS * npix * max(times - 1, 0), INT32_OPS_PER_S


def contour_work(npix: int) -> Work:
    """The contour bands: the web in, the bands out."""
    return 8 * npix, CONTOUR_OPS * npix, FP32_UNFUSED_OPS_PER_S


def classic_stages(params: Dict, h: int, w: int) -> Dict[str, Work]:
    """Per-pair work of the classic route's stages (exact edge rule)."""
    npix = h * w
    return {"match": match_work(npix, params["num_shifts"]),
            "diffusion": diffusion_work(npix, params["times"]),
            "contour": contour_work(npix)}


# ---------------------------------------------------------------- SGM

# The 5x5 census per image: 24 compares, 24 shifts and 24 ors.
CENSUS_OPS = 3 * 24
# The LR check per pixel: target column, two range tests, gather, select,
# difference, absolute value, compare.
LR_OPS = 8
# The path recurrence per element and path: 2 adds (d +- 1 with P1), 3
# minima, 2 adds (cost, minus the previous minimum), the running minimum
# and the neighbours' exchange.
K4_STEP_OPS = 9


def sgm_dtype_bytes(params: Dict) -> Tuple[int, int]:
    """Bytes per element of the volume and the aggregate: the narrowest
    integer type that holds every value (census cost <= window^2 - 1, SAD
    <= 255; a path value <= cost + P2; the sum of ``directions`` paths),
    the same rule the program states for its storage."""
    census = params["cost"] == "census"
    cost = params["census_window"] ** 2 - 1 if census else 255
    top = cost + params["sgm_p2"]
    d = params["num_disparities"]
    vol = 1 if (top < 127 and d >= 32 and d == 1 << (d - 1).bit_length()) else (
        2 if top < 16384 else 4)
    agg = 2 if params["sgm_directions"] * top < 2**15 else 4
    return vol, agg


def sgm_stages(params: Dict, h: int, w: int) -> Dict[str, Work]:
    """Per-pair work of the SGM route's stages: census of both images,
    the volume (K3's function), the aggregation over the paths (K4's),
    the tail (K5's), the LR check and the fill (K6's).  Each stage reads
    its input and writes its output once: the aggregation reads the
    volume once and writes the aggregate once, however many passes an
    implementation makes.  The fill's float work, 12 ops per cell it
    fills, is below its 9 bytes per pixel at any fill, so the bytes bound
    it and the fill count is not needed."""
    npix = h * w
    d = params["num_disparities"]
    nvox = npix * d
    vb, ab = sgm_dtype_bytes(params)
    paths = params["sgm_directions"]
    if params["cost"] == "census" and nvox / POPC_PER_S > 2 * nvox / INT32_OPS_PER_S:
        volume = (8 * npix + vb * nvox, nvox, POPC_PER_S)
    else:
        volume = (8 * npix + vb * nvox, 2 * nvox, INT32_OPS_PER_S)
    return {
        "census": (16 * npix, 2 * CENSUS_OPS * npix, INT32_OPS_PER_S),
        "volume": volume,
        "aggregation": ((vb + ab) * nvox, K4_STEP_OPS * paths * nvox, INT32_OPS_PER_S),
        "tail": (ab * nvox + 16 * npix, 4 * nvox, INT32_OPS_PER_S),
        "lr_check": (9 * npix, LR_OPS * npix, INT32_OPS_PER_S),
        "fill": (9 * npix, 0.0, FP32_UNFUSED_OPS_PER_S),
    }


def least_s_per_pair(stages: Dict[str, Work]) -> float:
    """A route's least seconds per pair: the sum of its stages'."""
    return sum(least_s(work) for work in stages.values())
