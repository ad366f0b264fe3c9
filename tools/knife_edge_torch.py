#!/usr/bin/env python
"""Quantified cross-repo parity gate of the PyTorch/CUDA port (counterpart
of ``tools/knife_edge.py``, built on the port's numpy oracle and image
I/O; it imports no module of the JAX package).

REF_DIR holds the reference rule's dumps: the C reference's, or the
port's ``python -m stereomatching_tpu_torch.cli --tier oracle
--edge-rule reference`` (the numpy oracle, which is held byte-identical
to the C reference's semantics).  OUR_DIR holds the port's ``--tier
cuda|cpu|sharded --edge-rule exact`` dumps.

The port's tiers run the bit-deterministic ``exact`` edge rule, whose decisions can differ from the C reference's double-order
float rule ONLY at knife-edge ties — pixels where the edge predicate
2*|ka-kb| vs min(t*(ka+kb), 1536) (the rescaled-integer form of
src/stereo.c:26-27; ka/kb are 3-pixel integer brightness sums) lands
within floating-point rounding distance of exact equality, so the decision
is set by rounding direction, not by the data.  Everything downstream of
edge extraction is exact integer arithmetic (src/stereo.c:90-274), so a
divergent edge pixel cascades; a naive byte-diff of downstream artifacts
(the reference's test/diff.sh:14-20) therefore cannot gate these tiers.

This tool makes the comparison principled and quantified:

1. EDGE GATE — enumerate every pixel where the tier's edge map differs
   from the C reference's, and prove EACH one is a genuine tie: for every
   directional operator whose decision flips, the exact rational predicate
   margin |2|ka-kb| - t(ka+kb)| / t(ka+kb), with t the user's decimal
   threshold as an exact Fraction, must be <= 2^-20.  (Both the C double
   evaluation and the f32 exact rule are within ~2^-23 relative of the
   rational predicate, so any data-driven difference would exceed the
   bound by orders of magnitude; the observed divergences are EXACT
   rational ties, margin 0.)  The count must stay under a small fraction
   of the image (default 2e-4 — measured: 3 pixels on the reference's
   240x135 fixture).
2. CONDITIONAL DOWNSTREAM GATE — seed the port's NumPy oracle (held
   bitwise against the JAX package's, which is byte-identical to the C
   reference on all 192 artifacts) with the tier's OWN edge maps and
   byte-compare every downstream artifact the tier dumped
   (score_best/web-1/web-2/output-0) against the seeded oracle's PPM
   bytes.  This proves the tier is bit-equivalent to the C reference's
   semantics conditional on the proven-tied edge pixels — closing the gap
   between "matches our oracle" and "matches the reference".

Usage:

    python tools/knife_edge_torch.py REF_DIR OUR_DIR IMG1 IMG2 \
        [--mode wrap|ghost] [--threshold 0.15] [--square-width 21]
        [--times 32] [--lines 10] [--shifts 30] [--max-frac 2e-4]

Exits 0 iff every edge difference is a proven tie AND every downstream
artifact is byte-identical conditional on the edges.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.oracle import pipeline as oracle
from stereomatching_tpu_torch.oracle.pipeline import _EDGE_OPERATORS, _pad_for_stencil
from stereomatching_tpu_torch.utils.imageio import (
    artifact_ppm_type,
    ppm_bytes,
    read_png_gray,
    read_ppm,
    to_brightness,
)

# Relative rational-margin bound under which an operator flip is a proven
# tie.  The C double evaluation differs from the exact rational predicate
# by O(2^-50) and the f32 exact rule by O(2^-23) (one f32 multiply of the
# f32-rounded threshold), so any flip forced by rounding sits below
# ~2^-22; a data-driven disagreement would show margins of order 1/t(ka+kb)
# >~ 3e-3.  2^-20 separates the two regimes by >1000x each way.
TIE_MARGIN = 2.0 ** -20

# Downstream artifacts every tier dumps (the kernels fuse the per-shift
# planes away; these are the reference's final dumps,
# src/stereo.c:311-320).
DOWNSTREAM = ("score_best-0", "web-1", "web-2", "output-0")


@dataclass
class EdgeDiff:
    y: int
    x: int
    op: int            # first flipped operator index
    ka: int
    kb: int
    margin: float      # exact rational relative margin of the flip
    is_tie: bool


def edges_from_ppm(path: str) -> np.ndarray:
    """Binary edge map from a reference IMTYPE_BINARY PPM dump: the writer
    maps 1 -> 0 (black) and everything else -> 255 (src/image.c:45)."""
    return (read_ppm(path) == 0).astype(np.uint8)


def classify_edge_diffs(
    brightness: np.ndarray,
    ref_edges: np.ndarray,
    our_edges: np.ndarray,
    threshold: str,
    mode: BoundaryMode,
) -> List[EdgeDiff]:
    """Analyze every pixel where the two edge maps differ.

    For each differing pixel, recompute all four directional predicates in
    (a) the C double operation order (src/stereo.c:16-70) and (b) the
    exact-rule f32 form, verify they reproduce the respective maps'
    decisions, and measure the exact rational margin of every flipped
    operator against the decimal threshold (an exact Fraction).
    """
    p = _pad_for_stencil(brightness, mode, np.dtype(np.float64))
    k = np.rint(p * 256.0).astype(np.int64)
    t_frac = Fraction(threshold)
    thr64 = np.float64(float(threshold))
    thr32 = np.float32(float(threshold))
    out: List[EdgeDiff] = []
    for y, x in np.argwhere(ref_edges != our_edges):
        y, x = int(y), int(x)

        def nb(arr, dx: int, dy: int):
            return arr[1 + dy + y, 1 + dx + x]

        c_or = False
        e_or = False
        flips: List[Tuple[int, int, int, float]] = []
        for oi, (sa, sb) in enumerate(_EDGE_OPERATORS):
            ka = int(nb(k, *sa[0]) + nb(k, *sa[1]) + nb(k, *sa[2]))
            kb = int(nb(k, *sb[0]) + nb(k, *sb[1]) + nb(k, *sb[2]))
            # C double order: ((a+b)+c)/3, /2, clamp (src/stereo.c:21-27).
            avg_a = (nb(p, *sa[0]) + nb(p, *sa[1]) + nb(p, *sa[2])) / 3.0
            avg_b = (nb(p, *sb[0]) + nb(p, *sb[1]) + nb(p, *sb[2])) / 3.0
            bound = min(max(thr64 * ((avg_a + avg_b) / 2.0), 0.0), 1.0)
            c_fire = bool(abs(avg_a - avg_b) > bound)
            # Exact rule (oracle/pipeline.py:_find_edges_exact).
            e_lhs = np.float32(2 * abs(ka - kb))
            e_rhs = min(thr32 * np.float32(ka + kb), np.float32(1536.0))
            e_fire = bool(e_lhs > e_rhs)
            c_or |= c_fire
            e_or |= e_fire
            if c_fire != e_fire:
                rhs_true = min(t_frac * (ka + kb), Fraction(1536))
                gap = abs(Fraction(2 * abs(ka - kb)) - rhs_true)
                margin = float(gap / rhs_true) if rhs_true else float(gap)
                flips.append((oi, ka, kb, margin))
        if c_or != bool(ref_edges[y, x]) or e_or != bool(our_edges[y, x]):
            raise AssertionError(
                f"predicate recomputation disagrees with the dumped maps at "
                f"({y},{x}): C={c_or} ref={ref_edges[y, x]} "
                f"exact={e_or} ours={our_edges[y, x]} — the divergence is "
                f"NOT an edge-rule knife edge"
            )
        if not flips:
            raise AssertionError(
                f"maps differ at ({y},{x}) but no operator decision flips "
                f"between the C and exact rules"
            )
        worst = max(flips, key=lambda f: f[3])
        out.append(
            EdgeDiff(
                y, x, worst[0], worst[1], worst[2], worst[3],
                is_tie=all(m <= TIE_MARGIN for (_, _, _, m) in flips),
            )
        )
    return out


def gate_pair(
    ref_dir: str,
    our_dir: str,
    img1: str,
    img2: str,
    threshold: str,
    params: StereoParams,
    max_frac: float,
    verbose: bool = True,
) -> Tuple[int, int]:
    """Run both gates; returns (n_knife_edge_pixels, n_downstream_ok).

    Raises AssertionError with a diagnostic on any failure.
    """
    n_tie = 0
    our_edges = {}
    for name, img_path in (("edges-1", img1), ("edges-2", img2)):
        ref_e = edges_from_ppm(os.path.join(ref_dir, f"{name}.ppm"))
        our_e = edges_from_ppm(os.path.join(our_dir, f"{name}.ppm"))
        our_edges[name] = our_e
        br = to_brightness(read_png_gray(img_path), np.float64)
        diffs = classify_edge_diffs(br, ref_e, our_e, threshold, params.mode)
        bad = [d for d in diffs if not d.is_tie]
        if bad:
            d = bad[0]
            raise AssertionError(
                f"{name}: {len(bad)} differing pixel(s) are NOT knife-edge "
                f"ties — first at ({d.y},{d.x}) op{d.op} ka={d.ka} "
                f"kb={d.kb} rational margin {d.margin:.3e} > {TIE_MARGIN:.1e}"
            )
        bound = max(8, int(np.ceil(max_frac * ref_e.size)))
        if len(diffs) > bound:
            raise AssertionError(
                f"{name}: {len(diffs)} knife-edge pixels exceed the bound "
                f"{bound} ({max_frac:g} of {ref_e.size} px)"
            )
        n_tie += len(diffs)
        if verbose and diffs:
            coords = ", ".join(f"({d.y},{d.x})" for d in diffs)
            print(
                f"  {name}: {len(diffs)} knife-edge tie(s) proven "
                f"(margin<= {max(d.margin for d in diffs):.1e}): {coords}"
            )

    seeded = oracle.run_pipeline_from_edges(
        our_edges["edges-1"], our_edges["edges-2"], params
    )
    n_ok = 0
    for name in DOWNSTREAM:
        key = "score_best" if name == "score_best-0" else name
        want = ppm_bytes(np.asarray(seeded[key]), artifact_ppm_type(name))
        with open(os.path.join(our_dir, f"{name}.ppm"), "rb") as f:
            got = f.read()
        if want != got:
            raise AssertionError(
                f"{name}: tier artifact differs from the C-semantics oracle "
                f"seeded with the tier's own edges — downstream arithmetic "
                f"is NOT bit-equivalent to the reference"
            )
        n_ok += 1
    return n_tie, n_ok


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ref_dir")
    ap.add_argument("our_dir")
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("--mode", choices=["wrap", "ghost"], default="wrap")
    ap.add_argument("--threshold", default="0.15",
                    help="decimal string, kept exact as a Fraction")
    ap.add_argument("--square-width", type=int, default=21)
    ap.add_argument("--times", type=int, default=32)
    ap.add_argument("--lines", type=int, default=10)
    ap.add_argument("--shifts", type=int, default=30)
    ap.add_argument("--max-frac", type=float, default=2e-4,
                    help="max knife-edge pixels as a fraction of the image")
    args = ap.parse_args(argv)

    params = StereoParams(
        threshold=float(args.threshold),
        square_width=args.square_width,
        times=args.times,
        lines=args.lines,
        num_shifts=args.shifts,
        mode=BoundaryMode(args.mode),
        edge_rule="exact",
    )
    try:
        n_tie, n_ok = gate_pair(
            args.ref_dir, args.our_dir, args.image1, args.image2,
            args.threshold, params, args.max_frac,
        )
    except AssertionError as e:
        print(f"KNIFE-EDGE GATE FAILED [{args.mode}]: {e}", file=sys.stderr)
        return 1
    print(
        f"OK [{args.mode}]: {n_tie} edge diff(s), all proven rational ties; "
        f"{n_ok}/{len(DOWNSTREAM)} downstream artifacts byte-identical to "
        f"the C-semantics oracle seeded with the tier's edges"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
