"""The classic route on the C reference's own settings: wrap-around
boundaries and the reference edge rule, so that the edges run as torch
float32 ops before the match (``ClassicPipeline.forward`` with
``edge_rule="reference"``).  The program, its input format and the plain
reference are ``routes/classic.py``'s; the work model charges the
reference rule's stages: ``edges``, ``match`` on two int32 edge maps,
``diffusion`` and ``contour``."""

from __future__ import annotations

from typing import Dict

from stereobench import workmodel
from stereobench.routes.classic import (  # noqa: F401  (the route's entries)
    PLANES, SIGN, inputs, max_shift, program, reference, reference_block)

# The reference rule's operations per pixel and view (``ops/edges.py``,
# the C predicate, src/stereo.c:16-70), each operator: two 3-tap sums
# (4 adds), their two divides by 3, the mean's add and divide by 2, the
# multiply by the threshold, the clamp to [0, 1] (2), the difference, its
# absolute value, the compare and the OR into the map: 15; four operators
# and the map's conversion to int32.  A divide counts as one operation.
EDGE_OPS = 4 * 15 + 1


def edges_work(npix: int) -> workmodel.Work:
    """Both views' edges: each view's float32 brightness in and its int32
    edge map out (16 B per pixel of the pair); ``EDGE_OPS`` per pixel and
    view at the unfused float32 rate."""
    return 16 * npix, 2 * EDGE_OPS * npix, workmodel.FP32_UNFUSED_OPS_PER_S


def match_work(npix: int, d: int) -> workmodel.Work:
    """Per-shift match, box score and argmax on the two edge maps (K8's
    function): two int32 maps in, best and winner out (16 B per pixel);
    ``LOOP_OPS`` per pixel and shift."""
    return 16 * npix, workmodel.LOOP_OPS * npix * d, workmodel.INT32_OPS_PER_S


def stages(params: Dict, h: int, w: int) -> Dict[str, workmodel.Work]:
    """Per-pair work of the reference rule's stages, by span name."""
    npix = h * w
    return {"edges": edges_work(npix),
            "match": match_work(npix, params["num_shifts"]),
            "diffusion": workmodel.diffusion_work(npix, params["times"]),
            "contour": workmodel.contour_work(npix)}
