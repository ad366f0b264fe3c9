"""Edge extraction (counterpart of ``stereomatching_tpu/ops/edges.py``;
reference ``find_all_edges``, src/stereo.c:16-84).

Four directional 3-pixel-strip mean comparisons with an adaptive
threshold, OR-combined into a binary int32 edge map.  All functions take
[..., H, W]; leading batch dims pass through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.config import GHOST_BRIGHTNESS_FILL, BoundaryMode
from stereomatching_tpu_torch.ops.aggregate import wrap_pad

# (side_a offsets, side_b offsets) as (dx, dy), C summation order preserved
# (src/stereo.c:16-70).
EDGE_OPERATORS = (
    (((-1, -1), (-1, 0), (-1, 1)), ((1, -1), (1, 0), (1, 1))),  # left_right
    (((-1, -1), (0, -1), (1, -1)), ((-1, 1), (0, 1), (1, 1))),  # top_bottom
    (((-1, -1), (0, -1), (-1, 0)), ((1, 0), (0, 1), (1, 1))),  # upleft_downright
    (((-1, 1), (0, 1), (-1, 0)), ((0, -1), (1, -1), (1, 0))),  # downleft_upright
)


def pad_brightness(brightness: torch.Tensor, mode: BoundaryMode) -> torch.Tensor:
    """1-px pad: modulo wrap (src/util.h:42-47) or the ghost programs'
    128.0-filled halo (src/stereo-ghost.c:384-385)."""
    if mode == BoundaryMode.WRAP:
        return wrap_pad(brightness, 1)
    return F.pad(brightness, (1, 1, 1, 1), value=GHOST_BRIGHTNESS_FILL)


def find_edges(
    brightness: torch.Tensor,
    threshold: float,
    mode: BoundaryMode = BoundaryMode.WRAP,
    rule: str = "reference",
) -> torch.Tensor:
    """Binary edge map, int32 {0,1}, shape [..., H, W].

    ``rule="reference"`` runs float ops in ``brightness.dtype`` with the
    C operation order; ``rule="exact"`` runs the rescaled integer
    predicate 2*|ka-kb| > min(f32(threshold)*(ka+kb), 1536)
    (config.StereoParams.edge_rule)."""
    return find_edges_padded(pad_brightness(brightness, mode), threshold, rule)


def _taps(p: torch.Tensor):
    h, w = p.shape[-2] - 2, p.shape[-1] - 2

    def nb(dx: int, dy: int) -> torch.Tensor:
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    return nb


def find_edges_padded(
    p: torch.Tensor, threshold: float, rule: str = "reference"
) -> torch.Tensor:
    """Edge map from an already 1-px-padded brightness array."""
    if rule == "exact":
        return _find_edges_padded_exact(p, threshold)
    if rule != "reference":
        raise ValueError("rule must be 'reference' or 'exact'")
    nb = _taps(p)

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=p.dtype, device=p.device)

    thr, three, two = const(threshold), const(3.0), const(2.0)
    edges = torch.zeros(nb(0, 0).shape, dtype=torch.bool, device=p.device)
    for (a0, a1, a2), (b0, b1, b2) in EDGE_OPERATORS:
        avg_a = (nb(*a0) + nb(*a1) + nb(*a2)) / three
        avg_b = (nb(*b0) + nb(*b1) + nb(*b2)) / three
        overall = (avg_a + avg_b) / two
        bound = torch.clamp(thr * overall, 0.0, 1.0)
        edges |= (avg_a - avg_b).abs() > bound
    return edges.to(torch.int32)


def _find_edges_padded_exact(p: torch.Tensor, threshold: float) -> torch.Tensor:
    """The 'exact' rule: integer 3-pixel sums of k = round(brightness*256)
    (round half to even), decision 2*|ka-kb| > min(f32(threshold)*(ka+kb),
    1536).  ka+kb < 2^18 is exact in float32 and the single IEEE multiply
    rounds identically on every backend."""
    nb = _taps(torch.round(p * 256.0).to(torch.int32))
    t32 = torch.tensor(threshold, dtype=torch.float32, device=p.device)
    cap = torch.tensor(1536.0, dtype=torch.float32, device=p.device)
    edges = torch.zeros(nb(0, 0).shape, dtype=torch.bool, device=p.device)
    for (a0, a1, a2), (b0, b1, b2) in EDGE_OPERATORS:
        ka = nb(*a0) + nb(*a1) + nb(*a2)
        kb = nb(*b0) + nb(*b1) + nb(*b2)
        lhs = (2 * (ka - kb).abs()).to(torch.float32)
        rhs = torch.minimum(t32 * (ka + kb).to(torch.float32), cap)
        edges |= lhs > rhs
    return edges.to(torch.int32)
