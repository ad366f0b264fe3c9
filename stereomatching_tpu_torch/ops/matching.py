"""Shift matching (counterpart of ``stereomatching_tpu/ops/matching.py``;
reference ``fillup_matches``, src/stereo.c:113-127).

``matches[i][y, x] = (left[y, x] == right[y, x+i])`` — the x+i read wraps
modulo width in wrap mode (src/stereo.c:120) or reads the zero-filled
``num_shifts``-wide edge halo in ghost mode (src/stereo-ghost.c:119-121).
The right edge map is extended once to width W + num_shifts; each shift
is then a plain slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.config import BoundaryMode


def extend_right_edges(
    right_edges: torch.Tensor, num_shifts: int, mode: BoundaryMode
) -> torch.Tensor:
    """[..., H, W] -> [..., H, W + num_shifts] with wrap-around columns
    (also for num_shifts > W) or the ghost halo's zeros appended."""
    w = right_edges.shape[-1]
    if mode == BoundaryMode.WRAP:
        reps = -(-num_shifts // w) + 1
        return torch.cat([right_edges] * reps, dim=-1)[..., : w + num_shifts]
    return F.pad(right_edges, (0, num_shifts))


def match_plane(
    left_edges: torch.Tensor, right_ext: torch.Tensor, shift: int
) -> torch.Tensor:
    """Single-shift match plane, int32 {0,1}.  Equality, not AND: two
    non-edge pixels also match (src/stereo.c:122-123)."""
    w = left_edges.shape[-1]
    return (left_edges == right_ext[..., shift : shift + w]).to(torch.int32)
