"""Per-shift scoring + disparity argmax (counterpart of
``stereomatching_tpu/ops/argmax.py``; reference ``fillup_matches`` +
``fillup_scores`` + ``find_highest_scoring_shifts``, src/stereo.c:
113-220), one pass over the shifts carrying only (best, winner).

The single-pass update keeps the reference's two-pass last-wins tie rule:
updating on ``score >= best`` sets winner = i+1 for the LAST i whose
score equals the global best (src/stereo.c:211-219).  Scores are >= 0
and best starts at 0, so all-zero scores give winner = num_shifts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.ops.aggregate import box_sum_padded, pad_plane
from stereomatching_tpu_torch.ops.matching import extend_right_edges, match_plane


def score_for_shift(
    left_edges: torch.Tensor,
    right_ext: torch.Tensor,
    shift: int,
    half: int,
    mode: BoundaryMode,
) -> torch.Tensor:
    """The box sum of the shift's match plane where it matched, else 0
    (record_score, src/stereo.c:172-182)."""
    match = match_plane(left_edges, right_ext, shift)
    sums = box_sum_padded(pad_plane(match, half, mode), half)
    return torch.where(match == 1, sums, 0)


def match_and_score(
    left_edges: torch.Tensor,
    right_edges: torch.Tensor,
    params: StereoParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (best_scores, winning_shifts), both int32 [..., H, W]."""
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    best = torch.zeros(left_edges.shape, dtype=torch.int32, device=left_edges.device)
    winner = torch.zeros_like(best)
    for i in range(params.num_shifts):
        score = score_for_shift(left_edges, right_ext, i, params.half, params.mode)
        winner = torch.where(score >= best, i + 1, winner)
        best = torch.maximum(best, score)
    return best, winner
