"""Per-shift scoring + disparity argmax (counterpart of
``stereomatching_tpu/ops/argmax.py``; reference ``fillup_matches`` +
``fillup_scores`` + ``find_highest_scoring_shifts``, src/stereo.c:
113-220), one pass over the shifts carrying only (best, winner); the
sub-pixel variant also carries the winner's neighbour scores, and the
collect variant stacks the per-shift planes.

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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (match plane, its box sums, score): the score is the box sum
    where the shift matched, else 0 (record_score, src/stereo.c:172-182)."""
    match = match_plane(left_edges, right_ext, shift)
    sums = box_sum_padded(pad_plane(match, half, mode), half)
    return match, sums, torch.where(match == 1, sums, 0)


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
        score = score_for_shift(left_edges, right_ext, i, params.half, params.mode)[2]
        winner = torch.where(score >= best, i + 1, winner)
        best = torch.maximum(best, score)
    return best, winner


def match_and_score_subpixel(
    left_edges: torch.Tensor,
    right_edges: torch.Tensor,
    params: StereoParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``match_and_score`` plus the parabola refine on the scores around
    the winner (an extension beyond the reference) -> (best int32, winner
    int32, subpixel float32) with subpixel = winner + offset, offset in
    [-0.5, 0.5] and 0 where a neighbour score is missing (-1: the winner
    at either end) or the triple is not strictly concave.  best and
    winner equal ``match_and_score``'s."""
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    zeros = torch.zeros(left_edges.shape, dtype=torch.int32, device=left_edges.device)
    missing = torch.full_like(zeros, -1)  # scores are >= 0
    best, winner, was_new = zeros, zeros, zeros.bool()
    s_left = s_right = s_prev = missing
    for i in range(params.num_shifts):
        score = score_for_shift(left_edges, right_ext, i, params.half, params.mode)[2]
        # The step after a (re-)selection supplies its right neighbour.
        s_right = torch.where(was_new, score, s_right)
        is_new = score >= best
        best = torch.maximum(best, score)
        winner = torch.where(is_new, i + 1, winner)
        s_left = torch.where(is_new, s_prev, s_left)
        s_right = torch.where(is_new, missing, s_right)
        s_prev, was_new = score, is_new
    sl, sm, sr = (x.to(torch.float32) for x in (s_left, best, s_right))
    denom = sl - 2.0 * sm + sr
    valid = (s_left >= 0) & (s_right >= 0) & (denom < 0)
    offset = torch.where(valid, (sl - sr) / torch.where(valid, 2.0 * denom, 1.0), 0.0)
    return best, winner, winner.to(torch.float32) + offset.clamp(-0.5, 0.5)


def match_and_score_collect(
    left_edges: torch.Tensor,
    right_edges: torch.Tensor,
    params: StereoParams,
) -> Tuple[torch.Tensor, ...]:
    """``match_and_score`` that also stacks the per-shift planes the
    reference dumps in its debug builds (matches-i, score_all-i,
    scores-i; src/stereo.c:302-313) -> (matches, sums, scores, best,
    winner): the three stacks int32 [..., D, H, W], best and winner int32
    [..., H, W]."""
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    best = torch.zeros(left_edges.shape, dtype=torch.int32, device=left_edges.device)
    winner = torch.zeros_like(best)
    planes = []
    for i in range(params.num_shifts):
        match, sums, score = score_for_shift(
            left_edges, right_ext, i, params.half, params.mode)
        winner = torch.where(score >= best, i + 1, winner)
        best = torch.maximum(best, score)
        planes.append((match, sums, score))
    matches, sums, scores = (torch.stack(p, dim=-3) for p in zip(*planes))
    return matches, sums, scores, best, winner
