"""The classic pipeline (counterpart of ``stereomatching_tpu/models/
classic.py``; the reference's ``algorithm()``, src/stereo.c:287-333):
edges -> per-shift match + box score + argmax -> diffusion -> contour,
in both boundary modes, on one pair [H, W] or a batch [B, H, W].

With ``edge_rule="exact"`` the first phases run as ``match_score_edges``
and the diffusion as ``fill_web_holes_range``: the CUDA kernels on CUDA
tensors, their plain torch versions on CPU tensors.  The
``"reference"`` edge rule runs its float edges and the scoring loop as
plain torch on every device.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from stereomatching_tpu_torch.config import StereoParams
from stereomatching_tpu_torch.ops.argmax import match_and_score
from stereomatching_tpu_torch.ops.contour import contour_bands
from stereomatching_tpu_torch.ops.edges import find_edges
from stereomatching_tpu_torch.ops.fused import match_score_edges
from stereomatching_tpu_torch.ops.fused_diffusion import fill_web_holes_range

Artifacts = Dict[str, torch.Tensor]


def classic_finish(winner: torch.Tensor, params: StereoParams) -> Artifacts:
    """The finishing phases alone — diffusion + contour from a post-argmax
    winner web [H, W] or [B, H, W].  The resume entry point: a saved
    ``web-1`` checkpoint fed back through these phases gives the same
    artifacts as the uninterrupted run (they are pure integer functions
    of the winner web)."""
    web, min_e, max_e = fill_web_holes_range(winner, params.times)
    return {
        "web-2": web,
        "output-0": contour_bands(web, params.lines, min_e, max_e),
        "min_elevation": min_e,
        "max_elevation": max_e,
    }


def _forward(left: torch.Tensor, right: torch.Tensor, params: StereoParams) -> Artifacts:
    if params.edge_rule == "exact":
        best, winner, edges_l, edges_r = match_score_edges(left, right, params)
    else:
        edges_l = find_edges(left, params.threshold, params.mode, params.edge_rule)
        edges_r = find_edges(right, params.threshold, params.mode, params.edge_rule)
        best, winner = match_and_score(edges_l, edges_r, params)
    return {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        **classic_finish(winner, params),
    }


def classic_forward(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams
) -> Artifacts:
    """Full pipeline on one brightness pair [H, W] -> artifact dict (int32
    planes, int32 scalar min/max elevation)."""
    if left.ndim != 2:
        raise ValueError(f"classic_forward takes [H, W], got {tuple(left.shape)}")
    return _forward(left, right, params)


def classic_forward_batched(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams
) -> Artifacts:
    """Batched pipeline [B, H, W] -> artifact dict (int32 planes [B, H, W],
    per-pair min/max elevation [B])."""
    if left.ndim != 3:
        raise ValueError(
            f"classic_forward_batched takes [B, H, W], got {tuple(left.shape)}"
        )
    return _forward(left, right, params)


class ClassicPipeline(nn.Module):
    """The classic pipeline as a module with no parameters: ``forward(left,
    right)`` takes float brightness in [0, 1), [H, W] or [B, H, W], and
    returns the artifact dict on the inputs' device."""

    def __init__(self, params: StereoParams):
        super().__init__()
        self.params = params

    @torch.no_grad()
    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Artifacts:
        if left.shape != right.shape:
            raise ValueError("the two images must have equal width and height")
        h, w = left.shape[-2:]
        self.params.validate_for_image(w, h)
        return _forward(left, right, self.params)


def build_classic_pipeline(params: StereoParams) -> ClassicPipeline:
    """The pipeline for fixed params, in eval mode."""
    return ClassicPipeline(params).eval()
