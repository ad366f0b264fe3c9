"""The classic pipeline (counterpart of ``stereomatching_tpu/models/
classic.py``; the reference's ``algorithm()``, src/stereo.c:287-333):
edges -> per-shift match + box score + argmax -> diffusion -> contour,
in both boundary modes, on one pair [H, W] or a batch [B, H, W].

With ``edge_rule="exact"`` the first phases run as ``match_score_edges``
(K1); with the ``"reference"`` rule the float edges of both views run as
``reference_edges`` (K11) and the scoring loop as ``match_and_score``
(K8).  The diffusion runs as ``fill_web_holes_range`` (K2).  Each is the
CUDA kernel on CUDA tensors and its plain torch version on CPU tensors.
``subpixel`` adds the parabola-refined float32 ``"subpixel"`` artifact
on both rules.

Which kernel-backed stage runs its plain version on the CUDA device is
decided from the config alone, before any launch
(``classic_kernels_supported``, the port's counterpart of the JAX
package's dispatch by config): a square width above 255, or a tile that
needs more shared memory than a block has, runs the matching stage as
plain torch ops on the device.  The kernels themselves still refuse such
configs; nothing catches a launch error.

The collect pipeline also returns the per-shift planes the reference
dumps in its debug builds.  No kernel produces those planes (the JAX
package builds them on XLA only), so its scoring loop is plain torch on
every device; its diffusion runs as K2 like the other routes.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch import nn

from stereomatching_tpu_torch.config import StereoParams
from stereomatching_tpu_torch.ops.argmax import match_and_score_collect
from stereomatching_tpu_torch.ops.contour import contour_bands
from stereomatching_tpu_torch.ops.edges import find_edges
from stereomatching_tpu_torch.ops.fused import (
    kernel_refusal, match_and_score, match_and_score_reference, match_score_edges,
    match_score_edges_reference)
from stereomatching_tpu_torch.ops.fused_diffusion import (
    fill_web_holes_range, fill_web_holes_range_reference)
from stereomatching_tpu_torch.ops.fused_edges import reference_edges, reference_edges_reference
from stereomatching_tpu_torch.utils import tracing

Artifacts = Dict[str, torch.Tensor]


def classic_finish(
    winner: torch.Tensor, params: StereoParams, value_bound: Optional[int] = None
) -> Artifacts:
    """The finishing phases alone — diffusion + contour from a post-argmax
    winner web [H, W] or [B, H, W].  The resume entry point: a saved
    ``web-1`` checkpoint fed back through these phases gives the same
    artifacts as the uninterrupted run (they are pure integer functions
    of the winner web).  ``value_bound``: a caller-proven exclusive upper
    bound on the web's values (``fill_web_holes_range``'s); the pipelines
    pass ``num_shifts + 1`` for the winner plane they computed, the resume
    path ``None`` (a web read from a file proves nothing)."""
    return _finish(*fill_web_holes_range(winner, params.times, value_bound), params)


def _finish(web, min_e, max_e, params: StereoParams) -> Artifacts:
    return {
        "web-2": web,
        "output-0": contour_bands(web, params.lines, min_e, max_e),
        "min_elevation": min_e,
        "max_elevation": max_e,
    }


def winner_bound(params: StereoParams) -> int:
    """The exclusive upper bound of a winner plane the matchers computed:
    its values lie in [0, num_shifts] (``ops/argmax.py``; the JAX
    package's ``value_bound``, ``stereomatching_tpu/models/classic.py``)."""
    return params.num_shifts + 1


def _match_stage(params: StereoParams, sharded: bool = False) -> str:
    """The kernel of the classic pipeline's matching stage: K9 on the
    sharded tier, else K1 (exact rule) or K8 (reference rule)."""
    if sharded:
        return "match_and_score_prehalo"
    return "match_score_edges" if params.edge_rule == "exact" else "match_and_score"


def classic_kernels_supported(params: StereoParams, sharded: bool = False):
    """-> (ok, why): whether the matching stage's CUDA kernel (K1 or K8,
    with ``sharded`` K9) takes ``params``; when it does not, that stage
    runs its plain torch version on the CUDA device and ``why`` names the
    stage and the reason.  The diffusion (K2) takes every config.
    Decided from the config alone, before any launch."""
    stage = _match_stage(params, sharded)
    why = kernel_refusal(params)
    return (True, "") if not why else (False, f"{stage}: {why}")


def plain_stages(params: StereoParams, sharded: bool = False) -> Dict[str, str]:
    """{stage: why} of the stages ``params``' route runs as plain torch
    ops on the CUDA device (``classic_kernels_supported``)."""
    ok, why = classic_kernels_supported(params, sharded)
    return {} if ok else {_match_stage(params, sharded): why}


def _match_fn(params: StereoParams, plain: bool = False) -> Callable:
    """The single-device matching stage of ``params``: K1's or K8's
    wrapper, or its plain version with ``plain`` or where the kernel does
    not take the config."""
    kernel = not plain and classic_kernels_supported(params)[0]
    if params.edge_rule == "exact":
        return match_score_edges if kernel else match_score_edges_reference
    return match_and_score if kernel else match_and_score_reference


def _edges(left: torch.Tensor, right: torch.Tensor, params: StereoParams,
           plain: bool = False):
    """Both views' edge maps: on the reference rule K11's wrapper, or its
    plain version with ``plain``; on the exact rule (the collect
    pipeline's; the other routes take them from K1) ``find_edges``."""
    if params.edge_rule == "reference":
        edges = reference_edges_reference if plain else reference_edges
        return edges(left, right, params.threshold, params.mode)
    return tuple(find_edges(x, params.threshold, params.mode, params.edge_rule)
                 for x in (left, right))


def _forward(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams, subpixel: bool,
    plain: bool = False,
) -> Artifacts:
    """The routes' forward, one ``forward`` span with a stage a phase:
    ``edges`` (reference rule), ``match``, ``diffusion``, ``contour``."""
    with tracing.span("forward", left):
        if not plain and tracing.on():
            for stage in plain_stages(params):
                tracing.count(f"plain_stage.{stage}")
        match = _match_fn(params, plain)
        if params.edge_rule == "exact":
            tracing.stage("match")
            best, winner, edges_l, edges_r, *sub = match(left, right, params, subpixel)
        else:
            tracing.stage("edges")
            edges_l, edges_r = _edges(left, right, params, plain)
            tracing.stage("match")
            best, winner, *sub = match(edges_l, edges_r, params, subpixel)
        tracing.stage("diffusion")
        diffused = (fill_web_holes_range_reference(winner, params.times) if plain
                    else fill_web_holes_range(winner, params.times, winner_bound(params)))
        tracing.stage("contour")
        out = {
            "edges-1": edges_l,
            "edges-2": edges_r,
            "score_best": best,
            "web-1": winner,
            **_finish(*diffused, params),
        }
    if subpixel:
        out["subpixel"] = sub[0]
    return out


def classic_forward(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams, subpixel: bool = False
) -> Artifacts:
    """Full pipeline on one brightness pair [H, W] -> artifact dict (int32
    planes, int32 scalar min/max elevation; with ``subpixel`` also the
    float32 ``"subpixel"`` plane)."""
    if left.ndim != 2:
        raise ValueError(f"classic_forward takes [H, W], got {tuple(left.shape)}")
    return _forward(left, right, params, subpixel)


def classic_forward_batched(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams, subpixel: bool = False
) -> Artifacts:
    """Batched pipeline [B, H, W] -> artifact dict (int32 planes [B, H, W],
    per-pair min/max elevation [B]; with ``subpixel`` the float32
    ``"subpixel"`` planes)."""
    if left.ndim != 3:
        raise ValueError(
            f"classic_forward_batched takes [B, H, W], got {tuple(left.shape)}"
        )
    return _forward(left, right, params, subpixel)


def classic_forward_reference(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams, subpixel: bool = False
) -> Artifacts:
    """``classic_forward_batched`` (or ``classic_forward``) through the
    kernels' plain versions on any device, [H, W] or [B, H, W]: what the
    kernel route is held to on the card (the counterpart of
    ``models.modern.modern_forward_reference``)."""
    if left.ndim not in (2, 3):
        raise ValueError(f"need [H, W] or [B, H, W], got {tuple(left.shape)}")
    return _forward(left, right, params, subpixel, plain=True)


class ClassicPipeline(nn.Module):
    """The classic pipeline as a module with no parameters: ``forward(left,
    right)`` takes float brightness in [0, 1), [H, W] or [B, H, W], and
    returns the artifact dict on the inputs' device (with ``subpixel``,
    the ``"subpixel"`` plane too)."""

    def __init__(self, params: StereoParams, subpixel: bool = False):
        super().__init__()
        self.params = params
        self.subpixel = subpixel

    @torch.no_grad()
    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Artifacts:
        if left.shape != right.shape:
            raise ValueError("the two images must have equal width and height")
        h, w = left.shape[-2:]
        self.params.validate_for_image(w, h)
        return _forward(left, right, self.params, self.subpixel)


def build_classic_pipeline(params: StereoParams, subpixel: bool = False) -> ClassicPipeline:
    """The pipeline for fixed params, in eval mode."""
    return ClassicPipeline(params, subpixel).eval()


def build_classic_finish_pipeline(params: StereoParams) -> Callable[[torch.Tensor], Artifacts]:
    """``classic_finish`` for fixed params (the CLI's ``--resume``), with
    no bound on the web's values: K2 stores it as int32."""
    return torch.no_grad()(functools.partial(classic_finish, params=params, value_bound=None))


def build_classic_collect_pipeline(
    params: StereoParams,
) -> Callable[[torch.Tensor, torch.Tensor], Artifacts]:
    """The artifact-collecting pipeline: besides the classic artifacts,
    the stacked per-shift planes ``matches``, ``score_all`` and
    ``scores`` ([D, H, W], or [B, D, H, W] for a batch) that the
    reference dumps in its debug builds.  The scoring loop
    (``match_and_score_collect``) is plain torch on every device, as no
    kernel produces the per-shift planes; the finish is
    ``classic_finish`` (K2 on CUDA tensors)."""

    @torch.no_grad()
    def forward(left: torch.Tensor, right: torch.Tensor) -> Artifacts:
        edges_l, edges_r = _edges(left, right, params)
        matches, sums, scores, best, winner = match_and_score_collect(
            edges_l, edges_r, params)
        return {
            "edges-1": edges_l,
            "edges-2": edges_r,
            "matches": matches,
            "score_all": sums,
            "scores": scores,
            "score_best": best,
            "web-1": winner,
            **classic_finish(winner, params, winner_bound(params)),
        }

    return forward
