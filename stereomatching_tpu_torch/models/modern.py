"""The modern pipeline's SGM route (counterpart of
``stereomatching_tpu/models/modern.py``, ``aggregation="sgm"``,
``scales=1``): census or SAD per-pixel costs -> cost volume -> 4-path
semi-global aggregation -> argmin + sub-pixel + right-view disparity
(+ uniqueness) -> optional 3x3 median -> LR consistency -> hole fill.

Inputs are integer pixel planes 0..255, [H, W] or [B, H, W].  The
volume, the paths, the tail and the diffusion fill run as
``sgm_volume`` / ``sgm_directional`` / ``sgm_tail`` (``ops/fused_sgm.py``)
and ``fill_invalid`` (``ops/fused_diffusion.py``): the CUDA kernels on
CUDA tensors, their plain torch versions on CPU tensors.  The census
transform, the uniqueness ratio, the median, the LR check and the
background fill are torch ops on every device.

Storage: the volume and the aggregate take the narrowest integer type
that holds every value (``_sgm_storage_dtype``, ``_sgm_out_dtype``);
the outputs are the same bits whatever storage is chosen.  Not ported
yet: ``aggregation="box"`` (Pallas K7), ``scales=2`` and
``sgm_directions=8``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.ops import costvolume, fused_diffusion, fused_sgm, sgm

Outputs = Dict[str, torch.Tensor]


class _Route(NamedTuple):
    """The four kernel-backed stages of the route."""

    volume: Callable
    aggregate: Callable
    tail: Callable
    fill_invalid: Callable


_KERNELS = _Route(
    fused_sgm.sgm_volume,
    fused_sgm.sgm_aggregate_paths,
    fused_sgm.sgm_tail,
    fused_diffusion.fill_invalid,
)
_PLAIN = _Route(
    fused_sgm.sgm_volume_reference,
    lambda vol, p1, p2, out_dtype: sgm.sgm_aggregate(vol, p1, p2).to(out_dtype),
    fused_sgm.sgm_tail_reference,
    fused_diffusion.fill_invalid_reference,
)


def _sgm_cost_bound(params: ModernParams) -> int:
    """Per-pixel cost ceiling of the SGM volume: census Hamming distance
    is at most the code's bit count (window^2 - 1), SAD on 8-bit
    intensities at most 255; multi-scale fusion adds coarse_weight x the
    same bound."""
    base = (
        params.census_window * params.census_window - 1
        if params.cost == "census"
        else 255
    )
    if params.scales == 2:
        base *= 1 + params.coarse_weight
    return base


def _sgm_fits_int16(params: ModernParams) -> bool:
    """Whether every path value L <= max_cost + p2 stays under 16384."""
    return _sgm_cost_bound(params) + params.sgm_p2 < 16384


def _sgm_fits_int8(params: ModernParams) -> bool:
    """Whether the volume fits int8 storage under the JAX package's gate:
    L <= max_cost + p2 under 127 and D a power of two >= 32."""
    d = params.num_disparities
    return (
        _sgm_cost_bound(params) + params.sgm_p2 < 127
        and d >= 32
        and d == 1 << (d - 1).bit_length()
    )


def _sgm_storage_dtype(params: ModernParams) -> torch.dtype:
    """Narrowest exact storage of the cost volume: int8 > int16 > int32
    (the JAX package's gates, so both packages pick the same type)."""
    if _sgm_fits_int8(params):
        return torch.int8
    if _sgm_fits_int16(params):
        return torch.int16
    return torch.int32


def _sgm_out_dtype(params: ModernParams) -> torch.dtype:
    """Narrowest exact type of the aggregated path sum (at most
    directions * (max_cost + p2))."""
    bound = params.sgm_directions * (_sgm_cost_bound(params) + params.sgm_p2)
    return torch.int16 if bound < 2**15 else torch.int32


def _uniqueness_ratio(c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """Uniqueness confidence c2 / max(c1, 1) (>= 1; higher is more
    confident)."""
    return c2.to(torch.float32) / torch.clamp(c1.to(torch.float32), min=1.0)


def _maybe_median(disp, sub, dr, params: ModernParams):
    """The 3x3 median on the left disparity, sub-pixel and re-projected
    right planes, before LR consistency, when ``median_filter`` is on."""
    if not params.median_filter:
        return disp, sub, dr
    med = costvolume.median3x3
    return med(disp), med(sub), med(dr)


def _fill(sub, valid, params: ModernParams, fill_invalid: Callable):
    """Hole filling of LR-invalidated pixels, per ``fill_mode``."""
    if params.fill_mode == "background":
        return costvolume.fill_background(sub, valid)
    return fill_invalid(sub, valid, params.fill_iterations)


def _check_supported(params: ModernParams) -> None:
    if params.aggregation != "sgm":
        raise NotImplementedError(
            "the box route (aggregation='box', Pallas K7 disparity_pallas) "
            "is a later slice of the port")
    if params.scales != 1:
        raise NotImplementedError(
            "scales=2 (multi-scale cost fusion, an XLA-only route in the "
            "JAX package) is a later slice of the port")
    if params.sgm_directions != 4:
        raise NotImplementedError(
            "8-direction SGM (diagonal paths) is the next slice of the port")


def _sgm_forward(left, right, params: ModernParams, route: _Route) -> Outputs:
    _check_supported(params)
    codes = [x.to(torch.int32) for x in (left, right)]
    if params.cost == "census":
        codes = [costvolume.census_transform(x, params.census_window).contiguous()
                 for x in codes]
    vol = route.volume(*codes, params.num_disparities, params.cost,
                       _sgm_storage_dtype(params))
    agg = route.aggregate(vol, params.sgm_p1, params.sgm_p2, _sgm_out_dtype(params))
    del vol
    outs = route.tail(agg, params.uniqueness)
    del agg
    disp, sub, cost, dr = outs[:4]
    uniq = _uniqueness_ratio(outs[4], cost) if params.uniqueness else None
    disp, sub, dr = _maybe_median(disp, sub, dr, params)
    valid = costvolume.lr_consistency(disp, dr, params.lr_max_diff,
                                      params.num_disparities)
    out = {
        "disparity": disp,
        "subpixel": sub,
        "disparity_right": dr,
        "valid": valid,
        "filled": _fill(sub, valid, params, route.fill_invalid),
        "cost": cost,
    }
    if uniq is not None:
        out["uniqueness"] = uniq
    return out


def _check_inputs(left: torch.Tensor, right: torch.Tensor) -> None:
    if left.shape != right.shape:
        raise ValueError("the two images must have equal width and height")
    if left.ndim not in (2, 3):
        raise ValueError(f"need [H, W] or [B, H, W], got {tuple(left.shape)}")
    if left.is_floating_point() or right.is_floating_point():
        raise ValueError("modern_forward takes integer pixel planes 0..255")


def modern_forward(left: torch.Tensor, right: torch.Tensor, params: ModernParams) -> Outputs:
    """The SGM route on integer pixel planes [H, W] or [B, H, W] ->
    disparity (int32), subpixel (f32), disparity_right (int32), valid
    (bool, LR-consistent), filled (f32), cost (int32 at the winner), and
    uniqueness (f32) with ``params.uniqueness``; each [H, W] or
    [B, H, W] on the inputs' device."""
    _check_inputs(left, right)
    return _sgm_forward(left, right, params, _KERNELS)


def modern_forward_reference(
    left: torch.Tensor, right: torch.Tensor, params: ModernParams
) -> Outputs:
    """``modern_forward`` through the kernels' plain versions on any
    device (the int32 aggregate of ``ops.sgm.sgm_aggregate``, cast to
    the same storage): what the kernel route is held to on the card."""
    _check_inputs(left, right)
    return _sgm_forward(left, right, params, _PLAIN)


class ModernPipeline(nn.Module):
    """The modern pipeline (SGM route) as a module with no parameters:
    ``forward(left, right)`` takes integer pixels [H, W] or [B, H, W]
    and returns the output dict on the inputs' device."""

    def __init__(self, params: ModernParams):
        super().__init__()
        _check_supported(params)
        self.params = params

    @torch.no_grad()
    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Outputs:
        return modern_forward(left, right, self.params)


def build_modern_pipeline(params: ModernParams) -> ModernPipeline:
    """The pipeline for fixed params, in eval mode."""
    return ModernPipeline(params).eval()
