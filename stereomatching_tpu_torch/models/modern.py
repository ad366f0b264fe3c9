"""The modern pipeline (counterpart of
``stereomatching_tpu/models/modern.py``), two routes:

* box (``aggregation="box"``, the default): for each reference view the
  per-pixel SAD or census cost, its window sum and the first-minimum
  argmin with parabola sub-pixel refine, fused in ``fused_modern.disparity``
  (K7, twice per forward);
* SGM (``aggregation="sgm"``): census or SAD per-pixel costs -> cost
  volume -> 4- or 8-path semi-global aggregation -> argmin + sub-pixel +
  right-view disparity (+ uniqueness).

Both then take the optional 3x3 median, the LR consistency check and the
hole fill.  Inputs are integer pixel planes 0..255, [H, W] or [B, H, W].
The box disparity, the SGM volume, paths and tail, and the diffusion fill
run as ``fused_modern.disparity``, ``sgm_volume`` / ``sgm_directional`` /
``sgm_tail`` (``ops/fused_sgm.py``) and ``fill_invalid``
(``ops/fused_diffusion.py``): the CUDA kernels on CUDA tensors, their
plain torch versions on CPU tensors.  The census transform, the
uniqueness ratio, the median, the LR check and the background fill are
torch ops on every device.  A stage whose kernel does not take the
config (K7 above window 255 or D 256, K4 above D 256) runs its plain
version on the CUDA device too, chosen before any launch by
``modern_kernels_supported``.

Multi-scale fusion (``scales=2``) adds ``coarse_weight`` x a cost of
disparity d // 2 computed on the 2x2-block-summed images, upsampled by
pixel repetition: on the box route the window-summed coarse cost (torch
ops on every device, as the JAX package runs it on XLA only), on the SGM
route the per-pixel coarse cost inside the volume, which torch ops build
in the storage dtype before the SGM kernels take over.

SGM storage: the volume and the aggregate take the narrowest integer
type that holds every value (``_sgm_storage_dtype``, ``_sgm_out_dtype``);
the outputs are the same bits whatever storage is chosen.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch import nn

from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.ops import (
    costvolume, fused_diffusion, fused_modern, fused_sgm, sgm)
from stereomatching_tpu_torch.ops.costvolume import DisparityResult
from stereomatching_tpu_torch.utils import tracing

Outputs = Dict[str, torch.Tensor]


class _Route(NamedTuple):
    """The kernel-backed stages of the two routes."""

    disparity: Callable
    volume: Callable
    aggregate: Callable
    tail: Callable
    fill_invalid: Callable


_KERNELS = _Route(
    fused_modern.disparity,
    fused_sgm.sgm_volume,
    fused_sgm.sgm_aggregate_paths,
    fused_sgm.sgm_tail,
    fused_diffusion.fill_invalid,
)
_PLAIN = _Route(
    fused_modern.disparity_reference,
    fused_sgm.sgm_volume_reference,
    lambda vol, p1, p2, out_dtype, directions: sgm.sgm_aggregate(
        vol, p1, p2, directions).to(out_dtype),
    fused_sgm.sgm_tail_reference,
    fused_diffusion.fill_invalid_reference,
)


# The kernel-backed stages each route runs.
_ROUTE_STAGES = {"box": ("disparity", "fill_invalid"),
                 "sgm": ("volume", "aggregate", "tail", "fill_invalid")}


def modern_kernels_supported(params: ModernParams) -> Dict[str, Tuple[bool, str]]:
    """-> {stage: (ok, why)} for each kernel-backed stage of ``_Route``:
    whether its CUDA kernel takes ``params``.  A stage that is not ok runs
    its plain torch version on the CUDA device, and ``why`` names the
    kernel and the reason: K7 (``disparity``) takes window <= 255 and
    D <= 256, K4 (``aggregate``, ``sgm_directional``) D <= 256; K3, K5
    and K6 take every config.  Decided from the config alone, before any
    launch (the counterpart of the JAX package's
    ``modern_pallas_supported``)."""
    d, window = params.num_disparities, params.window
    k7 = ""
    if window > fused_modern.MAX_WINDOW:
        k7 = f"disparity: window {window} > {fused_modern.MAX_WINDOW}"
    elif d > fused_modern.MAX_DISPARITIES:
        k7 = f"disparity: num_disparities {d} > {fused_modern.MAX_DISPARITIES}"
    k4 = ""
    if d > fused_sgm.MAX_DISPARITIES:
        k4 = f"sgm_directional: num_disparities {d} > {fused_sgm.MAX_DISPARITIES}"
    why = {"disparity": k7, "volume": "", "aggregate": k4, "tail": "", "fill_invalid": ""}
    return {stage: (not w, w) for stage, w in why.items()}


def plain_stages(params: ModernParams) -> Dict[str, str]:
    """{stage: why} of the stages ``params``' route runs as plain torch
    ops on the CUDA device (``modern_kernels_supported``)."""
    ok = modern_kernels_supported(params)
    return {s: ok[s][1] for s in _ROUTE_STAGES[params.aggregation] if not ok[s][0]}


def _route(params: ModernParams) -> _Route:
    """The route of ``params``: each stage's kernel wrapper, or its plain
    version where the kernel does not take the config."""
    ok = modern_kernels_supported(params)
    return _Route(*(getattr(_KERNELS if ok[f][0] else _PLAIN, f) for f in _Route._fields))


def _sgm_cost_bound(params: ModernParams) -> int:
    """Per-pixel cost ceiling of the SGM volume: census Hamming distance
    is at most the code's bit count (window^2 - 1), SAD on 8-bit
    intensities at most 255.  Multi-scale fusion adds coarse_weight x the
    coarse level's ceiling: the same bit count for census (codes of the
    summed image have as many bits), but 4 x 255 for SAD, since the
    coarse pixels are 2x2 sums."""
    census = params.cost == "census"
    base = params.census_window * params.census_window - 1 if census else 255
    if params.scales == 2:
        return base + params.coarse_weight * (base if census else 4 * 255)
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
    tracing.stage("median")
    med = costvolume.median3x3
    return med(disp), med(sub), med(dr)


def _fill(sub, valid, params: ModernParams, fill_invalid: Callable):
    """Hole filling of LR-invalidated pixels, per ``fill_mode``."""
    if params.fill_mode == "background":
        return costvolume.fill_background(sub, valid)
    return fill_invalid(sub, valid, params.fill_iterations)


def _cost_inputs(left, right, params: ModernParams):
    """int32 cost inputs of both images: the pixels for SAD, the census
    codes for census."""
    codes = [x.to(torch.int32) for x in (left, right)]
    if params.cost == "census":
        codes = [costvolume.census_transform(x, params.census_window).contiguous()
                 for x in codes]
    return codes


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 block sum of [..., H, W] (exact integers); an odd last row or
    column is replicated first."""
    h, w = img.shape[-2:]
    if h % 2 or w % 2:
        ys = torch.arange(h + h % 2, device=img.device).clamp(max=h - 1)
        xs = torch.arange(w + w % 2, device=img.device).clamp(max=w - 1)
        img = img[..., ys, :][..., xs]
    return (img[..., 0::2, 0::2] + img[..., 0::2, 1::2]
            + img[..., 1::2, 0::2] + img[..., 1::2, 1::2])


def _coarse_inputs(left, right, params: ModernParams):
    """The cost inputs of the 2x2-summed images (census codes are taken
    of the summed intensities) at ``scales=2``; None at ``scales=1``."""
    if params.scales != 2:
        return None
    return _cost_inputs(*(_downsample2(x.to(torch.int32)) for x in (left, right)),
                        params)


def _finish(disp, sub, dr, cost, params: ModernParams, route: _Route) -> Outputs:
    """The routes' shared tail: median, LR consistency, hole fill."""
    disp, sub, dr = _maybe_median(disp, sub, dr, params)
    tracing.stage("lr_check")
    valid = costvolume.lr_consistency(disp, dr, params.lr_max_diff,
                                      params.num_disparities)
    tracing.stage("fill")
    return {
        "disparity": disp,
        "subpixel": sub,
        "disparity_right": dr,
        "valid": valid,
        "filled": _fill(sub, valid, params, route.fill_invalid),
        "cost": cost,
    }


def _sgm_forward(left, right, params: ModernParams, route: _Route) -> Outputs:
    tracing.stage("census")
    codes = _cost_inputs(left, right, params)
    coarse = _coarse_inputs(left, right, params)
    tracing.stage("volume")
    args = (*codes, params.num_disparities, params.cost, _sgm_storage_dtype(params))
    if coarse is not None:
        vol = fused_sgm.sgm_volume_reference(*args, (*coarse, params.coarse_weight))
    else:
        vol = route.volume(*args)
    del codes, coarse
    tracing.stage("aggregation")
    agg = route.aggregate(vol, params.sgm_p1, params.sgm_p2, _sgm_out_dtype(params),
                          params.sgm_directions)
    del vol
    tracing.stage("tail")
    outs = route.tail(agg, params.uniqueness)
    del agg
    disp, sub, cost, dr = outs[:4]
    uniqueness = _uniqueness_ratio(outs[4], cost) if params.uniqueness else None
    out = _finish(disp, sub, dr, cost, params, route)
    if uniqueness is not None:
        out["uniqueness"] = uniqueness
    return out


def _one_view(codes, coarse, params: ModernParams, reference: str,
              route: _Route) -> DisparityResult:
    def ordered(pair):
        return pair if reference == "left" else pair[::-1]

    ref, other = ordered(codes)
    if coarse is None:
        return route.disparity(ref, other, params, reference)
    return costvolume.box_disparity(
        ref, other, params.num_disparities, params.window, params.cost, reference,
        (*ordered(coarse), params.coarse_weight))


def _box_views(left, right, params: ModernParams, route: _Route, views):
    """DisparityResult of each reference view in ``views``: K7 (or its
    plain version) at ``scales=1``; at ``scales=2`` ``box_disparity``
    with its coarse term, torch ops on every device."""
    tracing.stage("census")
    codes = _cost_inputs(left, right, params)
    coarse = _coarse_inputs(left, right, params)
    tracing.stage("disparity")
    return [_one_view(codes, coarse, params, v, route) for v in views]


def _box_forward(left, right, params: ModernParams, route: _Route) -> Outputs:
    dl, dr = _box_views(left, right, params, route, ("left", "right"))
    return _finish(dl.disparity, dl.subpixel, dr.disparity, dl.cost, params, route)


def disparity_one_view(
    left: torch.Tensor, right: torch.Tensor, params: ModernParams, reference: str = "left"
) -> DisparityResult:
    """The box route's disparity for one reference view of integer pixel
    planes [H, W] or [B, H, W]: the left reference matches L(x) against
    R(x - d), the right one R(x) against L(x + d).  For census both images
    go through the census transform first.  At ``scales=1`` K7 on CUDA
    tensors, its plain version on CPU tensors; at ``scales=2`` torch ops."""
    _check_inputs(left, right, params)
    if reference not in ("left", "right"):
        raise ValueError(f"reference must be 'left' or 'right', got {reference!r}")
    return _box_views(left, right, params, _route(params), (reference,))[0]


def _forward(left, right, params: ModernParams, route: _Route) -> Outputs:
    """The routes' forward, one ``forward`` span with a stage a phase:
    SGM ``census``, ``volume``, ``aggregation``, ``tail``, box ``census``,
    ``disparity``; then ``median`` (when on), ``lr_check``, ``fill``."""
    with tracing.span("forward", left):
        if route is not _PLAIN and tracing.on():
            for stage in plain_stages(params):
                tracing.count(f"plain_stage.{stage}")
        _check_inputs(left, right, params)
        fwd = _sgm_forward if params.aggregation == "sgm" else _box_forward
        return fwd(left, right, params, route)


def _check_inputs(left: torch.Tensor, right: torch.Tensor, params: ModernParams) -> None:
    if left.shape != right.shape:
        raise ValueError("the two images must have equal width and height")
    if left.ndim not in (2, 3):
        raise ValueError(f"need [H, W] or [B, H, W], got {tuple(left.shape)}")
    if left.is_floating_point() or right.is_floating_point():
        raise ValueError("modern_forward takes integer pixel planes 0..255")
    check_sad_pixels(left, right, params)


def check_sad_pixels(left: torch.Tensor, right: torch.Tensor, params: ModernParams,
                     extrema: Callable = torch.aminmax) -> None:
    """Raise unless the pixels are 0..255 where K7 matches them by SAD
    (box route, ``scales=1``): it stages them as bytes and keeps 16-bit
    column sums, so other values would give other planes on the card than
    on the CPU.  Held on every device, so both take the same inputs.
    uint8 planes pass unread; others cost one min/max pass and, on the
    card, a host sync.  ``extrema(plane)`` -> (min, max) as tensors; the
    sharded tier passes one that reduces across ranks."""
    if params.aggregation != "box" or params.cost != "sad" or params.scales != 1:
        return
    planes = [x for x in (left, right)
              if x.dtype not in (torch.uint8, torch.bool) and all(x.shape)]
    if not planes:
        return
    tracing.count("host_sync")
    ext = torch.stack([v.to(torch.int64) for x in planes for v in extrema(x)]).tolist()
    if min(ext) < 0 or max(ext) > 255:
        raise ValueError(f"the box route with SAD takes pixel values 0..255, got "
                         f"{min(ext)}..{max(ext)}")


def modern_forward(left: torch.Tensor, right: torch.Tensor, params: ModernParams) -> Outputs:
    """The modern pipeline (box or SGM route, per ``params.aggregation``)
    on integer pixel planes [H, W] or [B, H, W] -> disparity (int32),
    subpixel (f32), disparity_right (int32), valid (bool, LR-consistent),
    filled (f32), cost (int32 at the winner), and on the SGM route
    uniqueness (f32) with ``params.uniqueness``; each [H, W] or
    [B, H, W] on the inputs' device.  Stages whose kernel does not take
    ``params`` run their plain version (``modern_kernels_supported``)."""
    return _forward(left, right, params, _route(params))


def modern_forward_reference(
    left: torch.Tensor, right: torch.Tensor, params: ModernParams
) -> Outputs:
    """``modern_forward`` through the kernels' plain versions on any
    device (on the SGM route the int32 aggregate of
    ``ops.sgm.sgm_aggregate``, cast to the same storage): what the kernel
    route is held to on the card."""
    return _forward(left, right, params, _PLAIN)


class ModernPipeline(nn.Module):
    """The modern pipeline (box or SGM route) as a module with no parameters:
    ``forward(left, right)`` takes integer pixels [H, W] or [B, H, W]
    and returns the output dict on the inputs' device."""

    def __init__(self, params: ModernParams):
        super().__init__()
        self.params = params

    @torch.no_grad()
    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Outputs:
        return modern_forward(left, right, self.params)


def build_modern_pipeline(params: ModernParams) -> ModernPipeline:
    """The pipeline for fixed params, in eval mode."""
    return ModernPipeline(params).eval()
