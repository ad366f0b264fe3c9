"""Cost-volume helpers of the modern pipeline (counterpart of
``stereomatching_tpu/ops/costvolume.py``): census transform, popcount,
the first-minimum argmin with parabola sub-pixel refine, the box route's
windowed disparity (``sad_disparity``, ``box_disparity``, with the
optional coarse term of multi-scale fusion), LR consistency, the 3x3
median, and the two hole fills.

Plain torch on every device.  All functions take [..., H, W] planes
(leading batch dims pass through).  Costs and disparities are exact
int32; the float planes (sub-pixel, filled) come from the JAX package's
op order with IEEE division, so they are bitwise equal to it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.ops.aggregate import box_sum_padded

# Argmin sentinel (ops/costvolume._BIG).
_BIG = 2**30
# Out-of-frame sentinel of the LR lookup: never within max_diff.
_LR_BIG = 2**20


class DisparityResult(NamedTuple):
    disparity: torch.Tensor  # int32 [..., H, W]: winning integer disparity
    subpixel: torch.Tensor  # float32 [..., H, W]: disparity + parabola offset
    cost: torch.Tensor  # int32 [..., H, W]: aggregated cost at the winner


def _edge_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    """Replicate the border ``half`` pixels out on both spatial axes
    (any dtype; ``F.pad``'s replicate mode takes floats only)."""
    h, w = x.shape[-2:]
    ys = torch.arange(-half, h + half, device=x.device).clamp(0, h - 1)
    xs = torch.arange(-half, w + half, device=x.device).clamp(0, w - 1)
    return x[..., ys, :][..., xs]


def _extend_left(img: torch.Tensor, n: int) -> torch.Tensor:
    """[..., H, W] -> [..., H, W+n]: n copies of the first column
    prepended (the out-of-frame clamp of R(x-d))."""
    first = img[..., :1].expand(*img.shape[:-1], n)
    return torch.cat([first, img], dim=-1)


def _extend_right(img: torch.Tensor, n: int) -> torch.Tensor:
    """[..., H, W] -> [..., H, W+n]: n copies of the last column appended
    (the out-of-frame clamp of L(x+d))."""
    last = img[..., -1:].expand(*img.shape[:-1], n)
    return torch.cat([img, last], dim=-1)


def _aggregate(cost: torch.Tensor, half: int) -> torch.Tensor:
    """Zero-padded box sum of the per-pixel costs [..., H, W] over the
    (2*half+1)^2 window -> int32 (window pixels outside the frame add 0)."""
    if half == 0:
        return cost.to(torch.int32)
    return box_sum_padded(F.pad(cost, (half, half, half, half)), half)


def census_transform(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Census transform: per pixel, one bit per neighbour of the
    ``window`` x ``window`` neighbourhood (centre excluded, row-major
    order from the top-left, bit 0 first), set iff the neighbour is
    strictly below the centre.  Borders replicate.  -> int32 codes
    (window 5 -> 24 bits)."""
    if window < 3 or window % 2 == 0 or window > 5:
        raise ValueError("census window must be 3 or 5")
    half = window // 2
    img = img.to(torch.int32)
    p = _edge_pad(img, half)
    h, w = img.shape[-2:]
    code = torch.zeros_like(img)
    bit = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            nb = p[..., half + dy: half + dy + h, half + dx: half + dx + w]
            # The bits are distinct, so adding 2^bit where set is the OR
            # (two passes per neighbour: compare, add).
            code.add_(nb < img, alpha=1 << bit)
            bit += 1
    return code


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of int32 bit patterns (SWAR, no multiply: the
    byte sums are folded with shifts so nothing overflows)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def argmin_subpixel_scan(
    cost_at: Callable[[int], torch.Tensor], num_disparities: int
) -> DisparityResult:
    """First-minimum argmin over d of ``cost_at(d)`` (int32 planes of one
    shape), carrying the costs beside the running minimum, then the
    parabola refine on (c_left, best, c_right).

    Ties: the FIRST minimum wins (strict <).  The refine is skipped
    (offset 0) where a neighbour is missing (the winner at d = 0 or
    D - 1) or the triple is flat or not convex, and clipped to
    [-0.5, 0.5]."""
    best = best_d = c_left = c_right = c_prev = was_new = None
    for d in range(num_disparities):
        c = cost_at(d).to(torch.int32)
        if best is None:
            big = torch.full_like(c, _BIG)
            best, best_d = big, torch.zeros_like(c)
            c_left, c_right, c_prev = big, big, big
            was_new = torch.zeros_like(c, dtype=torch.bool)
        # The step after a new minimum supplies its right neighbour.
        c_right = torch.where(was_new, c, c_right)
        is_new = c < best
        best = torch.where(is_new, c, best)
        best_d = torch.where(is_new, d, best_d)
        c_left = torch.where(is_new, c_prev, c_left)
        c_right = torch.where(is_new, _BIG, c_right)
        c_prev = c
        was_new = is_new
    cl = c_left.to(torch.float32)
    cm = best.to(torch.float32)
    cr = c_right.to(torch.float32)
    denom = cl - 2.0 * cm + cr
    valid = (c_left < _BIG) & (c_right < _BIG) & (denom > 0)
    offset = torch.where(
        valid, (cl - cr) / torch.where(valid, 2.0 * denom, 1.0), 0.0
    )
    offset = offset.clamp(-0.5, 0.5)
    return DisparityResult(
        disparity=best_d,
        subpixel=best_d.to(torch.float32) + offset,
        cost=best,
    )


def upsample2(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel repetition x2 on both axes, cropped to [..., h, w] (the
    coarse level of multi-scale fusion back at full size)."""
    return img.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]


def pixel_cost(a: torch.Tensor, b: torch.Tensor, cost: str) -> torch.Tensor:
    """Per-pixel dissimilarity of int32 cost inputs: census Hamming
    distance or absolute difference."""
    return popcount32(a ^ b) if cost == "census" else (a - b).abs()


def shifted_view(other: torch.Tensor, num_disparities: int, reference: str):
    """-> ``at(d)``: the matching view of ``other`` [..., H, W] at
    disparity d, edge-clamped in x (left reference: other[max(x - d, 0)];
    right: other[min(x + d, W-1)]), int32."""
    w = other.shape[-1]
    other = other.to(torch.int32)
    if reference == "left":
        ext = _extend_left(other, num_disparities)
        return lambda d: ext[..., num_disparities - d: num_disparities - d + w]
    ext = _extend_right(other, num_disparities)
    return lambda d: ext[..., d: d + w]


def box_disparity(
    ref: torch.Tensor, other: torch.Tensor, num_disparities: int, window: int,
    cost: str = "sad", reference: str = "left", coarse=None,
) -> DisparityResult:
    """Windowed disparity of one reference view from its cost inputs
    [..., H, W] (intensities for SAD, census codes for census): for each
    d the per-pixel cost against the matching view (``shifted_view``),
    box-summed with zero padding, then the first-minimum argmin and the
    parabola.  The plain version of the box route's kernel.

    ``coarse = (ref_c, other_c, weight)``, the cost inputs of the
    2x2-summed images, adds multi-scale fusion (``scales=2``): cost(d)
    gains weight x the box-summed coarse cost at d // 2, upsampled."""
    if cost not in ("sad", "census"):
        raise ValueError("cost must be 'sad' or 'census'")
    if reference not in ("left", "right"):
        raise ValueError(f"reference must be 'left' or 'right', got {reference!r}")
    half = window // 2
    ref = ref.to(torch.int32)
    h, w = ref.shape[-2:]
    fine_at = shifted_view(other, num_disparities, reference)
    if coarse is not None:
        ref_c, other_c, weight = coarse
        ref_c = ref_c.to(torch.int32)
        coarse_at = shifted_view(other_c, -(-num_disparities // 2), reference)
        term = {}  # the coarse term of the last d // 2 (d runs in order)

    def cost_at(d: int) -> torch.Tensor:
        c = _aggregate(pixel_cost(ref, fine_at(d), cost), half)
        if coarse is None:
            return c
        if d // 2 not in term:
            term.clear()
            term[d // 2] = weight * upsample2(
                _aggregate(pixel_cost(ref_c, coarse_at(d // 2), cost), half), h, w)
        return c + term[d // 2]

    return argmin_subpixel_scan(cost_at, num_disparities)


def sad_disparity(
    left: torch.Tensor, right: torch.Tensor, num_disparities: int,
    window: int = 9, reference: str = "left",
) -> DisparityResult:
    """Windowed-SAD disparity for one view of integer pixel planes
    [..., H, W]: left reference matches L(x) against R(x-d), right
    reference R(x) against L(x+d); out-of-frame columns replicate the
    edge."""
    ref, other = (left, right) if reference == "left" else (right, left)
    return box_disparity(ref, other, num_disparities, window, "sad", reference)


def lr_consistency(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    max_diff: int = 1,
    num_disparities: int | None = None,
) -> torch.Tensor:
    """Left-right consistency: pixel x is consistent iff x - dL(x) is in
    frame and |dL(x) - dR(x - dL(x))| <= max_diff.  With
    ``num_disparities`` given, a dL outside [0, D) also fails (the JAX
    package's D-step lookup matches no d there).  -> bool [..., H, W]."""
    w = disp_left.shape[-1]
    dl = disp_left.to(torch.int32)
    target = torch.arange(w, dtype=torch.int32, device=dl.device) - dl
    ok = target >= 0
    if num_disparities is not None:
        ok &= (dl >= 0) & (dl < num_disparities)
    dr_at = torch.gather(
        disp_right.to(torch.int32).expand_as(dl), -1,
        target.clamp(0, w - 1).to(torch.int64),
    )
    g = torch.where(ok, dr_at, _LR_BIG)
    return (g - dl).abs() <= max_diff


# Median-of-9 exchange network (19 comparators); each pair sorts two taps.
_MEDIAN9_NET = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median filter with edge-replicated borders, by the same
    19-comparator network as the JAX package (any dtype)."""
    h, w = x.shape[-2:]
    p = _edge_pad(x, 1)
    taps = [
        p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ]
    for a, b in _MEDIAN9_NET:
        taps[a], taps[b] = torch.minimum(taps[a], taps[b]), torch.maximum(taps[a], taps[b])
    return taps[4]


def fill_background(disparity: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Background-extension hole filling (Hirschmüller 2008 §V): every
    invalid pixel takes min(nearest valid disparity to its left, nearest
    valid to its right) along its row, or the one that exists; rows with
    no valid pixel are 0.  float32 out.  Any exact scanline form gives
    the JAX package's associative scan: only selections, no arithmetic."""
    d = disparity.to(torch.float32)
    valid = valid.to(torch.bool)
    dv = d * valid.to(torch.float32)
    w = d.shape[-1]
    xs = torch.arange(w, device=d.device)
    left_i = torch.where(valid, xs, -1).cummax(dim=-1).values
    right_i = torch.where(valid, xs, w).flip(-1).cummin(dim=-1).values.flip(-1)
    lh, rh = left_i >= 0, right_i < w
    # Where no valid pixel lies on a side, the clamped index reads an
    # invalid end pixel, whose dv is the JAX scan's zero of that side.
    lv = torch.gather(dv, -1, left_i.clamp(min=0))
    rv = torch.gather(dv, -1, right_i.clamp(max=w - 1))
    fill = torch.where(lh & rh, torch.minimum(lv, rv), torch.where(lh, lv, rv))
    return torch.where(valid, d, fill)


def fill_invalid(
    disparity: torch.Tensor, valid: torch.Tensor, iterations: int = 16
) -> torch.Tensor:
    """Diffuse valid disparities into invalid holes: ``iterations``
    Jacobi sweeps in which an invalid pixel with a valid 4-neighbour
    takes the float32 mean of its valid neighbours and becomes valid.
    Edges are zero-padded; the neighbour sum is right + left + down + up
    in that order, then one IEEE divide by max(count, 1).  The plain
    version of ``ops.fused_diffusion.fill_invalid``'s kernel."""
    d = disparity.to(torch.float32)
    v = valid.to(torch.float32)

    def nb_sum(x):
        right = F.pad(x[..., :, 1:], (0, 1))
        left = F.pad(x[..., :, :-1], (1, 0))
        down = F.pad(x[..., 1:, :], (0, 0, 0, 1))
        up = F.pad(x[..., :-1, :], (0, 0, 1, 0))
        return ((right + left) + down) + up

    for _ in range(iterations):
        num = nb_sum(d * v)
        den = nb_sum(v)
        avg = num / torch.clamp(den, min=1.0)
        newly = (v == 0) & (den > 0)
        d = torch.where(newly, avg, d)
        v = torch.where(newly, 1.0, v)
    return d
