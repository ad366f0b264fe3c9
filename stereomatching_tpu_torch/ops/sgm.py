"""Semi-Global Matching aggregation and the volume tail (counterpart of
``stereomatching_tpu/ops/sgm.py``; Hirschmüller 2005/2008).

Each path r accumulates

    L_r(p, d) = C(p, d) - min_d' L_r(p-r, d')
              + min( L_r(p-r, d), L_r(p-r, d±1) + P1, min_d' L_r(p-r, d') + P2 )

with L = C at the path's first pixel and d±1 outside [0, D) padded with
``_BIG``.  Volumes are [..., H, W, D] (d innermost, the JAX package's
``hwd`` layout); all arithmetic is exact int32.  Plain torch: on the
port's main route the paths and the tail run as the kernels of
``ops/fused_sgm.py``, and these functions are their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.ops.costvolume import argmin_subpixel_scan

_BIG = 2**28

# The four paths of the 4-direction sum: (along y, reverse).
PATHS = ((False, False), (False, True), (True, False), (True, True))


def _directional(vol: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """One left-to-right pass along W: vol [..., H, W, D] -> int32 L of
    the same shape."""
    vol = vol.to(torch.int32)
    out = torch.empty_like(vol)
    carry = vol[..., 0, :]
    out[..., 0, :] = carry
    for x in range(1, vol.shape[-2]):
        m = carry.amin(dim=-1, keepdim=True)
        up = F.pad(carry[..., 1:], (0, 1), value=_BIG)
        dn = F.pad(carry[..., :-1], (1, 0), value=_BIG)
        best = torch.minimum(torch.minimum(carry, torch.minimum(up, dn) + p1), m + p2)
        carry = vol[..., x, :] + best - m
        out[..., x, :] = carry
    return out


def path(vol: torch.Tensor, p1: int, p2: int, along_y: bool, reverse: bool) -> torch.Tensor:
    """One SGM path over [..., H, W, D]: along W (``along_y`` False) or
    H, from the first index (``reverse`` False) or the last.  -> int32 L."""
    v = vol.transpose(-3, -2) if along_y else vol
    if reverse:
        v = v.flip(-2)
    out = _directional(v, p1, p2)
    if reverse:
        out = out.flip(-2)
    return out.transpose(-3, -2) if along_y else out


def sgm_aggregate(
    vol: torch.Tensor, p1: int = 8, p2: int = 96, directions: int = 4
) -> torch.Tensor:
    """SGM aggregation of a cost volume [..., H, W, D] -> int32, same
    shape: the sum of the left->right, right->left, top->bottom and
    bottom->top paths.  ``directions=8`` (the diagonal paths) is not
    ported yet."""
    if p1 < 0 or p2 < p1:
        raise ValueError("need 0 <= p1 <= p2")
    if directions == 8:
        raise NotImplementedError(
            "8-direction SGM (diagonal paths) is the next slice of the port"
        )
    if directions != 4:
        raise ValueError("directions must be 4 or 8")
    out = path(vol, p1, p2, *PATHS[0])
    for along_y, reverse in PATHS[1:]:
        out += path(vol, p1, p2, along_y, reverse)
    return out


def volume_argmin_subpixel(vol: torch.Tensor):
    """First-minimum argmin over d + parabola sub-pixel refine of a
    volume [..., H, W, D] -> (disparity int32, subpixel f32, cost int32),
    each [..., H, W]."""
    res = argmin_subpixel_scan(lambda d: vol[..., d], vol.shape[-1])
    return res.disparity, res.subpixel, res.cost


def second_best_outside_neighborhood(vol: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """min over d with |d - disp| > 1 of the volume [..., H, W, D], the
    numerator of the uniqueness ratio; pixels where every d is excluded
    (D <= 3) keep the ``_BIG`` sentinel.  -> int32 [..., H, W]."""
    c2 = torch.full(disp.shape, _BIG, dtype=torch.int32, device=vol.device)
    for d in range(vol.shape[-1]):
        c = vol[..., d].to(torch.int32)
        c2 = torch.minimum(c2, torch.where((disp - d).abs() <= 1, _BIG, c))
    return c2


def right_disparity_from_left_volume(vol: torch.Tensor) -> torch.Tensor:
    """Right-view disparity from the left-referenced volume [..., H, W, D]
    by the re-projection cost_R(x, d) = cost_L(min(x + d, W - 1), d),
    first minimum winning.  -> int32 [..., H, W]."""
    w, d_count = vol.shape[-2:]
    xs = torch.arange(w, device=vol.device)
    best = best_d = None
    for d in range(d_count):
        c = vol[..., (xs + d).clamp(max=w - 1), d].to(torch.int32)
        if best is None:
            best = torch.full_like(c, _BIG)
            best_d = torch.zeros_like(c)
        is_new = c < best
        best = torch.where(is_new, c, best)
        best_d = torch.where(is_new, d, best_d)
    return best_d
