"""Plain PyTorch reference of the census SGM route (Hirschmüller 2005/
2008 with the program's stated rules): census transform, per-pixel
Hamming cost volume, the 4- or 8-path aggregation, first-minimum argmin
with parabola sub-pixel refine, the right view's disparity by
re-projection, the LR check and the validity-aware diffusion fill.

Written for the benchmark alone: it imports nothing of the program and
takes nothing the program made.  Costs and paths are exact int32; the
float planes (sub-pixel, filled) run in ``float_dtype``: float32 is the
route's stated precision and gives its planes bit for bit; a lower type
is the benchmark's control.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# The argmin's sentinel and the paths' out-of-range value.
BIG = 2**30
PATH_BIG = 2**28
# Out-of-frame sentinel of the LR lookup: never within the tolerance.
LR_BIG = 2**20


def _edge_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    ys = torch.arange(-half, h + half, device=x.device).clamp(0, h - 1)
    xs = torch.arange(-half, w + half, device=x.device).clamp(0, w - 1)
    return x[..., ys, :][..., xs]


def census(img: torch.Tensor, window: int) -> torch.Tensor:
    """One bit per neighbour of the window (centre left out, row-major
    from the top-left, bit 0 first), set iff the neighbour is below the
    centre; borders replicate.  -> int32 codes."""
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
            code |= (nb < img).to(torch.int32) << bit
            bit += 1
    return code


def popcount(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def volume(codes_l: torch.Tensor, codes_r: torch.Tensor, d_count: int) -> torch.Tensor:
    """vol[..., y, x, d] = popcount(L[y, x] ^ R[y, max(x - d, 0)]), int32."""
    w = codes_l.shape[-1]
    ext = torch.cat([codes_r[..., :1].expand(*codes_r.shape[:-1], d_count), codes_r], -1)
    vol = torch.empty((d_count, *codes_l.shape), dtype=torch.int32, device=codes_l.device)
    for d in range(d_count):
        vol[d] = popcount(codes_l ^ ext[..., d_count - d: d_count - d + w])
    return vol.movedim(0, -1).contiguous()


def _step(carry: torch.Tensor, cost: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """L = C + min(L', L'(d +- 1) + P1, min L' + P2) - min L' over the
    last axis (d); d +- 1 outside the range reads ``PATH_BIG``."""
    m = carry.amin(dim=-1, keepdim=True)
    up = F.pad(carry[..., 1:], (0, 1), value=PATH_BIG)
    dn = F.pad(carry[..., :-1], (1, 0), value=PATH_BIG)
    return cost + torch.minimum(torch.minimum(carry, torch.minimum(up, dn) + p1), m + p2) - m


def _shift_cols(carry: torch.Tensor, dx: int) -> torch.Tensor:
    """A row's L [..., W, D] as the next row's predecessors at x - dx;
    ``PATH_BIG`` where that lies outside the image (the path starts)."""
    if dx == 1:
        return F.pad(carry[..., :-1, :], (0, 0, 1, 0), value=PATH_BIG)
    if dx == -1:
        return F.pad(carry[..., 1:, :], (0, 0, 0, 1), value=PATH_BIG)
    return carry


def aggregate(vol: torch.Tensor, p1: int, p2: int, directions: int) -> torch.Tensor:
    """The sum of the SGM paths over vol [..., H, W, D] -> int32: along
    rows both ways, along columns both ways and, with 8 directions, the
    diagonals stepping (y + 1, x + 1) and (y + 1, x - 1) both ways.  Each
    path starts at its line's first cell with L = C."""
    h, w = vol.shape[-3], vol.shape[-2]
    agg = torch.zeros_like(vol)
    for xs in (range(w), range(w - 1, -1, -1)):
        carry = None
        for x in xs:
            c = vol[..., x, :]
            carry = c if carry is None else _step(carry, c, p1, p2)
            agg[..., x, :] += carry
    walks = [(0, False), (0, True)]
    if directions == 8:
        walks += [(1, False), (-1, False), (1, True), (-1, True)]
    for dx, rev in walks:
        # A reverse walk steps (y - 1, x + dx): predecessors at x - (-dx).
        step_dx = -dx if rev else dx
        carry = None
        for y in (range(h - 1, -1, -1) if rev else range(h)):
            c = vol[..., y, :, :]
            carry = c if carry is None else _step(_shift_cols(carry, step_dx), c, p1, p2)
            agg[..., y, :, :] += carry
    return agg


def argmin_subpixel(planes, float_dtype: torch.dtype):
    """First minimum over d of the int32 planes (strict <), then the
    parabola on (c_left, best, c_right), skipped where a neighbour is
    missing or the triple is not convex, clipped to [-0.5, 0.5].
    -> (disparity int32, subpixel float32, cost int32)."""
    best = best_d = c_left = c_right = c_prev = was_new = None
    for d, c in enumerate(planes):
        if best is None:
            big = torch.full_like(c, BIG)
            best, best_d, c_left, c_right, c_prev = big, torch.zeros_like(c), big, big, big
            was_new = torch.zeros_like(c, dtype=torch.bool)
        c_right = torch.where(was_new, c, c_right)
        is_new = c < best
        best = torch.where(is_new, c, best)
        best_d = torch.where(is_new, d, best_d)
        c_left = torch.where(is_new, c_prev, c_left)
        c_right = torch.where(is_new, BIG, c_right)
        c_prev, was_new = c, is_new
    cl, cm, cr = (t.to(float_dtype) for t in (c_left, best, c_right))
    denom = cl - 2.0 * cm + cr
    valid = (c_left < BIG) & (c_right < BIG) & (denom > 0)
    offset = torch.where(valid, (cl - cr) / torch.where(valid, 2.0 * denom, 1.0), 0.0)
    sub = best_d.to(float_dtype) + offset.clamp(-0.5, 0.5)
    return best_d, sub.to(torch.float32), best


def right_disparity(agg_dmajor: torch.Tensor) -> torch.Tensor:
    """The right view's disparity from the left-referenced aggregate
    [D, ..., H, W]: first minimum over d of cost_L(min(x + d, W - 1), d)."""
    best = best_d = None
    for d in range(agg_dmajor.shape[0]):
        p = agg_dmajor[d]
        c = torch.cat([p[..., d:], p[..., -1:].expand(*p.shape[:-1], d)], -1) if d else p
        if best is None:
            best, best_d = torch.full_like(c, PATH_BIG), torch.zeros_like(c)
        is_new = c < best
        best = torch.where(is_new, c, best)
        best_d = torch.where(is_new, d, best_d)
    return best_d


def lr_check(dl: torch.Tensor, dr: torch.Tensor, max_diff: int, d_count: int) -> torch.Tensor:
    """x is consistent iff 0 <= dL < D, x - dL is in frame and
    |dL(x) - dR(x - dL(x))| <= max_diff."""
    w = dl.shape[-1]
    target = torch.arange(w, dtype=torch.int32, device=dl.device) - dl
    ok = (target >= 0) & (dl >= 0) & (dl < d_count)
    at = torch.gather(dr, -1, target.clamp(0, w - 1).to(torch.int64))
    return (torch.where(ok, at, LR_BIG) - dl).abs() <= max_diff


def fill(disp: torch.Tensor, valid: torch.Tensor, iterations: int,
         float_dtype: torch.dtype) -> torch.Tensor:
    """``iterations`` Jacobi sweeps: an invalid pixel with a valid
    4-neighbour takes the mean of its valid neighbours ((right + left) +
    down) + up over max(count, 1), and turns valid.  Zero-padded edges."""
    d = disp.to(float_dtype)
    v = valid.to(float_dtype)

    def nb_sum(x):
        return ((F.pad(x[..., :, 1:], (0, 1)) + F.pad(x[..., :, :-1], (1, 0)))
                + F.pad(x[..., 1:, :], (0, 0, 0, 1))) + F.pad(x[..., :-1, :], (0, 0, 1, 0))

    for _ in range(iterations):
        num, den = nb_sum(d * v), nb_sum(v)
        newly = (v == 0) & (den > 0)
        d = torch.where(newly, num / torch.clamp(den, min=1.0), d)
        v = torch.where(newly, 1.0, v)
    return d.to(torch.float32)


def forward(left: torch.Tensor, right: torch.Tensor, params: Dict,
            float_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The route on int32 pixels [B, H, W] -> the planes the program's
    forward returns."""
    if params["cost"] != "census" or params["aggregation"] != "sgm":
        raise ValueError("this reference runs the census SGM route")
    if params["scales"] != 1 or params["median_filter"] or params["uniqueness"] \
            or params["fill_mode"] != "diffusion":
        raise ValueError("this reference runs scales 1, no median, no uniqueness, "
                         "the diffusion fill")
    d_count = params["num_disparities"]
    vol = volume(census(left, params["census_window"]), census(right, params["census_window"]),
                 d_count)
    agg = aggregate(vol, params["sgm_p1"], params["sgm_p2"], params["sgm_directions"])
    del vol
    planes = agg.movedim(-1, 0).contiguous()
    del agg
    disp, sub, cost = argmin_subpixel(planes, float_dtype)
    dr = right_disparity(planes)
    del planes
    valid = lr_check(disp, dr, params["lr_max_diff"], d_count)
    return {"disparity": disp, "subpixel": sub, "disparity_right": dr, "valid": valid,
            "filled": fill(sub, valid, params["fill_iterations"], float_dtype), "cost": cost}
