"""Semi-Global Matching aggregation and the volume tail (counterpart of
``stereomatching_tpu/ops/sgm.py``; Hirschmüller 2005/2008).

Each path r accumulates

    L_r(p, d) = C(p, d) - min_d' L_r(p-r, d')
              + min( L_r(p-r, d), L_r(p-r, d±1) + P1, min_d' L_r(p-r, d') + P2 )

with L = C at the path's first pixel and d±1 outside [0, D) padded with
``_BIG``.  A path runs along x (rows), along y (columns) or along one of
the two diagonal families, stepping (y+1, x+1) or (y+1, x-1); each is
walked forward or in reverse.  A diagonal cell whose predecessor lies
outside the image starts its path (L = C).  A column or diagonal path
can also continue from the previous row shard's last row (``seed``) and
hand its own last row on (``with_carry``): the sharded tier's phased
chain.  Volumes are [..., H, W, D]
(d innermost, the JAX package's ``hwd`` layout); all arithmetic is exact
int32.  Plain torch: on the port's main route the paths and the tail run
as the kernels of ``ops/fused_sgm.py``, and these functions are their
plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.ops.costvolume import argmin_subpixel_scan

_BIG = 2**28

# Scan directions of a path (``False`` / ``True`` spell X / Y too).
X, Y, DIAG_PLUS, DIAG_MINUS = 0, 1, 2, 3
# The four paths of the 4-direction sum: (direction, reverse).
PATHS = ((X, False), (X, True), (Y, False), (Y, True))
# The four diagonal paths that 8 directions add, in the JAX package's
# order: r = (1, 1), (1, -1), then the bottom-to-top (-1, -1) and (-1, 1),
# the reverse walks of the same two line families.
DIAG_PATHS = ((DIAG_PLUS, False), (DIAG_MINUS, False), (DIAG_PLUS, True),
              (DIAG_MINUS, True))


def _step(carry: torch.Tensor, cost: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """One step of the recurrence: the predecessors' L ``carry`` and the
    costs ``cost``, both [..., D] -> L."""
    m = carry.amin(dim=-1, keepdim=True)
    up = F.pad(carry[..., 1:], (0, 1), value=_BIG)
    dn = F.pad(carry[..., :-1], (1, 0), value=_BIG)
    best = torch.minimum(torch.minimum(carry, torch.minimum(up, dn) + p1), m + p2)
    return cost + best - m


def _directional(vol: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """One left-to-right pass along W: vol [..., H, W, D] -> int32 L of
    the same shape."""
    vol = vol.to(torch.int32)
    out = torch.empty_like(vol)
    carry = vol[..., 0, :]
    out[..., 0, :] = carry
    for x in range(1, vol.shape[-2]):
        carry = _step(carry, vol[..., x, :], p1, p2)
        out[..., x, :] = carry
    return out


def _shift_x(carry: torch.Tensor, dx: int) -> torch.Tensor:
    """A row's L [..., W, D] seen from the next row of a path with
    predecessor (y-1, x-dx): shifted ``dx`` columns, an all-``_BIG``
    plane where the predecessor is outside the image."""
    if dx == 1:
        return F.pad(carry[..., :-1, :], (0, 0, 1, 0), value=_BIG)
    if dx == -1:
        return F.pad(carry[..., 1:, :], (0, 0, 0, 1), value=_BIG)
    return carry


def _directional_diag(vol: torch.Tensor, p1: int, p2: int, dx: int,
                      seed: torch.Tensor | None = None) -> torch.Tensor:
    """One top-to-bottom pass with predecessor (y-1, x-dx): vol
    [..., H, W, D] -> int32 L of the same shape.  The carry (the
    previous row's L) shifts by ``dx`` columns per row (0: a column
    path); a column whose predecessor is outside the image gets an
    all-``_BIG`` carry, which collapses the step to L = C.  ``seed``
    [..., W, D], the L of the row above the volume, is row 0's carry
    (else row 0 starts every path)."""
    vol = vol.to(torch.int32)
    out = torch.empty_like(vol)
    carry = vol[..., 0, :, :]
    if seed is not None:
        carry = _step(_shift_x(seed.to(torch.int32), dx), carry, p1, p2)
    out[..., 0, :, :] = carry
    for y in range(1, vol.shape[-3]):
        carry = _step(_shift_x(carry, dx), vol[..., y, :, :], p1, p2)
        out[..., y, :, :] = carry
    return out


def path(vol: torch.Tensor, p1: int, p2: int, direction: int, reverse: bool,
         seed: torch.Tensor | None = None, with_carry: bool = False):
    """One SGM path over [..., H, W, D] -> int32 L: along W (``X``), H
    (``Y``) or a diagonal (``DIAG_PLUS`` steps (y+1, x+1), ``DIAG_MINUS``
    (y+1, x-1)), from the first cell of each line (``reverse`` False) or
    the last.

    For ``Y`` and the diagonals, ``seed`` [..., W, D] continues the walk
    from the row before the first scanned one (the previous row shard's
    last scanned row, unshifted: cell x of the first scanned row takes
    seed[x - sx] as its predecessor, sx the walk's x step), and
    ``with_carry`` also returns the last scanned row's L [..., W, D]
    (unshifted) -> (L, carry): a seeded pass continuing a carrying one
    equals one pass over both, sliced at the boundary."""
    if seed is not None or with_carry:
        if direction not in (Y, DIAG_PLUS, DIAG_MINUS):
            raise ValueError("seed / with_carry take the column or diagonal paths")
        dx = {Y: 0, DIAG_PLUS: 1, DIAG_MINUS: -1}[direction]
        if not reverse:
            out = _directional_diag(vol, p1, p2, dx, seed)
        else:
            out = _directional_diag(vol.flip(-3), p1, p2, -dx, seed).flip(-3)
        if not with_carry:
            return out
        return out, out[..., 0 if reverse else -1, :, :].clone()
    if direction in (DIAG_PLUS, DIAG_MINUS):
        dx = 1 if direction == DIAG_PLUS else -1
        if not reverse:
            return _directional_diag(vol, p1, p2, dx)
        # The reverse walk is the forward pass of the other family on the
        # y-flipped volume: (y+1, x+dx) lands at (y'-1, x+dx).
        return _directional_diag(vol.flip(-3), p1, p2, -dx).flip(-3)
    along_y = direction == Y
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
    bottom->top paths, plus the four diagonal paths with
    ``directions=8``."""
    if p1 < 0 or p2 < p1:
        raise ValueError("need 0 <= p1 <= p2")
    if directions not in (4, 8):
        raise ValueError("directions must be 4 or 8")
    paths = PATHS + (DIAG_PATHS if directions == 8 else ())
    out = path(vol, p1, p2, *paths[0])
    for direction, reverse in paths[1:]:
        out += path(vol, p1, p2, direction, reverse)
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
