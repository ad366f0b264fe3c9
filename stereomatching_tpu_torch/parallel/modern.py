"""The modern pipeline sharded over a (data, rows[, cols]) mesh
(counterpart of ``stereomatching_tpu/parallel/modern.py``).

Batches shard over "data" and rows over "rows"; every y dependency is
one halo exchange of exactly its reach, and on a rows-only mesh every x
dependency (the disparity slide, the box window's x reach, LR, which
looks along scanlines) stays inside the shard:

  phase                       y reach            exchange
  census transform            census_window//2   with the cost phase's
  cost box filter             window//2          pixel exchange
  SGM column / diagonal paths the whole column   a phased carry chain
  median filter (optional)    1 row              once per plane
  hole-fill diffusion         1 row              per sweep

The boundary rules are baked into the exchanged blocks: census reads
edge-replicated pixels at the global y edge, and the cost inputs of rows
outside the global image are zeroed after the census transform, so that
SAD |0 - 0| and census popcount(0 ^ 0) vanish.

Per block of shards (``mesh.Shards``) each stage is one launch over all
the block's shards: the box route's disparity is K7
(``fused_modern.disparity``) on the halo blocks; the SGM route's volume
K3, its horizontal paths K4 over the whole block, its column and
diagonal paths K4 seeded by the previous row shard's carry (one launch
per row position and walk), its tail K5; each fill sweep K6's sweep
kernel (``fill_invalid_step``).  The CUDA kernels run on CUDA shards,
their plain versions on CPU shards.  The 2-D (rows x cols) box route is
torch ops (the JAX package runs it on XLA only), its fill sweeps K6's.
A config that K7 or K4 does not take (``models.modern.
modern_kernels_supported``) runs that stage's plain version on the CUDA
shards.  Every route's output equals the single-device pipeline's, bit
for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.models.modern import (
    _sgm_out_dtype, _sgm_storage_dtype, _uniqueness_ratio, check_sad_pixels,
    modern_kernels_supported)
from stereomatching_tpu_torch.ops import costvolume, fused_modern, fused_sgm, sgm
from stereomatching_tpu_torch.ops.costvolume import (
    DisparityResult, _aggregate, argmin_subpixel_scan, census_transform, pixel_cost)
from stereomatching_tpu_torch.ops.fused_diffusion import fill_invalid_step
from stereomatching_tpu_torch.parallel.halo import (
    exchange_col_halo, with_col_halo, with_row_halo)
from stereomatching_tpu_torch.parallel.mesh import (
    COLS_AXIS, ROWS_AXIS, Mesh, Sharded, Shards, _as_tensor, mesh_cols)
from stereomatching_tpu_torch.parallel.pipeline import _sharded_input, sharded_forward

Outputs = Dict[str, torch.Tensor]
_LR_BIG = 2**20  # the LR lookup's out-of-frame sentinel


def _cost_reach(params: ModernParams) -> int:
    """y halo of the box route's cost phase: the window half plus the
    census neighbourhood half (0 for SAD)."""
    ch = params.census_window // 2 if params.cost == "census" else 0
    return params.window // 2 + ch


def _global_rows(sh: Shards, start: int, n: int) -> torch.Tensor:
    """Global row index of block rows start .. start + n - 1 relative to
    each shard's first row: [lr, lc, n_img, n, 1]."""
    g = sh.offsets(ROWS_AXIS, sh.hs)[..., None] + torch.arange(start, start + n, device=sh.device)
    return g[..., None]


def _prepare_cost_blocks(sh: Shards, left, right, params: ModernParams):
    """Pixel halo exchange -> the two cost-input blocks [lr, lc, n,
    hs + 2*half, W] (census codes or raw intensities) with the global
    boundary rules baked in (edge-replicated census inputs, zeroed
    out-of-global rows)."""
    hs = sh.hs
    half = params.window // 2
    ch = params.census_window // 2 if params.cost == "census" else 0
    reach = half + ch
    lx = with_row_halo(left, reach, sh, circular=False)
    rx = with_row_halo(right, reach, sh, circular=False)
    g = _global_rows(sh, -reach, hs + 2 * reach)
    h_global = sh.n_rows * hs
    if ch > 0:
        def replicate(x):
            x = torch.where(g < 0, x[..., reach:reach + 1, :], x)
            return torch.where(g >= h_global, x[..., reach + hs - 1:reach + hs, :], x)

        lx, rx = replicate(lx), replicate(rx)
    if params.cost == "census":
        lx, rx = (census_transform(x, params.census_window) for x in (lx, rx))
        if ch > 0:  # trim the census neighbourhood's margin
            lx = lx[..., ch:ch + hs + 2 * half, :]
            rx = rx[..., ch:ch + hs + 2 * half, :]
            g = g[..., ch:ch + hs + 2 * half, :]
    in_frame = (g >= 0) & (g < h_global)
    return torch.where(in_frame, lx, 0), torch.where(in_frame, rx, 0)


def _prepare_cost_blocks_2d(sh: Shards, left, right, params: ModernParams):
    """2-D twin of ``_prepare_cost_blocks``: pixel halos in both axes (x:
    num_disparities + window//2, y: window//2, the census margin on top of
    both).  Out-of-global raw pixels replicate the global edge (rows
    first, then columns), out-of-global code columns then take the
    global edge code column (the clamp of the slide works on codes), and
    the cost positions outside the global image are masked.  -> (lx, rx,
    valid), blocks [lr, lc, n, hs + 2*yh, ws + 2*xh] and a bool position
    mask [lr, lc, 1, hs + 2*yh, ws + 2*xh]."""
    hs, ws = sh.hs, sh.ws
    half = params.window // 2
    ch = params.census_window // 2 if params.cost == "census" else 0
    yh, xh = half, half + params.num_disparities

    def ext2d(x, ry, rx_):
        return with_row_halo(with_col_halo(x, rx_, sh, circular=False), ry, sh, circular=False)

    lx = ext2d(left, yh + ch, xh + ch)
    rx = ext2d(right, yh + ch, xh + ch)
    dev = sh.device
    g_r = (sh.offsets(ROWS_AXIS, hs, -yh - ch)[..., :1, None]
           + torch.arange(hs + 2 * (yh + ch), device=dev))[..., None]
    g_c = (sh.offsets(COLS_AXIS, ws, -xh - ch)[..., :1, None]
           + torch.arange(ws + 2 * (xh + ch), device=dev))[..., None, :]
    h_g, w_g = sh.n_rows * hs, sh.n_cols * ws

    def edge_replicate(x):
        x = torch.where(g_r < 0, x[..., yh + ch:yh + ch + 1, :], x)
        x = torch.where(g_r >= h_g, x[..., yh + ch + hs - 1:yh + ch + hs, :], x)
        x = torch.where(g_c < 0, x[..., xh + ch:xh + ch + 1], x)
        return torch.where(g_c >= w_g, x[..., xh + ch + ws - 1:xh + ch + ws], x)

    if ch > 0:
        lx, rx = edge_replicate(lx), edge_replicate(rx)
        lx, rx = (census_transform(x, params.census_window)[..., ch:-ch, ch:-ch]
                  for x in (lx, rx))
        g_r, g_c = g_r[..., ch:-ch, :], g_c[..., ch:-ch]

    def clamp(x):
        x = torch.where(g_c < 0, x[..., xh:xh + 1], x)
        return torch.where(g_c >= w_g, x[..., xh + ws - 1:xh + ws], x)

    valid = (g_r >= 0) & (g_r < h_g) & (g_c >= 0) & (g_c < w_g)
    return clamp(lx), clamp(rx), valid


def _disparity_block_2d(ref, oth, valid, params: ModernParams, reference: str,
                        hs: int, ws: int) -> DisparityResult:
    """One view's windowed disparity on 2-D halo blocks -> the [hs, ws]
    core: the slide reads the x halo, out-of-global cost positions are
    masked to zero (the single-device route's zero padding)."""
    half, d_count = params.window // 2, params.num_disparities
    wc = ws + 2 * half
    p0 = d_count  # = xh - half
    ref_c, valid_c = ref[..., p0:p0 + wc], valid[..., p0:p0 + wc]

    def cost_at(d: int) -> torch.Tensor:
        off = p0 + d if reference == "right" else p0 - d
        cost = torch.where(valid_c, pixel_cost(ref_c, oth[..., off:off + wc], params.cost), 0)
        return _aggregate(cost, half)[..., half:half + hs, half:half + ws]

    return argmin_subpixel_scan(cost_at, d_count)


def _lr_cols(sh: Shards, dl, dr, params: ModernParams) -> torch.Tensor:
    """LR consistency with the right-view lookup's x reach (dL <=
    num_disparities) met by a left column halo; the global left edge
    holds the out-of-frame sentinel."""
    d_count = params.num_disparities
    halo, _ = exchange_col_halo(dr, d_count, sh, circular=False, fill=_LR_BIG)
    dr_ext = torch.cat([halo, dr], dim=-1)
    ws = dl.shape[-1]
    valid = torch.zeros(dl.shape, dtype=torch.bool, device=dl.device)
    for d in range(d_count):
        dr_shift = dr_ext[..., d_count - d:d_count - d + ws]
        valid |= (dl == d) & ((dr_shift - d).abs() <= params.lr_max_diff)
    return valid


def _median(sh: Shards, plane: torch.Tensor, cols: bool) -> torch.Tensor:
    """3x3 median with a 1-px exchange per sharded axis; the global edges
    replicate (``median3x3`` pads edge-replicated)."""
    hs, w = plane.shape[-2:]
    ext = with_row_halo(plane, 1, sh, circular=False)
    top, bot = ext[..., :1, :].clone(), ext[..., hs + 1:, :].clone()
    if sh.first(ROWS_AXIS):
        top[:1] = ext[:1, ..., 1:2, :]
    if sh.last(ROWS_AXIS):
        bot[-1:] = ext[-1:, ..., hs:hs + 1, :]
    ext = torch.cat([top, plane, bot], dim=-2)
    if not cols:
        return costvolume.median3x3(ext)[..., 1:1 + hs, :]
    cext = with_col_halo(ext, 1, sh, circular=False)
    lcol, rcol = cext[..., :1].clone(), cext[..., w + 1:].clone()
    if sh.first(COLS_AXIS):
        lcol[:, :1] = cext[:, :1, ..., 1:2]
    if sh.last(COLS_AXIS):
        rcol[:, -1:] = cext[:, -1:, ..., w:w + 1]
    ext = torch.cat([lcol, ext, rcol], dim=-1)
    return costvolume.median3x3(ext)[..., 1:1 + hs, 1:1 + w]


def _fill(sh: Shards, sub, valid, params: ModernParams, cols: bool) -> torch.Tensor:
    """The hole fill per ``fill_mode``: the background extension is x-only
    (inside the shard, cols=1); the diffusion runs one K6 sweep per 1-px
    exchange on each sharded axis (zero fill at the global edge)."""
    if params.fill_mode == "background":
        return costvolume.fill_background(sub, valid)
    d = sub.to(torch.float32)
    v = valid.to(torch.uint8)
    for _ in range(params.fill_iterations):
        d_ext, v_ext = (with_row_halo(x, 1, sh, circular=False) for x in (d, v))
        if cols:
            d_ext, v_ext = (with_col_halo(x, 1, sh, circular=False) for x in (d_ext, v_ext))
        d, v = fill_invalid_step(sh.flat(d_ext).contiguous(), sh.flat(v_ext).contiguous(),
                                 int(cols))
        d, v = sh.unflat(d), sh.unflat(v)
    return d


def _finish(sh: Shards, dl: DisparityResult, dr_disp, params: ModernParams,
            cols: bool, lr_check: Callable) -> Outputs:
    disp, sub, dr = dl.disparity, dl.subpixel, dr_disp
    if params.median_filter:
        disp, sub, dr = (_median(sh, x, cols) for x in (disp, sub, dr))
    valid = lr_check(disp, dr)
    return {
        "disparity": disp,
        "subpixel": sub,
        "disparity_right": dr,
        "valid": valid,
        "filled": _fill(sh, sub, valid, params, cols),
        "cost": dl.cost,
    }


def _lr_local(params: ModernParams):
    return functools.partial(costvolume.lr_consistency, max_diff=params.lr_max_diff,
                             num_disparities=params.num_disparities)


def _box_shard_forward(sh: Shards, left, right, params: ModernParams) -> Outputs:
    """Rows-only box route: K7 on the halo blocks (the block is its
    "image": the halo rows' outputs are dropped, the out-of-global rows
    are pre-zeroed so their costs vanish)."""
    hs, half = sh.hs, params.window // 2
    lx, rx = _prepare_cost_blocks(sh, left.to(torch.int32), right.to(torch.int32), params)
    lx, rx = sh.flat(lx).contiguous(), sh.flat(rx).contiguous()

    kernel, _ = modern_kernels_supported(params)["disparity"]
    disparity = fused_modern.disparity if kernel else fused_modern.disparity_reference

    def one_view(reference):
        ref, oth = (lx, rx) if reference == "left" else (rx, lx)
        res = disparity(ref, oth, params, reference)
        return DisparityResult(*(sh.unflat(x[:, half:half + hs].contiguous()) for x in res))

    dl, dr = one_view("left"), one_view("right")
    return _finish(sh, dl, dr.disparity, params, False, _lr_local(params))


def _box_shard_forward_2d(sh: Shards, left, right, params: ModernParams) -> Outputs:
    """2-D (rows x cols) box route, torch ops with K6's sweeps."""
    lx, rx, valid = _prepare_cost_blocks_2d(
        sh, left.to(torch.int32), right.to(torch.int32), params)
    dl = _disparity_block_2d(lx, rx, valid, params, "left", sh.hs, sh.ws)
    dr = _disparity_block_2d(rx, lx, valid, params, "right", sh.hs, sh.ws)
    return _finish(sh, dl, dr.disparity, params, True,
                   lambda a, b: _lr_cols(sh, a, b, params))


def _census_blocks_sgm(sh: Shards, left, right, params: ModernParams):
    """The SGM route's cost inputs: census codes (a census-window halo
    exchange, edge-replicated at the global y edge) or the raw
    intensities for SAD -> two [lr, lc, n, hs, W] int32 blocks."""
    if params.cost != "census":
        return left, right
    hs, ch = sh.hs, params.census_window // 2
    g = _global_rows(sh, -ch, hs + 2 * ch)
    h_global = sh.n_rows * hs

    def prep(x):
        ext = with_row_halo(x, ch, sh, circular=False)
        ext = torch.where(g < 0, ext[..., ch:ch + 1, :], ext)
        ext = torch.where(g >= h_global, ext[..., ch + hs - 1:ch + hs, :], ext)
        return census_transform(ext, params.census_window)[..., ch:ch + hs, :]

    return prep(left), prep(right)


def _sgm_chain(sh: Shards, vol, agg, direction: int, p1: int, p2: int,
               directional: Callable = fused_sgm.sgm_directional) -> None:
    """Both walks of a column or diagonal path over row shards, added into
    ``agg``: in global phase j the shard on row j walks top-down and the
    shard on row n - 1 - j bottom-up, each one K4 launch over the block's
    images at that row position, seeded with the carry of the shard
    before it.  Where a walk leaves a block, every block shifts its carry
    to its row neighbour (the JAX tier's ppermute): the same exchanges in
    the same order on every block, so point-to-point sends cannot
    deadlock.  Equal to one pass over the unsharded columns.
    vol / agg: [lr * n, hs, W, D] (cols = 1); ``directional`` is K4's
    wrapper or its plain version (``fused_sgm.sgm_directional_plain``)."""
    n, lr, r0, nr = sh.n, sh.lr, sh.r0, sh.n_rows
    zero = torch.zeros((n, vol.shape[-2], vol.shape[-1]), dtype=torch.int32, device=vol.device)
    seeds = {False: None, True: None}
    for j in range(nr):
        for reverse, pos in ((False, j), (True, nr - 1 - j)):
            local = pos - r0
            if 0 <= local < lr:
                rows = slice(local * n, (local + 1) * n)
                _, seeds[reverse] = directional(
                    vol[rows], agg[rows], p1, p2, direction, reverse, accumulate=True,
                    seed=seeds[reverse], with_carry=True)
        if j == nr - 1:
            break
        # The top-down walk leaves a block after row j when j + 1 starts
        # the next one; the bottom-up walk after row nr - 1 - j when that
        # row starts a block.
        for reverse, crossing in ((False, (j + 1) % lr == 0), (True, (nr - 1 - j) % lr == 0)):
            if crossing:
                carry = zero if seeds[reverse] is None else seeds[reverse]
                seeds[reverse] = sh.comm.shift(carry, 1, -1 if reverse else 1, False)


def _sgm_shard_forward(sh: Shards, left, right, params: ModernParams) -> Outputs:
    """Rows-only SGM route: the volume (K3), the horizontal paths (K4 over
    the whole block), the column and diagonal paths (the seeded K4
    chain), the tail (K5), then the median, LR and fill."""
    d_count, p1, p2 = params.num_disparities, params.sgm_p1, params.sgm_p2
    ref, other = _census_blocks_sgm(sh, left.to(torch.int32), right.to(torch.int32), params)
    vol = fused_sgm.sgm_volume(sh.flat(ref).contiguous(), sh.flat(other).contiguous(),
                               d_count, params.cost, _sgm_storage_dtype(params))
    del ref, other
    agg = torch.empty(vol.shape, dtype=_sgm_out_dtype(params), device=vol.device)
    kernel, _ = modern_kernels_supported(params)["aggregate"]
    directional = fused_sgm.sgm_directional if kernel else fused_sgm.sgm_directional_plain
    directional(vol, agg, p1, p2, sgm.X, False, accumulate=False)
    directional(vol, agg, p1, p2, sgm.X, True, accumulate=True)
    directions = [sgm.Y] + ([sgm.DIAG_PLUS, sgm.DIAG_MINUS] if params.sgm_directions == 8 else [])
    for direction in directions:
        _sgm_chain(sh, vol, agg, direction, p1, p2, directional)
    del vol
    outs = [sh.unflat(x) for x in fused_sgm.sgm_tail(agg, params.uniqueness)]
    del agg
    disp, sub, cost, dr = outs[:4]
    out = _finish(sh, DisparityResult(disp, sub, cost), dr, params, False, _lr_local(params))
    if params.uniqueness:
        out["uniqueness"] = _uniqueness_ratio(outs[4], cost)
    return out


def _validate(shape, params: ModernParams, mesh: Mesh) -> None:
    """The JAX tier's conditions (``parallel/modern.py:876-917``)."""
    if params.scales != 1:
        raise ValueError(
            "sharded modern tier supports scales=1 (the half-resolution "
            "pyramid does not row-shard evenly)")
    n_rows, n_cols = mesh.dims[1], mesh_cols(mesh)
    h, w = shape[1], shape[2]
    hs = h // n_rows
    if params.aggregation == "sgm":
        reach = params.census_window // 2 if params.cost == "census" else 0
    else:
        reach = _cost_reach(params)
    if h % n_rows or hs < max(reach, 1):
        raise ValueError(
            f"height {h} must split into >= {max(reach, 1)}-row shards "
            f"across {n_rows} row shards (halo reach {reach})")
    if COLS_AXIS in mesh.axis_names:
        if params.aggregation == "sgm" and n_cols > 1:
            raise ValueError(
                "sharded modern SGM supports rows-only spatial meshes "
                "(the horizontal recurrence crosses col shards); use "
                "cols=1 or box aggregation")
        if params.fill_mode == "background" and n_cols > 1:
            raise ValueError(
                "fill_mode='background' is a global x scanline scan -- "
                "it does not col-shard; use cols=1 or diffusion fill")
        wsz = w // n_cols
        ch = params.census_window // 2 if params.cost == "census" else 0
        x_reach = params.num_disparities + params.window // 2 + ch
        if w % n_cols or wsz < max(x_reach, 1):
            raise ValueError(
                f"width {w} must split into >= {max(x_reach, 1)}-column "
                f"shards across {n_cols} col shards (x halo reach "
                f"{x_reach} = num_disparities + window//2 + census margin)")


def sharded_modern_forward(left, right, params: ModernParams, mesh: Mesh
                           ) -> Dict[str, Sharded]:
    """The modern pipeline on a batch [B, H, W] of integer pixel planes
    sharded over ``mesh`` (global tensors or numpy, or ``Sharded``
    planes of ``mesh``).  B must divide by the data axis, H by the rows
    axis; the shard height must cover the cost phase's y reach
    (window//2 + census_window//2 on the box route, the census
    neighbourhood alone on SGM, whose column paths run as a phased carry
    chain instead).  ``scales=1`` only; SGM and the background fill on
    rows-only meshes.  -> the output dict of the single-device pipeline
    as sharded ``PLANE`` arrays, equal to it bit for bit after
    ``to_global``."""
    left, right = (x if isinstance(x, Sharded) else _as_tensor(x) for x in (left, right))
    if left.dtype.is_floating_point or right.dtype.is_floating_point:
        raise ValueError("sharded_modern_forward takes integer pixel planes 0..255")
    _validate(tuple(left.shape), params, mesh)
    left, right = _sharded_input(left, mesh), _sharded_input(right, mesh)
    # The SAD range check on the blocks this process holds, their extremes
    # reduced across ranks so that every rank decides alike.
    check_sad_pixels(left, right, params, lambda x: (x.reduce("min"), x.reduce("max")))
    if params.aggregation == "sgm":
        body = _sgm_shard_forward
    elif mesh_cols(mesh) > 1:
        body = _box_shard_forward_2d
    else:
        body = _box_shard_forward
    return sharded_forward(mesh, left, right,
                           lambda sh, lb, rb: body(sh, lb, rb, params))


def build_sharded_modern_pipeline(
    params: ModernParams, mesh: Mesh
) -> Callable[..., Dict[str, Sharded]]:
    """The sharded modern pipeline for fixed params and mesh: [B, H, W]
    integer pixel batches (global tensors, numpy, or ``Sharded`` planes
    of ``mesh``) -> the single-device output dict as sharded arrays on
    the mesh's blocks (``mesh.outputs_to_global`` gathers it)."""
    return torch.no_grad()(functools.partial(sharded_modern_forward, params=params, mesh=mesh))
