"""The classic pipeline sharded over a (data, rows[, cols]) mesh
(counterpart of ``stereomatching_tpu/parallel/pipeline.py``; the
reference's ghost-area programs, ``src/stereo-ghost.c``).

Batches shard over "data", rows over "rows" (and columns over "cols");
every dependency across a shard edge is one halo exchange of exactly its
reach (the reference's halo-width rule, src/stereo-ghost.c:11-12):

  phase                      reach     exchange
  edges (3x3 stencil)        1         once, on the padded brightness
  match + box + argmax       sw//2     once, on the edge maps (the match
                             (+ D in x) planes of the halo rows are recomputed)
  diffusion (4 neighbours)   1         per Jacobi step, on the web
  contour min/max            global    a per-image max / min over the shards

Per block of shards (``mesh.Shards``) each stage is one launch over all
the block's shards: the edges are torch ops on the halo blocks, the match
/ box / argmax is ``match_and_score_prehalo`` (K9) and each diffusion step
``fill_web_holes_step`` (K2's step kernel), the CUDA kernels on CUDA
shards and their plain versions on CPU shards; a config K9 does not take
(``models.classic.classic_kernels_supported(params, sharded=True)``)
runs K9's plain version on the CUDA shards too.  Both boundary modes are
exact, and the artifacts equal the single-device pipeline's for every
mesh shape.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.config import (
    GHOST_BRIGHTNESS_FILL, BoundaryMode, StereoParams)
from stereomatching_tpu_torch.ops.contour import contour_bands
from stereomatching_tpu_torch.ops.edges import find_edges_padded
from stereomatching_tpu_torch.models.classic import classic_kernels_supported
from stereomatching_tpu_torch.ops.fused import (
    match_and_score_prehalo, match_and_score_prehalo_reference)
from stereomatching_tpu_torch.ops.fused_diffusion import fill_web_holes_step
from stereomatching_tpu_torch.ops.matching import extend_right_edges
from stereomatching_tpu_torch.parallel.halo import (
    exchange_col_halo, with_col_halo, with_row_halo)
from stereomatching_tpu_torch.parallel.mesh import (
    COLS_AXIS, PER_IMAGE, PLANE, ROWS_AXIS, Mesh, Sharded, Shards, _as_tensor, mesh_cols, run)

Artifacts = Dict[str, torch.Tensor]


def _pad_x(x: torch.Tensor, pad: int, mode: BoundaryMode, fill: float = 0) -> torch.Tensor:
    """Pad the unsharded x axis locally: wrap (W is whole on every shard)
    or a constant fill."""
    if mode == BoundaryMode.WRAP:
        w = x.shape[-1]
        return x[..., torch.arange(-pad, w + pad, device=x.device) % w]
    return F.pad(x, (pad, pad), value=fill)


def _web_steps(sh: Shards, winner: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` Jacobi steps of the web diffusion, each after a 1-row
    exchange (open, zero fill: the reference's flat neighbours never
    wrap); on a 2-D mesh also a 1-column circular exchange whose columns
    are row-shifted at the global x edge, the flat index's wrap into the
    neighbouring row (``parallel/pipeline.py:222-259`` of the JAX
    package).  winner: block [lr, lc, n, hs, ws]."""
    x_off = 1 if sh.has_cols else 0
    prev = cur = sh.flat(winner)
    for _ in range(steps):
        ext = with_row_halo(sh.unflat(cur), 1, sh, circular=False)
        if sh.has_cols:
            lcol, rcol = exchange_col_halo(ext, 1, sh, circular=True)
            if sh.first(COLS_AXIS):
                lcol[:, :1] = F.pad(lcol[:, :1, ..., :-1, :], (0, 0, 1, 0))
            if sh.last(COLS_AXIS):
                rcol[:, -1:] = F.pad(rcol[:, -1:, ..., 1:, :], (0, 0, 0, 1))
            ext = torch.cat([lcol, ext, rcol], dim=-1)
        prev, cur = cur, fill_web_holes_step(prev, sh.flat(ext).contiguous(), x_off)
    return sh.unflat(cur)


def prehalo_blocks(sh: Shards, left: torch.Tensor, right: torch.Tensor,
                   params: StereoParams):
    """The edge maps of one block's brightness blocks [lr, lc, n, hs, ws]
    and K9's inputs built from them -> (edges_l, edges_r, K9's keyword
    arguments: the halo blocks, the halo, the shards' global first rows
    and columns, the global extent)."""
    mode = params.mode
    circ = mode == BoundaryMode.WRAP
    half, d = params.half, params.num_shifts
    hs, ws = sh.hs, sh.ws

    # Edges: a 1-px halo in x (local pad, or a col exchange on a 2-D
    # mesh) and then in y, so the stencil's corners arrive from the
    # diagonal neighbour through the row neighbour's block.
    def edges_of(img):
        if sh.has_cols:
            xp = with_col_halo(img, 1, sh, circ, GHOST_BRIGHTNESS_FILL)
        else:
            xp = _pad_x(img, 1, mode, GHOST_BRIGHTNESS_FILL)
        padded = with_row_halo(xp, 1, sh, circ, GHOST_BRIGHTNESS_FILL)
        return find_edges_padded(padded, params.threshold, params.edge_rule)

    edges_l, edges_r = edges_of(left), edges_of(right)

    # Match + box + argmax: one exchange of the edge maps per axis with
    # its reach (x: +-half for the box, a further D to the right for the
    # shift slide), then K9 over every shard of the block.
    if sh.has_cols:
        l_x = with_col_halo(edges_l, half, sh, circ)
        r_x = with_col_halo(edges_r, half, sh, circ, right_halo=half + d)
    else:
        l_x, r_x = edges_l, extend_right_edges(edges_r, d, mode)
    l_ext = sh.flat(with_row_halo(l_x, half, sh, circ)).contiguous()
    r_ext = sh.flat(with_row_halo(r_x, half, sh, circ)).contiguous()
    x_off = half if sh.has_cols else 0
    col0 = sh.flat(sh.offsets(COLS_AXIS, ws, -x_off)) if sh.has_cols else None
    return edges_l, edges_r, dict(
        l_blk=l_ext, r_blk=r_ext, halo=half, row0=sh.flat(sh.offsets(ROWS_AXIS, hs, -half)),
        h_global=sh.n_rows * hs, col0=col0, w_global=sh.n_cols * ws, pre_extended=sh.has_cols)


def _shard_forward(sh: Shards, left: torch.Tensor, right: torch.Tensor,
                   params: StereoParams) -> Artifacts:
    """One block's body: brightness blocks [lr, lc, n, hs, ws] -> the
    block's artifacts (planes [lr, lc, n, hs, ws], per-image min / max
    [lr, lc, n])."""
    ws, x_off = sh.ws, (params.half if sh.has_cols else 0)
    edges_l, edges_r, k9 = prehalo_blocks(sh, left, right, params)
    kernel, _ = classic_kernels_supported(params, sharded=True)
    k9_fn = match_and_score_prehalo if kernel else match_and_score_prehalo_reference
    best, winner = k9_fn(params=params, **k9)
    if sh.has_cols:
        best = best[..., x_off:x_off + ws]
        winner = winner[..., x_off:x_off + ws]
    best, winner = sh.unflat(best.contiguous()), sh.unflat(winner.contiguous())

    web = _web_steps(sh, winner, max(params.times - 1, 0))

    # Contour: the per-image range over every spatial shard.
    max_e = sh.reduce_images(web.amax(dim=(-2, -1)), "max")
    min_e = sh.reduce_images(web.amin(dim=(-2, -1)), "min")
    return {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        "web-2": web,
        "output-0": contour_bands(web, params.lines, min_e, max_e),
        "min_elevation": min_e,
        "max_elevation": max_e,
    }


def _sharded_input(x, mesh: Mesh) -> Sharded:
    """A pipeline input -> a plane laid out on ``mesh``: a global tensor
    or numpy array is placed (``Sharded.from_global``); a sharded one
    must be a plane of the same mesh."""
    if not isinstance(x, Sharded):
        x = _as_tensor(x)
        if x.ndim != 3:
            raise ValueError(f"need [B, H, W] batches, got {tuple(x.shape)}")
        return Sharded.from_global(x, mesh)
    if x.mesh != mesh:
        raise ValueError(f"a sharded input lies on another mesh ({x.mesh}), not {mesh}")
    if x.layout != PLANE:
        raise ValueError(f"a sharded input must be a {PLANE}, not {x.layout}")
    return x


def sharded_forward(mesh: Mesh, left, right, body: Callable) -> Dict[str, Sharded]:
    """Run ``body(shards, left_block, right_block)`` on every block of
    this process -> its outputs as sharded arrays, no plane gathered (the
    JAX tier's ``out_specs``: block tensors [lr, lc, n, hs, ws] become
    planes, [lr, lc, n] per-image values).  ``left`` / ``right``: global
    [B, H, W] tensors or numpy arrays, placed over ``mesh`` first, or
    ``Sharded`` planes of ``mesh`` (a block on another device than its
    own is copied there)."""
    left, right = _sharded_input(left, mesh), _sharded_input(right, mesh)
    if left.shape != right.shape:
        raise ValueError(f"need two equal [B, H, W] batches, got {left.shape} and {right.shape}")
    bl, hs, ws = left.extent

    def block(sh: Shards):
        lb, rb = (x.block(sh.block).to(sh.device) for x in (left, right))
        return body(sh, lb, rb)

    outs = run(mesh, bl, hs, ws, block)
    return {k: Sharded(mesh, left.shape if v.ndim == 5 else left.shape[:1],
                       PLANE if v.ndim == 5 else PER_IMAGE, [o[k] for o in outs])
            for k, v in outs[0].items()}


def sharded_classic_forward(
    left, right, params: StereoParams, mesh: Mesh
) -> Dict[str, Sharded]:
    """The classic pipeline on a batch [B, H, W] of float brightness
    sharded over ``mesh`` (global tensors or numpy, or ``Sharded``
    planes of ``mesh``).  B must divide by the data axis, H
    by the rows axis; the shard height must cover the halo reach
    max(1, square_width // 2).  A (data, rows, cols) mesh also shards W:
    the shard width must cover the x reach num_shifts + square_width//2
    on the right.  -> the artifact dict of the single-device pipeline as
    sharded arrays (the planes ``PLANE``, min / max_elevation
    ``PER_IMAGE``), equal to it bit for bit after ``to_global``."""
    if COLS_AXIS in mesh.axis_names:
        w = (left if isinstance(left, Sharded) else _as_tensor(left)).shape[-1]
        n_cols = mesh_cols(mesh)
        ws = w // n_cols
        reach = params.num_shifts + params.half
        if w % n_cols or ws < max(reach, 1):
            raise ValueError(
                f"width {w} must split into >= {max(reach, 1)}-column "
                f"shards across {n_cols} col shards (x halo reach "
                f"{reach} = num_shifts + square_width//2, "
                "src/stereo-ghost.c:11-12)"
            )
    return sharded_forward(
        mesh, left, right,
        lambda sh, lb, rb: _shard_forward(sh, lb, rb, params))


def build_sharded_pipeline(
    params: StereoParams, mesh: Mesh
) -> Callable[..., Dict[str, Sharded]]:
    """The sharded classic pipeline for fixed params and mesh: [B, H, W]
    brightness batches (global tensors on any device, numpy, or
    ``Sharded`` planes of ``mesh``) -> the single-device artifact dict as
    sharded arrays on the mesh's blocks (``mesh.outputs_to_global``
    gathers it)."""
    return torch.no_grad()(functools.partial(sharded_classic_forward, params=params, mesh=mesh))
