"""The classic pipeline's two matching kernels (counterpart of
``stereomatching_tpu/ops/fused.py``):

* ``match_score_edges`` (K1, ``csrc/match_score_edges.cu``): exact-rule
  edges, per-shift match, square box score and last-wins argmax in one
  kernel, brightness in (``match_score_edges_pallas``);
* ``match_and_score`` (K8, ``csrc/match_and_score.cu``): the same match,
  score and argmax from two given edge maps, the route of the
  ``"reference"`` edge rule (``match_and_score_pallas``);
* ``match_and_score_prehalo`` (K9, a second entry of
  ``csrc/match_and_score.cu``): K8 on row shards whose y halo rows were
  already exchanged, the sharded classic tier's per-shard kernel
  (``match_and_score_pallas_prehalo``).

Both take ``subpixel=True`` for the parabola-refined float32 plane of
``ops.argmax.match_and_score_subpixel``.  Each runs its CUDA kernel on
CUDA tensors and its plain torch version on CPU tensors
(``match_score_edges_reference``; ``ops.argmax.match_and_score`` and
``match_and_score_subpixel`` for K8; ``match_and_score_prehalo_reference``
for K9).  A failed build or launch raises;
nothing falls back.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.ops import argmax
from stereomatching_tpu_torch.ops.aggregate import box_sum_padded
from stereomatching_tpu_torch.ops.edges import find_edges
from stereomatching_tpu_torch.utils import tracing

MAX_SMEM_BYTES = 232448  # the sm_90 per-block opt-in limit
MAX_SQUARE_WIDTH = 255  # the JAX kernels' limit (fused.py:722)
MAX_SHIFTS = 65535  # the kernels pack best << 16 | winner in one word

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entries: (argtypes); each returns an int, a CUDA error (the shared
# memory entry: bytes per block, held against the mirror below by the CUDA
# tests).
_SIGNATURES = {
    "match_score_edges": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P],
    "match_score_edges_smem_bytes": [_I, _I],
    "match_and_score": [_P] * 5 + [_I] * 6 + [_P],
    "match_and_score_prehalo": [_P] * 4 + [_I] * 9 + [_P, _I, _P, _I, _P],
}
# The C entries of each library.
_ENTRIES = {"match_score_edges": ("match_score_edges", "match_score_edges_smem_bytes"),
            "match_and_score": ("match_and_score", "match_and_score_prehalo")}
# The tracing counter of each entry ``_launch`` calls.
_COUNTERS = {"match_score_edges": "launches.K1", "match_and_score": "launches.K8"}


def match_score_edges_smem_bytes(half: int, num_shifts: int) -> int:
    """Shared memory per block of K1, K8 and K9: a mirror of the ``layout``
    arithmetic of ``csrc/match_loop.cuh`` (the taller, 128-row tile), so
    that a route can be chosen from the config alone.  Each of the tile's
    128 + 2*half rows holds a left and a validity row of lst = (128 +
    2*half)/32 + 1 words, two match-plane rows of lst word pairs, and a
    right row (D - 1)/32 + 1 words longer than lst."""
    rows = 128 + 2 * half
    lst = (128 + 2 * half + 31) // 32 + 1
    rst = lst + (num_shifts - 1) // 32 + 1
    return 4 * rows * (6 * lst + rst)


def kernel_refusal(params: StereoParams) -> str:
    """Why the classic matching kernels (K1, K8 and K9, which share one
    layout and so one set of limits) do not take ``params``, or "" when
    they do: square_width above 255, more than 65535 shifts (the packed
    winner), or more shared memory per block than the card's 232448
    bytes.  Pure Python: no library is loaded."""
    sw, d = params.square_width, params.num_shifts
    if sw > MAX_SQUARE_WIDTH:
        return f"square_width {sw} > {MAX_SQUARE_WIDTH}"
    if d > MAX_SHIFTS:
        return f"num_shifts {d} > {MAX_SHIFTS}"
    smem = match_score_edges_smem_bytes(params.half, d)
    if smem > MAX_SMEM_BYTES:
        return (f"square_width {sw} with {d} shifts needs {smem} B of shared memory "
                f"per block (limit {MAX_SMEM_BYTES})")
    return ""


def match_score_edges_reference(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams, subpixel: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain torch: exact-rule edges, then ``match_and_score`` (or
    ``match_and_score_subpixel``) -> (best, winner, edges_l, edges_r),
    int32 [..., H, W], and with ``subpixel`` the float32 plane."""
    edges_l = find_edges(left, params.threshold, params.mode, "exact")
    edges_r = find_edges(right, params.threshold, params.mode, "exact")
    best, winner, *sub = _match_and_score_reference(edges_l, edges_r, params, subpixel)
    return (best, winner, edges_l, edges_r, *sub)


def _match_and_score_reference(edges_l, edges_r, params: StereoParams, subpixel: bool):
    if subpixel:
        return argmax.match_and_score_subpixel(edges_l, edges_r, params)
    return argmax.match_and_score(edges_l, edges_r, params)


def match_and_score_reference(
    edges_l: torch.Tensor, edges_r: torch.Tensor, params: StereoParams, subpixel: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain torch on any device: ``ops.argmax.match_and_score`` (or
    ``match_and_score_subpixel``) on the edge maps read as 0/1 (non-zero
    is an edge, as K8 stages them)."""
    binary = [e.ne(0).to(torch.int32) for e in (edges_l, edges_r)]
    return _match_and_score_reference(*binary, params, subpixel)


@functools.cache
def _lib(name: str = "match_score_edges") -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load(name)
    for entry in _ENTRIES[name]:
        getattr(lib, entry).argtypes = _SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def _on_cpu(left: torch.Tensor, right: torch.Tensor) -> bool:
    """True for CPU inputs (plain version), False for CUDA inputs
    (kernel); raises for mixed or other devices."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return True
    if left.device != right.device:
        raise ValueError(f"inputs on {left.device} and {right.device}")
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    return False


def _launch(name: str, left, right, dtype, params: StereoParams, n_int: int,
            subpixel: bool, *extra):
    """Check the inputs, launch ``name`` on them -> its ``n_int`` int32
    planes (+ the float32 sub-pixel plane), shaped like the inputs."""
    if left.shape != right.shape or left.ndim not in (2, 3):
        raise ValueError(
            f"need two equal [H, W] or [B, H, W] shapes, got "
            f"{tuple(left.shape)} and {tuple(right.shape)}"
        )
    for t in (left, right):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous {dtype} inputs, got {t.dtype}")
    why = kernel_refusal(params)
    if why:
        raise ValueError(f"{name}: {why}")
    squeeze = left.ndim == 2
    if squeeze:
        left, right = left[None], right[None]
    bsz, h, w = left.shape
    if bsz > 65535:
        raise ValueError(f"{name} takes at most 65535 images, got {bsz}")
    lib = _lib(name)
    outs = [torch.empty((bsz, h, w), dtype=torch.int32, device=left.device)
            for _ in range(n_int)]
    sub = (torch.empty((bsz, h, w), dtype=torch.float32, device=left.device)
           if subpixel else None)
    tracing.count(_COUNTERS[name])
    with torch.cuda.device(left.device):
        err = getattr(lib, name)(
            left.data_ptr(), right.data_ptr(), *[o.data_ptr() for o in outs],
            None if sub is None else sub.data_ptr(),
            bsz, h, w, params.half, params.num_shifts,
            int(params.mode == BoundaryMode.GHOST), *extra,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if sub is not None:
        outs.append(sub)
    return tuple(o[0] for o in outs) if squeeze else tuple(outs)


def match_score_edges(
    left: torch.Tensor,
    right: torch.Tensor,
    params: StereoParams,
    subpixel: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Brightness [H, W] or [B, H, W] in [0, 1) -> (best_scores,
    winning_shifts, edges_l, edges_r), int32, same shape, and with
    ``subpixel`` the float32 sub-pixel plane.  Requires
    ``edge_rule="exact"``.  CPU tensors run the plain version, CUDA
    tensors K1."""
    if params.edge_rule != "exact":
        raise ValueError("match_score_edges requires edge_rule='exact'")
    if _on_cpu(left, right):
        return match_score_edges_reference(left, right, params, subpixel)
    outs = _launch("match_score_edges", left, right, torch.float32, params, 4, subpixel,
                   ctypes.c_float(params.threshold))
    match_score_edges.launches += 1
    return outs


match_score_edges.launches = 0


def match_and_score(
    edges_l: torch.Tensor,
    edges_r: torch.Tensor,
    params: StereoParams,
    subpixel: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Edge maps [H, W] or [B, H, W] (int32; a non-zero cell is an edge,
    on both devices) -> (best_scores, winning_shifts), int32, same shape,
    and with ``subpixel`` the float32 sub-pixel plane; both boundary
    modes.  CPU tensors run the plain version (``ops.argmax.
    match_and_score`` / ``match_and_score_subpixel``) on the maps as 0/1,
    CUDA tensors K8, which stages them as bit rows."""
    if _on_cpu(edges_l, edges_r):
        return match_and_score_reference(edges_l, edges_r, params, subpixel)
    outs = _launch("match_and_score", edges_l, edges_r, torch.int32, params, 2, subpixel)
    match_and_score.launches += 1
    return outs


match_and_score.launches = 0


def _prehalo_rows(x: torch.Tensor, halo: int, half: int) -> torch.Tensor:
    """A halo block's rows trimmed to ``half`` halo rows per side."""
    return x[:, halo - half: x.shape[1] - (halo - half)]


def match_and_score_prehalo_reference(
    l_blk: torch.Tensor, r_blk: torch.Tensor, params: StereoParams, halo: int,
    row0: torch.Tensor, h_global: int, col0: torch.Tensor | None = None,
    w_global: int | None = None, pre_extended: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: the XLA scan branch of the JAX sharded tier's shard
    body (``stereomatching_tpu/parallel/pipeline.py:166-196``) on the
    same halo blocks as ``match_and_score_prehalo`` -> (best, winner),
    int32 [B, hs, W].  The ghost-mode validity mask comes from ``row0``
    / ``col0`` (each image's global row / column of block row / column
    0); the box sums pad x by wrapping (wrap mode) or with zeros."""
    half, d = params.half, params.num_shifts
    _check_prehalo(l_blk, r_blk, params, halo, pre_extended)
    b, rows_in, w = l_blk.shape
    hs = rows_in - 2 * halo
    l_ext, r_ext = (_prehalo_rows(x, halo, half).ne(0).to(torch.int32)
                    for x in (l_blk, r_blk))
    wrap = params.mode == BoundaryMode.WRAP and not pre_extended
    valid = None
    if params.mode == BoundaryMode.GHOST:
        dev = l_blk.device
        gy = row0.to(dev)[:, None] + (halo - half) + torch.arange(hs + 2 * half, device=dev)
        c0 = torch.zeros_like(row0) if col0 is None else col0
        gx = c0.to(dev)[:, None] + torch.arange(w, device=dev)
        wg = w if w_global is None else w_global
        valid = (((gy >= 0) & (gy < h_global))[:, :, None]
                 & ((gx >= 0) & (gx < wg))[:, None, :]).to(torch.int32)
    xs = torch.arange(w, device=l_blk.device)
    best = torch.zeros((b, hs, w), dtype=torch.int32, device=l_blk.device)
    winner = torch.zeros_like(best)
    for i in range(d):
        r_i = r_ext[..., (xs + i) % w] if wrap else r_ext[..., i:i + w]
        match_ext = (l_ext == r_i).to(torch.int32)
        if valid is not None:
            match_ext = match_ext * valid
        padded = (match_ext[..., (torch.arange(-half, w + half, device=xs.device) % w)]
                  if wrap else torch.nn.functional.pad(match_ext, (half, half)))
        sums = box_sum_padded(padded, half)
        score = torch.where(match_ext[:, half:half + hs] == 1, sums, 0)
        winner = torch.where(score >= best, i + 1, winner)
        best = torch.maximum(best, score)
    return best, winner


def _check_prehalo(l_blk, r_blk, params: StereoParams, halo: int, pre_extended: bool):
    if halo < params.half:
        raise ValueError(f"halo {halo} < square_width//2 {params.half}")
    if l_blk.ndim != 3 or r_blk.ndim != 3 or l_blk.shape[:2] != r_blk.shape[:2]:
        raise ValueError(f"need halo blocks [B, hs + 2*halo, W] and [B, hs + 2*halo, WR], "
                         f"got {tuple(l_blk.shape)} and {tuple(r_blk.shape)}")
    if l_blk.shape[1] - 2 * halo < 1:
        raise ValueError(f"halo block of {l_blk.shape[1]} rows has no interior at halo {halo}")
    wrap = params.mode == BoundaryMode.WRAP and not pre_extended
    if not wrap and r_blk.shape[2] < l_blk.shape[2] + params.num_shifts:
        raise ValueError(f"right block width {r_blk.shape[2]} < W + num_shifts "
                         f"{l_blk.shape[2] + params.num_shifts}")


def match_and_score_prehalo(
    l_blk: torch.Tensor, r_blk: torch.Tensor, params: StereoParams, halo: int,
    row0: torch.Tensor, h_global: int, col0: torch.Tensor | None = None,
    w_global: int | None = None, pre_extended: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on row-shard halo blocks (the sharded classic tier):
    ``l_blk`` [B, hs + 2*halo, W] and ``r_blk`` [B, hs + 2*halo, WR]
    int32 edge maps (non-zero = edge) whose ``halo`` >= square_width//2
    rows per side came from the neighbouring shards, ``r_blk`` extended
    in x past W by at least num_shifts columns (wrap mode reads its first
    W columns modulo W) -> (best, winner) int32 [B, hs, W].  In ghost
    mode left cells outside the global ``h_global`` x ``w_global`` image
    never match: image b's block row 0 is global row ``row0[b]`` (and its
    column 0 global column ``col0[b]``; default 0 and W).  With
    ``pre_extended`` (the 2-D tier) the x halos are part of the blocks:
    no x wrap, the columns past the blocks pad as in ghost mode.  CPU
    tensors run the plain version, CUDA tensors K9."""
    if _on_cpu(l_blk, r_blk):
        return match_and_score_prehalo_reference(
            l_blk, r_blk, params, halo, row0, h_global, col0, w_global, pre_extended)
    _check_prehalo(l_blk, r_blk, params, halo, pre_extended)
    for t in (l_blk, r_blk):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"match_and_score_prehalo takes contiguous int32 blocks, got {t.dtype}")
    why = kernel_refusal(params)
    if why:
        raise ValueError(f"match_and_score_prehalo: {why}")
    b, rows_in, w = l_blk.shape
    if b > 65535:
        raise ValueError(f"match_and_score_prehalo takes at most 65535 images, got {b}")
    lib = _lib("match_and_score")
    dev = l_blk.device
    row0 = row0.to(dev, torch.int32).contiguous()
    col0 = (torch.zeros_like(row0) if col0 is None else col0.to(dev, torch.int32).contiguous())
    hs = rows_in - 2 * halo
    best, winner = (torch.empty((b, hs, w), dtype=torch.int32, device=dev) for _ in range(2))
    wrap = params.mode == BoundaryMode.WRAP and not pre_extended
    tracing.count("launches.K9")
    with torch.cuda.device(dev):
        err = lib.match_and_score_prehalo(
            l_blk.data_ptr(), r_blk.data_ptr(), best.data_ptr(), winner.data_ptr(),
            b, rows_in, w, r_blk.shape[2], halo, params.half, params.num_shifts,
            int(wrap), int(params.mode == BoundaryMode.GHOST), row0.data_ptr(), h_global,
            col0.data_ptr(), w if w_global is None else w_global,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"match_and_score_prehalo kernel launch failed: CUDA error {err}")
    match_and_score_prehalo.launches += 1
    return best, winner


match_and_score_prehalo.launches = 0
