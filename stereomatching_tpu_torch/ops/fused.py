"""The classic pipeline's two matching kernels (counterpart of
``stereomatching_tpu/ops/fused.py``):

* ``match_score_edges`` (K1, ``csrc/match_score_edges.cu``): exact-rule
  edges, per-shift match, square box score and last-wins argmax in one
  kernel, brightness in (``match_score_edges_pallas``);
* ``match_and_score`` (K8, ``csrc/match_and_score.cu``): the same match,
  score and argmax from two given edge maps, the route of the
  ``"reference"`` edge rule (``match_and_score_pallas``).

Both take ``subpixel=True`` for the parabola-refined float32 plane of
``ops.argmax.match_and_score_subpixel``.  Each runs its CUDA kernel on
CUDA tensors and its plain torch version on CPU tensors
(``match_score_edges_reference``; ``ops.argmax.match_and_score`` and
``match_and_score_subpixel`` for K8).  A failed build or launch raises;
nothing falls back.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.ops import argmax
from stereomatching_tpu_torch.ops.edges import find_edges

MAX_SMEM_BYTES = 232448  # the sm_90 per-block opt-in limit
MAX_SQUARE_WIDTH = 255  # the JAX kernels' limit (fused.py:722)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry of each source: (argtypes); each returns a CUDA error.
_SIGNATURES = {
    "match_score_edges": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P],
    "match_and_score": [_P] * 5 + [_I] * 6 + [_P],
}


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


@functools.cache
def _lib(name: str = "match_score_edges") -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load(name)
    getattr(lib, name).argtypes = _SIGNATURES[name]
    getattr(lib, name).restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
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
    if params.square_width > MAX_SQUARE_WIDTH:
        raise ValueError(
            f"{name} takes square_width <= {MAX_SQUARE_WIDTH}, got {params.square_width}")
    squeeze = left.ndim == 2
    if squeeze:
        left, right = left[None], right[None]
    bsz, h, w = left.shape
    if bsz > 65535:
        raise ValueError(f"{name} takes at most 65535 images, got {bsz}")
    lib = _lib(name)
    smem = getattr(lib, f"{name}_smem_bytes")(params.half, params.num_shifts)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"square_width {params.square_width} with {params.num_shifts} "
            f"shifts needs {smem} B of shared memory per block "
            f"(limit {MAX_SMEM_BYTES})"
        )
    outs = [torch.empty((bsz, h, w), dtype=torch.int32, device=left.device)
            for _ in range(n_int)]
    sub = (torch.empty((bsz, h, w), dtype=torch.float32, device=left.device)
           if subpixel else None)
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
    CUDA tensors K8, which stages them as 0/1 bytes."""
    if _on_cpu(edges_l, edges_r):
        binary = [e.ne(0).to(torch.int32) for e in (edges_l, edges_r)]
        return _match_and_score_reference(*binary, params, subpixel)
    outs = _launch("match_and_score", edges_l, edges_r, torch.int32, params, 2, subpixel)
    match_and_score.launches += 1
    return outs


match_and_score.launches = 0
