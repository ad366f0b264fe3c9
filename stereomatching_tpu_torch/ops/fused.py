"""Classic phases 1-2 in one kernel: exact-rule edges, per-shift match,
square box score and last-wins argmax (counterpart of
``stereomatching_tpu/ops/fused.py::match_score_edges_pallas``).

``match_score_edges`` runs the CUDA kernel ``csrc/match_score_edges.cu``
on CUDA tensors and its plain torch version,
``match_score_edges_reference``, on CPU tensors.  A failed build or
launch raises; nothing falls back.  ``match_score_edges.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.ops.argmax import match_and_score
from stereomatching_tpu_torch.ops.edges import find_edges

MAX_SMEM_BYTES = 232448  # the sm_90 per-block opt-in limit


def match_score_edges_reference(
    left: torch.Tensor, right: torch.Tensor, params: StereoParams
) -> Tuple[torch.Tensor, ...]:
    """Plain torch: exact-rule edges, then ``match_and_score``
    -> (best, winner, edges_l, edges_r), int32 [..., H, W]."""
    edges_l = find_edges(left, params.threshold, params.mode, "exact")
    edges_r = find_edges(right, params.threshold, params.mode, "exact")
    best, winner = match_and_score(edges_l, edges_r, params)
    return best, winner, edges_l, edges_r


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load("match_score_edges")
    lib.match_score_edges.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.match_score_edges.restype = ctypes.c_int
    lib.match_score_edges_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.match_score_edges_smem_bytes.restype = ctypes.c_int
    return lib


def _launch(left: torch.Tensor, right: torch.Tensor, params: StereoParams):
    if left.device != right.device:
        raise ValueError(f"inputs on {left.device} and {right.device}")
    if left.shape != right.shape or left.ndim not in (2, 3):
        raise ValueError(
            f"need two equal [H, W] or [B, H, W] shapes, got "
            f"{tuple(left.shape)} and {tuple(right.shape)}"
        )
    for t in (left, right):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("inputs must be contiguous float32 brightness")
    squeeze = left.ndim == 2
    if squeeze:
        left, right = left[None], right[None]
    bsz, h, w = left.shape
    lib = _lib()
    smem = lib.match_score_edges_smem_bytes(params.half, params.num_shifts)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"square_width {params.square_width} with {params.num_shifts} "
            f"shifts needs {smem} B of shared memory per block "
            f"(limit {MAX_SMEM_BYTES})"
        )
    outs = [torch.empty((bsz, h, w), dtype=torch.int32, device=left.device)
            for _ in range(4)]
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.match_score_edges(
            left.data_ptr(), right.data_ptr(), *[o.data_ptr() for o in outs],
            bsz, h, w, params.half, params.num_shifts,
            int(params.mode == BoundaryMode.GHOST),
            ctypes.c_float(params.threshold), stream,
        )
    if err:
        raise RuntimeError(f"match_score_edges kernel launch failed: CUDA error {err}")
    match_score_edges.launches += 1
    return tuple(o[0] for o in outs) if squeeze else tuple(outs)


def match_score_edges(
    left: torch.Tensor,
    right: torch.Tensor,
    params: StereoParams,
    subpixel: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Brightness [H, W] or [B, H, W] in [0, 1) -> (best_scores,
    winning_shifts, edges_l, edges_r), int32, same shape.  Requires
    ``edge_rule="exact"``.  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if subpixel:
        raise NotImplementedError(
            "the sub-pixel output of match_score_edges is not ported yet"
        )
    if params.edge_rule != "exact":
        raise ValueError("match_score_edges requires edge_rule='exact'")
    if left.device.type == "cpu" and right.device.type == "cpu":
        return match_score_edges_reference(left, right, params)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    return _launch(left, right, params)


match_score_edges.launches = 0
