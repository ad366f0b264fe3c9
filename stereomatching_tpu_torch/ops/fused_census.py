"""The census transform of both views as one kernel:

* ``census`` (K10, ``csrc/census.cu``): the census codes of the left
  and the right planes of a request, every image of the batch, in one
  launch.

It replaces no Pallas kernel: the JAX package leaves the census to XLA
(``stereomatching_tpu/ops/costvolume.py`` ``census_transform``), and
its plain version here is ``census_reference``, the torch ops of
``ops.costvolume.census_transform``.  ``census`` runs the plain version
on CPU tensors and the CUDA kernel on CUDA tensors; a failed build or
launch raises, and nothing falls back.  ``census.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.ops.costvolume import census_transform
from stereomatching_tpu_torch.ops.fused_sgm import _device_route
from stereomatching_tpu_torch.utils import tracing

WINDOWS = (3, 5)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load("census")
    lib.census.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.census.restype = ctypes.c_int
    return lib


def census_reference(
    left: torch.Tensor, right: torch.Tensor, window: int = 5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: ``ops.costvolume.census_transform`` of each view ->
    contiguous int32 codes of each."""
    return tuple(census_transform(x, window).contiguous() for x in (left, right))


def census(
    left: torch.Tensor, right: torch.Tensor, window: int = 5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Census codes of integer planes [..., H, W] of one shape ->
    contiguous int32 codes [..., H, W] of each view: one bit per neighbour
    of the ``window`` x ``window`` square (3 or 5), centre skipped,
    row-major from the top-left, bit 0 first, set iff the neighbour is
    strictly below the centre; borders replicate.  CPU tensors run the
    plain version, CUDA tensors K10, one launch for both views (int32
    planes as they are, other integer planes widened to int32 first, as
    the plain version does).  Empty planes give empty codes and launch
    nothing."""
    if window not in WINDOWS:
        raise ValueError("census window must be 3 or 5")
    if left.shape != right.shape or left.ndim < 2:
        raise ValueError(f"need two equal [..., H, W] shapes, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if left.is_floating_point() or right.is_floating_point():
        raise ValueError("census takes integer planes")
    if left.numel() == 0:
        empty = torch.empty(left.shape, dtype=torch.int32, device=left.device)
        return empty, empty.clone()
    if _device_route(left, right):
        return census_reference(left, right, window)
    h, w = left.shape[-2:]
    b = left.numel() // (h * w)
    left = left.to(torch.int32).contiguous()
    right = right.to(torch.int32).contiguous()
    outs = [torch.empty(left.shape, dtype=torch.int32, device=left.device) for _ in range(2)]
    tracing.count("launches.K10")
    with torch.cuda.device(left.device):
        err = _lib().census(left.data_ptr(), right.data_ptr(), outs[0].data_ptr(),
                            outs[1].data_ptr(), b, h, w, window,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"census kernel launch failed: CUDA error {err}")
    census.launches += 1
    return outs[0], outs[1]


census.launches = 0
