"""The reference rule's edges of both views as one kernel:

* ``reference_edges`` (K11, ``csrc/reference_edges.cu``): the edge maps
  of the left and the right planes of a request, every image of the
  batch, in one launch.

It replaces no Pallas kernel: the JAX package computes these edges as
XLA ops (``stereomatching_tpu/ops/edges.py``), and its plain version
here is ``reference_edges_reference``, the torch ops of
``ops.edges.find_edges`` with ``rule="reference"``.  ``reference_edges``
runs the plain version on CPU tensors and the CUDA kernel on CUDA
float32 and float64 tensors; a failed build or launch raises, and
nothing falls back.  CUDA planes of another float dtype (float16,
bfloat16, or two dtypes) are refused before any launch.
``reference_edges.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.config import BoundaryMode
from stereomatching_tpu_torch.ops.edges import find_edges
from stereomatching_tpu_torch.ops.fused_sgm import _device_route
from stereomatching_tpu_torch.utils import tracing

KERNEL_DTYPES = (torch.float32, torch.float64)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load("reference_edges")
    lib.reference_edges.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_double, _P]
    lib.reference_edges.restype = ctypes.c_int
    return lib


def reference_edges_reference(
    left: torch.Tensor, right: torch.Tensor, threshold: float,
    mode: BoundaryMode = BoundaryMode.WRAP,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: ``ops.edges.find_edges(x, threshold, mode,
    "reference")`` of each view -> the int32 {0, 1} map of each."""
    return tuple(find_edges(x, threshold, mode, "reference") for x in (left, right))


def reference_edges(
    left: torch.Tensor, right: torch.Tensor, threshold: float,
    mode: BoundaryMode = BoundaryMode.WRAP,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference rule's edge maps of float brightness planes [..., H,
    W] of one shape -> contiguous int32 {0, 1} maps [..., H, W] of each
    view, bitwise ``reference_edges_reference``: the C float order in the
    planes' dtype, boundaries by ``mode``.  CPU tensors run the plain
    version, CUDA float32 and float64 tensors K11, one launch for both
    views; CUDA planes of any other dtype pair are refused.  Empty planes
    give empty maps and launch nothing."""
    if left.shape != right.shape or left.ndim < 2:
        raise ValueError(f"need two equal [..., H, W] shapes, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if not (left.is_floating_point() and right.is_floating_point()):
        raise ValueError("reference edges take float brightness planes")
    cpu = _device_route(left, right)
    if not cpu and (left.dtype != right.dtype or left.dtype not in KERNEL_DTYPES):
        raise ValueError(f"reference edges on the card take two float32 or two float64 "
                         f"planes, got {left.dtype} and {right.dtype}")
    if left.numel() == 0:
        empty = torch.empty(left.shape, dtype=torch.int32, device=left.device)
        return empty, empty.clone()
    if cpu:
        return reference_edges_reference(left, right, threshold, mode)
    h, w = left.shape[-2:]
    b = left.numel() // (h * w)
    left, right = left.contiguous(), right.contiguous()
    outs = [torch.empty(left.shape, dtype=torch.int32, device=left.device) for _ in range(2)]
    tracing.count("launches.K11")
    with torch.cuda.device(left.device):
        err = _lib().reference_edges(
            left.data_ptr(), right.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), b, h, w,
            left.element_size(), int(mode == BoundaryMode.WRAP), float(threshold),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"reference edges kernel launch failed: CUDA error {err}")
    reference_edges.launches += 1
    return outs[0], outs[1]


reference_edges.launches = 0
