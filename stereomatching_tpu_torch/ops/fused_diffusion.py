"""The web hole-filling diffusion with each image's min/max (counterpart
of ``stereomatching_tpu/ops/fused_diffusion.py::fill_web_holes_pallas``
with ``with_range=True``).

``fill_web_holes_range`` runs the CUDA kernel ``csrc/fill_web_holes.cu``
on CUDA tensors and its plain torch version,
``fill_web_holes_range_reference``, on CPU tensors.  A failed build or
launch raises; nothing falls back.  ``fill_web_holes_range.launches``
counts the CUDA kernel launches the C entry issues: one ``diffuse_step``
per Jacobi step and one ``image_range``, ``max(times - 1, 0) + 1`` per
call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.ops.diffusion import fill_web_holes

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def fill_web_holes_range_reference(
    web: torch.Tensor, times: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch: ``fill_web_holes`` + each image's min and max."""
    out = fill_web_holes(web, times)
    return out, out.amin(dim=(-2, -1)), out.amax(dim=(-2, -1))


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load("fill_web_holes")
    lib.fill_web_holes_range.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.fill_web_holes_range.restype = ctypes.c_int
    return lib


def _launch(web: torch.Tensor, times: int):
    if web.ndim not in (2, 3):
        raise ValueError(f"need [H, W] or [B, H, W], got {tuple(web.shape)}")
    if web.dtype != torch.int32 or not web.is_contiguous():
        raise ValueError("web must be a contiguous int32 tensor")
    squeeze = web.ndim == 2
    if squeeze:
        web = web[None]
    bsz, h, w = web.shape
    dev = web.device
    out = torch.empty_like(web)
    # Two more step buffers once there are >= 2 steps (the C side rotates
    # three buffers and never writes the input).
    scratch = [torch.empty_like(web) for _ in range(2)] if times >= 3 else []
    mn = torch.full((bsz,), INT32_MAX, dtype=torch.int32, device=dev)
    mx = torch.full((bsz,), INT32_MIN, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in scratch] or [None, None]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fill_web_holes_range(
            web.data_ptr(), out.data_ptr(), *ptrs, mn.data_ptr(),
            mx.data_ptr(), bsz, h, w, times,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fill_web_holes_range kernel launch failed: CUDA error {err}")
    fill_web_holes_range.launches += max(times - 1, 0) + 1
    return (out[0], mn[0], mx[0]) if squeeze else (out, mn, mx)


def fill_web_holes_range(
    web: torch.Tensor, times: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner web [H, W] or [B, H, W] -> (web after ``times-1`` steps,
    min, max), int32; min/max are per image ([B], or scalars for 2-D
    input).  CPU tensors run the plain version, CUDA tensors the kernel."""
    if web.device.type == "cpu":
        return fill_web_holes_range_reference(web, times)
    if web.device.type != "cuda":
        raise ValueError(f"unsupported device {web.device}")
    return _launch(web, times)


fill_web_holes_range.launches = 0
