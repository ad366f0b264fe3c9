"""The two hole-filling diffusions (counterpart of
``stereomatching_tpu/ops/fused_diffusion.py``):

* ``fill_web_holes_range`` (K2, ``csrc/fill_web_holes.cu``): the classic
  web diffusion with each image's min/max (``fill_web_holes_pallas``
  with ``with_range=True``);
* ``fill_invalid`` (K6, ``csrc/fill_invalid.cu``): the modern
  pipeline's validity-aware fill (``fill_invalid_pallas``).

Each runs its CUDA kernel on CUDA tensors and its plain torch version
(``*_reference``) on CPU tensors.  A failed build or launch raises;
nothing falls back.  ``<wrapper>.launches`` counts the CUDA kernel
launches the C entry issues: for K2 one ``diffuse_step`` per Jacobi step
and one ``image_range``, ``max(times - 1, 0) + 1`` per call; for K6 one
``fill_step`` per sweep, ``iterations`` per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.ops import costvolume
from stereomatching_tpu_torch.ops.diffusion import fill_web_holes

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def fill_web_holes_range_reference(
    web: torch.Tensor, times: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch: ``fill_web_holes`` + each image's min and max."""
    out = fill_web_holes(web, times)
    return out, out.amin(dim=(-2, -1)), out.amax(dim=(-2, -1))


# C entry of each source: (function, argtypes); both return a CUDA error.
_ENTRIES = {
    "fill_web_holes": ("fill_web_holes_range",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "fill_invalid": ("fill_invalid",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load(name)
    fn_name, argtypes = _ENTRIES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
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
    lib = _lib("fill_web_holes")
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


def fill_invalid_reference(
    disparity: torch.Tensor, valid: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Plain torch: ``ops.costvolume.fill_invalid``."""
    return costvolume.fill_invalid(disparity, valid, iterations)


def _launch_fill_invalid(disparity: torch.Tensor, valid: torch.Tensor, iterations: int):
    if disparity.shape != valid.shape or disparity.ndim not in (2, 3):
        raise ValueError(
            f"need two equal [H, W] or [B, H, W] shapes, got "
            f"{tuple(disparity.shape)} and {tuple(valid.shape)}")
    if disparity.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("need float32 disparity and bool validity")
    if not (disparity.is_contiguous() and valid.is_contiguous()):
        raise ValueError("disparity and validity must be contiguous")
    if iterations == 0:
        return disparity.clone()
    squeeze = disparity.ndim == 2
    if squeeze:
        disparity, valid = disparity[None], valid[None]
    bsz, h, w = disparity.shape
    out = torch.empty_like(disparity)
    # The C side ping-pongs d between `out` and a float scratch plane and
    # v between two byte planes; the inputs are never written.
    scratch = [torch.empty_like(disparity)] + [
        torch.empty_like(valid, dtype=torch.uint8) for _ in range(2)]
    with torch.cuda.device(disparity.device):
        err = _lib("fill_invalid").fill_invalid(
            disparity.data_ptr(), valid.data_ptr(), out.data_ptr(),
            *[t.data_ptr() for t in scratch],
            bsz, h, w, iterations, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fill_invalid kernel launch failed: CUDA error {err}")
    fill_invalid.launches += iterations
    return out[0] if squeeze else out


def fill_invalid(
    disparity: torch.Tensor, valid: torch.Tensor, iterations: int = 16
) -> torch.Tensor:
    """Validity-aware hole fill: float32 disparity and bool validity,
    [H, W] or [B, H, W] -> float32 of the same shape after
    ``iterations`` Jacobi sweeps.  CPU tensors run the plain version,
    CUDA tensors K6."""
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    devs = {disparity.device.type, valid.device.type}
    if devs == {"cpu"}:
        return fill_invalid_reference(disparity, valid, iterations)
    if devs != {"cuda"}:
        raise ValueError(f"unsupported devices {sorted(devs)}")
    return _launch_fill_invalid(disparity, valid, iterations)


fill_invalid.launches = 0
