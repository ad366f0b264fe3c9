"""The box route's fused disparity kernel (counterpart of
``stereomatching_tpu/ops/fused_modern.py``):

* ``disparity`` (K7, ``csrc/disparity.cu``): for one reference view, the
  per-pixel SAD or census cost, its zero-padded window sum, the
  first-minimum argmin and the parabola, without the cost volume.

``disparity`` runs its plain torch version (``disparity_reference``) on
CPU tensors and the CUDA kernel on CUDA tensors; a failed build or
launch, or a shape the kernel does not take, raises, and nothing falls
back.  ``disparity.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.ops.costvolume import DisparityResult, box_disparity
from stereomatching_tpu_torch.ops.fused_sgm import _device_route
from stereomatching_tpu_torch.utils import tracing

MAX_WINDOW = 255  # the JAX kernel's window limit
MAX_DISPARITIES = 256

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load("disparity")
    lib.disparity.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    lib.disparity.restype = ctypes.c_int
    lib.disparity_route.argtypes = [_I, _I, _I]
    lib.disparity_route.restype = ctypes.c_int
    return lib


ROUTES = ("strips", "tiles staged", "tiles through L1")


def route(params: ModernParams) -> str:
    """Which of K7's kernels runs ``params``' cost, window and D:
    ``"strips"`` (a warp per 32-column strip, disparities across its
    lanes), else the tile kernel with both views staged in shared memory
    (``"tiles staged"``) or read through L1 (``"tiles through L1"``).
    Builds the kernel."""
    return ROUTES[_lib().disparity_route(params.window // 2, params.num_disparities,
                                         int(params.cost == "census"))]


def disparity_reference(
    ref: torch.Tensor, other: torch.Tensor, params: ModernParams, reference: str = "left"
) -> DisparityResult:
    """Plain torch: ``ops.costvolume.box_disparity`` with ``params``'
    cost, window and D (``models/modern._cost_fn`` at ``scales=1``)."""
    return box_disparity(ref, other, params.num_disparities, params.window,
                         params.cost, reference)


def disparity(
    ref: torch.Tensor, other: torch.Tensor, params: ModernParams, reference: str = "left"
) -> DisparityResult:
    """Box-route disparity of one reference view: int32 cost inputs
    [H, W] or [B, H, W] (intensities for SAD, census codes for census)
    -> DisparityResult (int32 disparity, float32 subpixel, int32 cost).
    ``reference="left"`` matches ref(x) against other(max(x - d, 0)),
    ``"right"`` against other(min(x + d, W - 1)).  CPU tensors run the
    plain version, CUDA tensors K7 (``scales=1``, window <= 255,
    D <= 256).  K7 takes the inputs the pipeline feeds: intensities
    0..255 for SAD, census codes of at most 24 set bits (``census_window``
    <= 5); its strips keep 16-bit column sums and 24-bit costs, so other
    values give other results.  This op does not read its inputs to check
    them; the pipelines do (``models.modern.check_sad_pixels``)."""
    if reference not in ("left", "right"):
        raise ValueError(f"reference must be 'left' or 'right', got {reference!r}")
    if params.scales != 1:
        raise ValueError("disparity takes scales=1 (multi-scale fusion is another route)")
    if ref.shape != other.shape or ref.ndim not in (2, 3):
        raise ValueError(
            f"need two equal [H, W] or [B, H, W] shapes, got "
            f"{tuple(ref.shape)} and {tuple(other.shape)}")
    if _device_route(ref, other):
        return disparity_reference(ref, other, params, reference)
    for t in (ref, other):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("cost inputs must be contiguous int32")
    if params.window > MAX_WINDOW:
        raise ValueError(f"disparity takes window <= {MAX_WINDOW}, got {params.window}")
    if params.num_disparities > MAX_DISPARITIES:
        raise ValueError(
            f"disparity takes D <= {MAX_DISPARITIES}, got {params.num_disparities}")
    squeeze = ref.ndim == 2
    if squeeze:
        ref, other = ref[None], other[None]
    b, h, w = ref.shape
    if b > 65535:
        raise ValueError(f"disparity takes at most 65535 images, got {b}")
    outs = [torch.empty((b, h, w), dtype=dt, device=ref.device)
            for dt in (torch.int32, torch.float32, torch.int32)]
    tracing.count("launches.K7")
    with torch.cuda.device(ref.device):
        err = _lib().disparity(
            ref.data_ptr(), other.data_ptr(), *[o.data_ptr() for o in outs],
            b, h, w, params.num_disparities, params.window // 2,
            int(params.cost == "census"), int(reference == "right"),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"disparity kernel launch failed: CUDA error {err}")
    disparity.launches += 1
    if squeeze:
        outs = [o[0] for o in outs]
    return DisparityResult(*outs)


disparity.launches = 0
