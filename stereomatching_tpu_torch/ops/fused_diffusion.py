"""The two hole-filling diffusions (counterpart of
``stereomatching_tpu/ops/fused_diffusion.py``):

* ``fill_web_holes_range`` (K2, ``csrc/fill_web_holes.cu``): the classic
  web diffusion with each image's min/max (``fill_web_holes_pallas``
  with ``with_range=True``);
* ``fill_invalid`` (K6, ``csrc/fill_invalid.cu``): the modern
  pipeline's validity-aware fill (``fill_invalid_pallas``);
* ``fill_web_holes_step`` / ``fill_invalid_step``: one step (sweep) of
  the same kernels on a halo block, the sharded tier's form, which
  exchanges a 1-row (and 1-column) halo before each step.

Each runs its CUDA kernel on CUDA tensors and its plain torch version
(``*_reference``) on CPU tensors.  A failed build or launch raises;
nothing falls back.  ``<wrapper>.launches`` counts the CUDA kernel
launches the C entry issues: for K2 one ``fused_kernel`` per
``K2_MAX_STEPS`` Jacobi steps of its storage, each image's min and max
folded into the last, ``k2_plan(times, value_bound).launches`` per call
(1 up to 17 times at byte and int32 storage, 32 at 16-bit; 2 at the
classic pipeline's 32); for K6 one ``fused_kernel`` per ``K6_MAX_SWEEPS``
sweeps, ``k6_plan(iterations).launches`` per call (1 up to 16 sweeps, the
modern pipeline's default; none at 0); one per call for the two step
wrappers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.ops import costvolume
from stereomatching_tpu_torch.ops.diffusion import fill_web_holes
from stereomatching_tpu_torch.utils import tracing

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def fill_web_holes_range_reference(
    web: torch.Tensor, times: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch: ``fill_web_holes`` + each image's min and max."""
    out = fill_web_holes(web, times)
    return out, out.amin(dim=(-2, -1)), out.amax(dim=(-2, -1))


# K2's storage (``csrc/fill_web_holes.cu``): cells of 1, 2 or 4 bytes in
# shared memory, chosen from a caller-proven bound on the web's values;
# the most Jacobi steps one launch runs at each (its halo; the C entry
# ``fill_web_holes_max_steps``); its tiles (rows, columns).
K2_MAX_STEPS = {1: 16, 2: 31, 4: 16}
K2_TILES = {1: (128, 128), 2: (64, 128), 4: (64, 64)}
K2_STORAGE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


class K2Plan(NamedTuple):
    """K2's storage bytes per cell, its launches and its Jacobi steps."""

    storage_bytes: int
    launches: int
    steps: int


def k2_plan(times: int, value_bound: Optional[int] = None) -> K2Plan:
    """K2's plan for ``times`` and a web whose values the caller proves to
    lie in [0, ``value_bound``): 1-byte cells up to a bound of 256, 2-byte
    up to 65536, else (and for ``None``: a web read from a file) int32;
    ``ceil(steps / K2_MAX_STEPS[storage])`` launches, at least one.
    Chosen before any launch from (times, value_bound) alone."""
    if value_bound is not None and (isinstance(value_bound, bool) or value_bound < 1):
        raise ValueError(f"value_bound must be None or an int >= 1, got {value_bound!r}")
    if value_bound is not None and value_bound <= 1 << 8:
        nbytes = 1
    elif value_bound is not None and value_bound <= 1 << 16:
        nbytes = 2
    else:
        nbytes = 4
    steps = max(times - 1, 0)
    return K2Plan(nbytes, max(1, -(-steps // K2_MAX_STEPS[nbytes])), steps)


def k2_smem_bytes(storage_bytes: int, steps: int) -> int:
    """Dynamic shared memory of a K2 launch running ``steps`` steps at
    ``storage_bytes`` per cell: two planes of its tile with a halo of
    ``steps`` rows and ``steps + cells a word - 1`` columns rounded to
    whole words (the C entry ``fill_web_holes_smem_bytes``, which a CUDA
    test pins)."""
    th, tw = K2_TILES[storage_bytes]
    c = 4 // storage_bytes
    hc = -(-(steps + c - 1) // c) * c
    return 2 * (th + 2 * steps) * (tw + 2 * hc) * storage_bytes


# C entry of each source: (function, argtypes); both return a CUDA error.
_ENTRIES = {
    "fill_web_holes": ("fill_web_holes_range",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "fill_invalid": ("fill_invalid",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}
# The one-step entries of the same sources.
_STEP_ENTRIES = {
    "fill_web_holes": ("fill_web_holes_step",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "fill_invalid": ("fill_invalid_step",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load(name)
    for fn_name, argtypes in (_ENTRIES[name], _STEP_ENTRIES[name]):
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if name == "fill_web_holes":
        lib.fill_web_holes_max_steps.argtypes = [ctypes.c_int]
        lib.fill_web_holes_max_steps.restype = ctypes.c_int
        lib.fill_web_holes_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.fill_web_holes_smem_bytes.restype = ctypes.c_longlong
    else:
        lib.fill_invalid_max_sweeps.argtypes = []
        lib.fill_invalid_max_sweeps.restype = ctypes.c_int
        lib.fill_invalid_smem_bytes.argtypes = [ctypes.c_int]
        lib.fill_invalid_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(web: torch.Tensor, times: int, value_bound: Optional[int]):
    if web.ndim not in (2, 3):
        raise ValueError(f"need [H, W] or [B, H, W], got {tuple(web.shape)}")
    if web.dtype != torch.int32 or not web.is_contiguous():
        raise ValueError("web must be a contiguous int32 tensor")
    plan = k2_plan(times, value_bound)
    squeeze = web.ndim == 2
    if squeeze:
        web = web[None]
    bsz, h, w = web.shape
    dev = web.device
    out = torch.empty_like(web)
    # Between chained launches both planes (X[t-1], X[t]) at the storage's
    # width: two planes for two launches, four (ping-pong) from three.
    n_planes = 0 if plan.launches == 1 else 2 if plan.launches == 2 else 4
    scratch = torch.empty((n_planes, bsz, h, w), dtype=K2_STORAGE[plan.storage_bytes],
                          device=dev) if n_planes else None
    mn = torch.full((bsz,), INT32_MAX, dtype=torch.int32, device=dev)
    mx = torch.full((bsz,), INT32_MIN, dtype=torch.int32, device=dev)
    lib = _lib("fill_web_holes")
    tracing.count("launches.K2", plan.launches)
    with torch.cuda.device(dev):
        err = lib.fill_web_holes_range(
            web.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            mn.data_ptr(), mx.data_ptr(), bsz, h, w, times, plan.storage_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fill_web_holes_range kernel launch failed: CUDA error {err}")
    fill_web_holes_range.launches += plan.launches
    return (out[0], mn[0], mx[0]) if squeeze else (out, mn, mx)


def fill_web_holes_range(
    web: torch.Tensor, times: int, value_bound: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner web [H, W] or [B, H, W] -> (web after ``times-1`` steps,
    min, max), int32; min/max are per image ([B], or scalars for 2-D
    input).  ``value_bound``: a caller-proven exclusive upper bound on the
    web's values, which are then >= 0 too (the JAX function's argument;
    the classic pipeline's winner plane lies in [0, num_shifts]); K2
    stores cells in 1 or 2 bytes below 256 or 65536 (``k2_plan``), int32
    for ``None``.  A web outside its bound gives no defined result.  CPU
    tensors run the plain version, CUDA tensors the kernel."""
    k2_plan(times, value_bound)  # checks value_bound on every device
    if web.device.type == "cpu":
        return fill_web_holes_range_reference(web, times)
    if web.device.type != "cuda":
        raise ValueError(f"unsupported device {web.device}")
    return _launch(web, times, value_bound)


fill_web_holes_range.launches = 0


# K6's layout (``csrc/fill_invalid.cu``): a float d and a state byte per
# staged cell; the most sweeps one launch runs (its halo; the C entry
# ``fill_invalid_max_sweeps``); its tile (rows, columns).
K6_STORAGE_BYTES = 5
K6_MAX_SWEEPS = 16
K6_TILE = (64, 64)


class K6Plan(NamedTuple):
    """K6's bytes per staged cell, its launches and the sweeps of its
    first (longest) launch."""

    storage_bytes: int
    launches: int
    sweeps: int


def k6_plan(iterations: int) -> K6Plan:
    """K6's plan for ``iterations`` sweeps: ``ceil(iterations /
    K6_MAX_SWEEPS)`` launches (none at 0), the sweeps split evenly, the
    first launch taking the remainder's extra sweep.  Chosen before any
    launch from ``iterations`` alone."""
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    launches = -(-iterations // K6_MAX_SWEEPS)
    return K6Plan(K6_STORAGE_BYTES, launches, -(-iterations // launches) if launches else 0)


def k6_smem_bytes(sweeps: int) -> int:
    """Dynamic shared memory of a K6 launch running ``sweeps`` sweeps:
    ``K6_STORAGE_BYTES`` for each cell of its tile with a halo of
    ``sweeps`` rows and ``sweeps + 3`` columns rounded to whole words (the
    C entry ``fill_invalid_smem_bytes``, which a CUDA test pins)."""
    th, tw = K6_TILE
    hc = (sweeps + 3 + 3) // 4 * 4
    return K6_STORAGE_BYTES * (th + 2 * sweeps) * (tw + 2 * hc)


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
    plan = k6_plan(iterations)
    if plan.launches == 0:
        return disparity.clone()
    squeeze = disparity.ndim == 2
    if squeeze:
        disparity, valid = disparity[None], valid[None]
    bsz, h, w = disparity.shape
    out = torch.empty_like(disparity)
    # Between chained launches d and v in device memory: d alternates
    # between `out` and a float plane, v between two byte planes (the
    # second from three launches); the inputs are never written.
    n = plan.launches
    scratch = [torch.empty_like(disparity) if n > 1 else None] + [
        torch.empty_like(valid, dtype=torch.uint8) if n > k else None for k in (1, 2)]
    tracing.count("launches.K6", n)
    with torch.cuda.device(disparity.device):
        err = _lib("fill_invalid").fill_invalid(
            disparity.data_ptr(), valid.data_ptr(), out.data_ptr(),
            *[None if t is None else t.data_ptr() for t in scratch],
            bsz, h, w, iterations, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fill_invalid kernel launch failed: CUDA error {err}")
    fill_invalid.launches += n
    return out[0] if squeeze else out


def fill_invalid(
    disparity: torch.Tensor, valid: torch.Tensor, iterations: int = 16
) -> torch.Tensor:
    """Validity-aware hole fill: float32 disparity and bool validity,
    [H, W] or [B, H, W] -> float32 of the same shape after
    ``iterations`` Jacobi sweeps.  CPU tensors run the plain version,
    CUDA tensors K6 in ``k6_plan(iterations).launches`` launches."""
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    devs = {disparity.device.type, valid.device.type}
    if devs == {"cpu"}:
        return fill_invalid_reference(disparity, valid, iterations)
    if devs != {"cuda"}:
        raise ValueError(f"unsupported devices {sorted(devs)}")
    return _launch_fill_invalid(disparity, valid, iterations)


fill_invalid.launches = 0


def _block_shape(ext: torch.Tensor, x_off: int):
    """A halo block [B, hs + 2, we] -> (B, hs, ws, we)."""
    if ext.ndim != 3 or x_off not in (0, 1) or ext.shape[1] < 3 or ext.shape[2] <= 2 * x_off:
        raise ValueError(f"need a halo block [B, hs + 2, ws + 2 * x_off], got "
                         f"{tuple(ext.shape)} with x_off {x_off}")
    b, rows, we = ext.shape
    return b, rows - 2, we - 2 * x_off, we


def fill_web_holes_step_reference(
    prev: torch.Tensor, cur_ext: torch.Tensor, x_off: int
) -> torch.Tensor:
    """Plain torch: one step of ``ops.diffusion.fill_web_holes`` on a
    halo block, the JAX sharded tier's scan body
    (``parallel/pipeline.py:208-219``, ``:232-257``): the flat p +- 1,
    p +- we neighbours of each interior cell of ``cur_ext`` [B, hs + 2,
    we] (interior columns ``x_off`` .. ``x_off + ws - 1``) -> the next
    web [B, hs, ws]."""
    b, hs, ws, we = _block_shape(cur_ext, x_off)
    f = cur_ext.reshape(b, -1)
    nb = (F.pad(f[:, 1:], (0, 1)) + F.pad(f[:, we:], (0, we))
          + F.pad(f[:, :-1], (1, 0)) + F.pad(f[:, :-we], (we, 0)))
    avg = (nb // 4).reshape(b, hs + 2, we)[:, 1:-1, x_off:x_off + ws]
    cur = cur_ext[:, 1:-1, x_off:x_off + ws]
    return torch.where(cur == 0, avg, prev)


def fill_web_holes_step(prev: torch.Tensor, cur_ext: torch.Tensor, x_off: int) -> torch.Tensor:
    """One Jacobi step of the web diffusion on a halo block: ``prev``
    [B, hs, ws] (the step before), ``cur_ext`` [B, hs + 2, we] (the
    current web with its exchanged 1-row halo; ``x_off`` 1 and we = ws +
    2 with a 1-column halo too), int32 -> the next web [B, hs, ws].  CPU
    tensors run the plain version, CUDA tensors K2's step kernel."""
    b, hs, ws, we = _block_shape(cur_ext, x_off)
    if tuple(prev.shape) != (b, hs, ws):
        raise ValueError(f"prev {tuple(prev.shape)} does not fit the block {tuple(cur_ext.shape)}")
    if prev.device.type == "cpu" and cur_ext.device.type == "cpu":
        return fill_web_holes_step_reference(prev, cur_ext, x_off)
    for t in (prev, cur_ext):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("fill_web_holes_step takes contiguous int32 CUDA tensors")
    out = torch.empty_like(prev)
    tracing.count("launches.K2")
    with torch.cuda.device(prev.device):
        err = _lib("fill_web_holes").fill_web_holes_step(
            prev.data_ptr(), cur_ext.data_ptr(), out.data_ptr(), b, hs, ws, we, x_off,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fill_web_holes_step kernel launch failed: CUDA error {err}")
    fill_web_holes_step.launches += 1
    return out


fill_web_holes_step.launches = 0


def fill_invalid_step_reference(
    d_ext: torch.Tensor, v_ext: torch.Tensor, x_off: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: one sweep of ``ops.costvolume.fill_invalid`` on halo
    blocks, the JAX sharded tier's scan body (``parallel/modern.py:
    355-392``): float32 d and uint8 validity [B, hs + 2, we] -> (d, v)
    [B, hs, ws].  The neighbour sum is right + left + down + up; a
    rows-only block's x neighbours stop at its columns (zero), a 2-D
    block's come from its halo columns."""
    b, hs, ws, we = _block_shape(d_ext, x_off)
    v = v_ext.to(torch.float32)
    dv = d_ext * v

    def neigh(x):
        mid = x[:, 1:-1]
        if x_off:
            right, left = mid[:, :, 2:], mid[:, :, :-2]
        else:
            right, left = F.pad(mid[:, :, 1:], (0, 1)), F.pad(mid[:, :, :-1], (1, 0))
        return ((right + left) + x[:, 2:, x_off:x_off + ws]) + x[:, :-2, x_off:x_off + ws]

    num, den = neigh(dv), neigh(v)
    avg = num / torch.clamp(den, min=1.0)
    d, vc = (t[:, 1:-1, x_off:x_off + ws] for t in (d_ext, v))
    newly = (vc == 0) & (den > 0)
    return torch.where(newly, avg, d), torch.where(newly, 1.0, vc).to(torch.uint8)


def fill_invalid_step(
    d_ext: torch.Tensor, v_ext: torch.Tensor, x_off: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep of the validity-aware fill on a halo block: float32
    disparity and uint8 validity [B, hs + 2, we] with their exchanged
    1-row halo (``x_off`` 1 and we = ws + 2 with a 1-column halo too)
    -> (d, v) [B, hs, ws].  CPU tensors run the plain version, CUDA
    tensors K6's sweep kernel."""
    b, hs, ws, we = _block_shape(d_ext, x_off)
    if v_ext.shape != d_ext.shape:
        raise ValueError(f"validity {tuple(v_ext.shape)} != disparity {tuple(d_ext.shape)}")
    if d_ext.device.type == "cpu" and v_ext.device.type == "cpu":
        return fill_invalid_step_reference(d_ext, v_ext, x_off)
    if (d_ext.device.type != "cuda" or d_ext.dtype != torch.float32 or v_ext.dtype != torch.uint8
            or not (d_ext.is_contiguous() and v_ext.is_contiguous())):
        raise ValueError("fill_invalid_step takes contiguous float32 / uint8 CUDA blocks")
    d_out = torch.empty((b, hs, ws), dtype=torch.float32, device=d_ext.device)
    v_out = torch.empty((b, hs, ws), dtype=torch.uint8, device=d_ext.device)
    tracing.count("launches.K6")
    with torch.cuda.device(d_ext.device):
        err = _lib("fill_invalid").fill_invalid_step(
            d_ext.data_ptr(), v_ext.data_ptr(), d_out.data_ptr(), v_out.data_ptr(),
            b, hs, ws, we, x_off, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fill_invalid_step kernel launch failed: CUDA error {err}")
    fill_invalid_step.launches += 1
    return d_out, v_out


fill_invalid_step.launches = 0
