"""The SGM route's three volume kernels (counterpart of
``stereomatching_tpu/ops/fused_sgm.py``):

* ``sgm_volume`` (K3, ``csrc/sgm_volume.cu``): the per-pixel census or
  SAD cost volume [B, H, W, D], on ``k3_route``'s route;
* ``sgm_directional`` (K4, ``csrc/sgm_directional.cu``): one SGM path
  (a row, column or diagonal walk), written or added into the aggregate,
  a column or diagonal walk optionally seeded by the previous row shard's
  carry and handing its own on (the sharded tier's phased chain);
  ``sgm_aggregate_paths`` runs the four paths of the 4-direction sum or
  the eight of the 8-direction sum;
* ``sgm_tail`` (K5, ``csrc/sgm_tail.cu``): argmin, sub-pixel, winner
  cost, right-view disparity and (optionally) the second-best cost, in
  one pass over the aggregate.

Volumes are [..., H, W, D], d innermost (the JAX package's ``hwd``
layout).  Each wrapper runs its plain torch version (``*_reference``,
beside it) on CPU tensors and its CUDA kernel on CUDA tensors; a failed
build or launch raises and nothing falls back.  ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stereomatching_tpu_torch.ops import sgm
from stereomatching_tpu_torch.ops.costvolume import pixel_cost, shifted_view, upsample2
from stereomatching_tpu_torch.utils import tracing

_VOL_DTYPES = (torch.int8, torch.int16, torch.int32)
_AGG_DTYPES = (torch.int16, torch.int32)
MAX_DISPARITIES = 256  # K4 keeps at most 8 disparities per lane

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sgm_volume": [_P, _P, _P] + [_I] * 7 + [_P],
    "sgm_directional": [_P, _I, _P] + [_I] * 10 + [_P, _P, _P],
    "sgm_tail": [_P, _I] + [_P] * 5 + [_I] * 5 + [_P],
}
# The tracing counter of each entry.
_COUNTERS = {"sgm_volume": "launches.K3", "sgm_directional": "launches.K4",
             "sgm_tail": "launches.K5"}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils.build import load

    lib = load(name)
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    if name == "sgm_tail":
        lib.sgm_tail_smem_bytes.argtypes = [_I] * 3
        lib.sgm_tail_smem_bytes.restype = ctypes.c_longlong
    if name == "sgm_volume":
        lib.sgm_volume_route.argtypes = [_I] * 3
        lib.sgm_volume_route.restype = _I
    return lib


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call the C entry ``name`` of ``csrc/<name>.cu`` with ``args`` and
    the current stream of ``dev``; raise on a non-zero CUDA error."""
    fn = getattr(_lib(name), name)
    tracing.count(_COUNTERS[name])
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _device_route(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); raises for mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


# ---------------------------------------------------------------- K3


def sgm_volume_reference(
    ref: torch.Tensor, other: torch.Tensor, num_disparities: int,
    cost: str = "census", dtype: torch.dtype = torch.int32, coarse=None,
) -> torch.Tensor:
    """Plain torch: int32 cost inputs [..., H, W] (census codes for
    census, intensities for SAD) -> vol [..., H, W, D] in ``dtype`` with
    vol[..., y, x, d] = cost(ref[y, x], other[y, max(x - d, 0)]).

    ``coarse = (ref_c, other_c, weight)``, the cost inputs of the
    2x2-summed images, adds multi-scale fusion (``scales=2``): each plane
    gains weight x the coarse per-pixel cost at d // 2, upsampled
    (ceil(D / 2) coarse planes)."""
    ref = ref.to(torch.int32)
    h, w = ref.shape[-2:]
    fine_at = shifted_view(other, num_disparities, "left")
    if coarse is not None:
        ref_c, other_c, weight = coarse
        ref_c = ref_c.to(torch.int32)
        coarse_at = shifted_view(other_c, -(-num_disparities // 2), "left")
    # Built d-major (contiguous plane writes), then moved to [..., H, W, D].
    vol = torch.empty((num_disparities, *ref.shape), dtype=dtype, device=ref.device)
    for d in range(num_disparities):
        c = pixel_cost(ref, fine_at(d), cost)
        if coarse is not None:
            if d % 2 == 0:
                term = weight * upsample2(pixel_cost(ref_c, coarse_at(d // 2), cost), h, w)
            c = c + term
        vol[d] = c
    return vol.movedim(0, -1).contiguous()


# K3's routes (``csrc/sgm_volume.cu``): a block stages a segment of
# K3_SEG_PX pixels of a row (L, and R from D - 1 columns to its left) in
# at most K3_SMEM_LIMIT bytes of shared memory, then writes 16-byte
# vectors of costs.
K3_SEG_PX = 256
K3_SMEM_LIMIT = 48 * 1024
K3_ROUTES = ("elements", "vectors", "pixels")  # the C entry's numbering


def k3_smem_bytes(d: int) -> int:
    """Shared memory of K3's staged block at ``d`` disparities: int32 L
    of a segment and R of the segment plus the D - 1 columns it reaches."""
    return 4 * (2 * K3_SEG_PX + d - 1)


def k3_route(shape, dtype: torch.dtype) -> str:
    """K3's route for a volume of ``shape`` [..., H, W, D] and ``dtype``
    (int8, int16, int32), chosen before launch from (W, D, dtype) alone
    (the C entry ``sgm_volume_route``, which a CUDA test pins): "pixels"
    where d is a multiple of 32 (no vector spans pixels, and a warp's
    shared loads meet no bank twice), "vectors" where a row's w * d costs
    fill whole 16-byte vectors (a vector may span pixels), "elements"
    for the rest and wherever the staged segment passes
    ``K3_SMEM_LIMIT``."""
    w, d = int(shape[-2]), int(shape[-1])
    esz = torch.empty((), dtype=dtype).element_size()
    if k3_smem_bytes(d) > K3_SMEM_LIMIT:
        return "elements"
    if d % 32 == 0:
        return "pixels"
    return "vectors" if w * d * esz % 16 == 0 else "elements"


def sgm_volume(
    ref: torch.Tensor, other: torch.Tensor, num_disparities: int,
    cost: str = "census", dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Per-pixel cost volume [..., H, W] x 2 -> [..., H, W, D] in
    ``dtype`` (int8, int16 or int32; the caller picks one that holds
    every cost).  CPU tensors run the plain version, CUDA tensors K3 on
    ``k3_route``'s route (one launch either way)."""
    if cost not in ("census", "sad"):
        raise ValueError("cost must be 'census' or 'sad'")
    if dtype not in _VOL_DTYPES:
        raise ValueError(f"volume dtype must be one of {_VOL_DTYPES}, got {dtype}")
    if ref.shape != other.shape or ref.ndim not in (2, 3):
        raise ValueError(
            f"need two equal [H, W] or [B, H, W] shapes, got "
            f"{tuple(ref.shape)} and {tuple(other.shape)}")
    if _device_route(ref, other):
        return sgm_volume_reference(ref, other, num_disparities, cost, dtype)
    for t in (ref, other):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("cost inputs must be contiguous int32")
    squeeze = ref.ndim == 2
    if squeeze:
        ref, other = ref[None], other[None]
    b, h, w = ref.shape
    vol = torch.empty((b, h, w, num_disparities), dtype=dtype, device=ref.device)
    _launch("sgm_volume", ref.device, ref.data_ptr(), other.data_ptr(),
            vol.data_ptr(), b, h, w, num_disparities, int(cost == "census"),
            vol.element_size(), K3_ROUTES.index(k3_route(vol.shape, dtype)))
    sgm_volume.launches += 1
    return vol[0] if squeeze else vol


sgm_volume.launches = 0


# ---------------------------------------------------------------- K4


def sgm_directional_reference(
    vol: torch.Tensor, p1: int, p2: int, direction: int, reverse: bool,
    seed: torch.Tensor | None = None, with_carry: bool = False,
):
    """Plain torch: one SGM path over vol [..., H, W, D] -> int32 L
    (``sgm.path``; with ``with_carry``, (L, carry))."""
    return sgm.path(vol, p1, p2, direction, reverse, seed, with_carry)


def sgm_directional_plain(
    vol: torch.Tensor, agg: torch.Tensor, p1: int, p2: int,
    direction: int, reverse: bool, accumulate: bool,
    seed: torch.Tensor | None = None, with_carry: bool = False,
):
    """``sgm_directional``'s plain version on any device: the path of
    ``sgm_directional_reference`` written into (or added to) ``agg``
    -> agg, or (agg, carry) with ``with_carry``."""
    path = sgm_directional_reference(vol, p1, p2, direction, reverse, seed, with_carry)
    carry = None
    if with_carry:
        path, carry = path
    if accumulate:
        agg += path.to(agg.dtype)
    else:
        agg.copy_(path)
    return (agg, carry) if with_carry else agg


def sgm_directional(
    vol: torch.Tensor, agg: torch.Tensor, p1: int, p2: int,
    direction: int, reverse: bool, accumulate: bool,
    seed: torch.Tensor | None = None, with_carry: bool = False,
):
    """One SGM path over vol [..., H, W, D] (int8/int16/int32), written
    into ``agg`` (same shape, int16/int32) or, with ``accumulate``, added
    to it.  ``direction`` is ``sgm.X`` (or False: along rows), ``sgm.Y``
    (or True: along columns), ``sgm.DIAG_PLUS`` or ``sgm.DIAG_MINUS``
    (the diagonals stepping (y+1, x+1) and (y+1, x-1)); ``reverse`` walks
    each line from its last cell.  Updates ``agg`` in place (the
    aggregate is the largest buffer of the route, so the paths share it)
    and returns it.  The caller keeps every value inside agg's dtype.

    ``seed`` (int32 [..., W, D]) and ``with_carry`` take ``sgm.Y`` and
    the diagonals: the walk continues from the previous row shard's last
    scanned row, and with ``with_carry`` -> (agg, carry), the carry
    int32 [..., W, D] being this launch's last scanned row (unshifted),
    the next shard's seed (``sgm.path``).
    CPU tensors run the plain version, CUDA tensors K4."""
    if vol.shape != agg.shape or vol.ndim not in (3, 4):
        raise ValueError(
            f"need equal [H, W, D] or [B, H, W, D] shapes, got "
            f"{tuple(vol.shape)} and {tuple(agg.shape)}")
    if vol.dtype not in _VOL_DTYPES or agg.dtype not in _AGG_DTYPES:
        raise ValueError(f"unsupported dtypes {vol.dtype} / {agg.dtype}")
    if direction not in (sgm.X, sgm.Y, sgm.DIAG_PLUS, sgm.DIAG_MINUS):
        raise ValueError(f"unknown direction {direction!r}")
    edge = (*vol.shape[:-3], vol.shape[-2], vol.shape[-1])
    if (seed is not None or with_carry) and direction == sgm.X:
        raise ValueError("seed / with_carry take the column or diagonal paths")
    if seed is not None and (tuple(seed.shape) != edge or seed.dtype != torch.int32):
        raise ValueError(f"seed must be int32 {edge}, got {seed.dtype} {tuple(seed.shape)}")
    tensors = (vol, agg) if seed is None else (vol, agg, seed)
    if _device_route(*tensors):
        return sgm_directional_plain(vol, agg, p1, p2, direction, reverse, accumulate,
                                     seed, with_carry)
    if not (vol.is_contiguous() and agg.is_contiguous()):
        raise ValueError("vol and agg must be contiguous")
    if seed is not None and not seed.is_contiguous():
        raise ValueError("seed must be contiguous")
    carry = (torch.empty(edge, dtype=torch.int32, device=vol.device)
             if with_carry else None)
    d = vol.shape[-1]
    if d > MAX_DISPARITIES:
        raise ValueError(f"sgm_directional takes D <= {MAX_DISPARITIES}, got {d}")
    b, h, w = (vol.shape[:-1] if vol.ndim == 4 else (1, *vol.shape[:-1]))
    _launch("sgm_directional", vol.device, vol.data_ptr(), vol.element_size(),
            agg.data_ptr(), agg.element_size(), b, h, w, d, p1, p2,
            int(direction), int(reverse), int(accumulate),
            None if seed is None else seed.data_ptr(),
            None if carry is None else carry.data_ptr())
    sgm_directional.launches += 1
    return (agg, carry) if with_carry else agg


sgm_directional.launches = 0


def sgm_aggregate_paths(
    vol: torch.Tensor, p1: int, p2: int, out_dtype: torch.dtype = torch.int32,
    directions: int = 4,
) -> torch.Tensor:
    """The 4- or 8-path SGM sum of vol [..., H, W, D] -> ``out_dtype``,
    same shape: ``sgm_directional`` for lr (written), rl, tb and bt
    (added), then with ``directions=8`` the four diagonals (added).
    Equal to ``ops.sgm.sgm_aggregate(vol, p1, p2, directions)`` in every
    value the dtype holds."""
    if directions not in (4, 8):
        raise ValueError("directions must be 4 or 8")
    paths = sgm.PATHS + (sgm.DIAG_PATHS if directions == 8 else ())
    agg = torch.empty(vol.shape, dtype=out_dtype, device=vol.device)
    for i, (direction, reverse) in enumerate(paths):
        sgm_directional(vol, agg, p1, p2, direction, reverse, accumulate=i > 0)
    return agg


# ---------------------------------------------------------------- K5


def sgm_tail_reference(
    agg: torch.Tensor, with_uniqueness: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain torch: the ops/sgm.py tail functions on agg [..., H, W, D]."""
    disp, sub, cost = sgm.volume_argmin_subpixel(agg)
    dr = sgm.right_disparity_from_left_volume(agg)
    if not with_uniqueness:
        return disp, sub, cost, dr
    return disp, sub, cost, dr, sgm.second_best_outside_neighborhood(agg, disp)


# K5's segment route (``csrc/sgm_tail.cu`` ``seg_kernel``): a block stages
# K5_SEG_PX pixels of a row, plus the D - 1 its right view reaches, in
# shared memory; a lane holds up to K5_MAX_LANE_WORDS words of a pixel's
# run.  Shapes past either limit take the wide route (``tail_kernel``).
K5_SEG_PX = 128
K5_MAX_LANE_WORDS = 8
K5_SMEM_LIMIT = 232448  # the most a block of an H100 may ask for


def k5_lane_words(element_size: int, d: int) -> int:
    """32-bit words a lane holds of one pixel's run in K5's segment route:
    the run's 128-byte rows rounded up to a power of two."""
    rows = -(-d * element_size // 128)
    return 1 << max(rows - 1, 0).bit_length()


def k5_smem_bytes(element_size: int, d: int, w: int) -> int:
    """Dynamic shared memory of K5's segment route for an aggregate of
    ``element_size`` bytes at ``d`` disparities and ``w`` columns: a
    segment's runs in whole 16-byte chunks from the boundary below it
    (the C entry ``sgm_tail_smem_bytes``, which a CUDA test pins)."""
    px = min(K5_SEG_PX + d - 1, w)
    return -(-px * d * element_size // 16) * 16 + 16


def k5_route(shape, dtype: torch.dtype) -> str:
    """K5's route for an aggregate of ``shape`` [..., H, W, D] and
    ``dtype`` (int16 or int32), chosen before launch from (dtype, D, W)
    alone: "segments" where a lane holds a pixel's run in at most
    ``K5_MAX_LANE_WORDS`` words and a segment fits ``K5_SMEM_LIMIT``,
    else "wide".  Both are kernels; neither falls back to the other."""
    w, d = int(shape[-2]), int(shape[-1])
    esz = torch.empty((), dtype=dtype).element_size()
    if (k5_lane_words(esz, d) <= K5_MAX_LANE_WORDS
            and k5_smem_bytes(esz, d, w) <= K5_SMEM_LIMIT):
        return "segments"
    return "wide"


def sgm_tail(agg: torch.Tensor, with_uniqueness: bool = False) -> Tuple[torch.Tensor, ...]:
    """The SGM tail in one pass over the aggregate [..., H, W, D] (int16
    or int32) -> (disparity int32, subpixel f32, cost int32,
    disparity_right int32) [..., H, W], plus the second-best cost
    outside the winner's +-1 (int32) with ``with_uniqueness``.  CPU
    tensors run the plain version, CUDA tensors K5 on ``k5_route``'s
    route (one launch either way)."""
    if agg.ndim not in (3, 4):
        raise ValueError(f"need [H, W, D] or [B, H, W, D], got {tuple(agg.shape)}")
    if agg.dtype not in _AGG_DTYPES:
        raise ValueError(f"aggregate dtype must be one of {_AGG_DTYPES}, got {agg.dtype}")
    if _device_route(agg):
        return sgm_tail_reference(agg, with_uniqueness)
    if not agg.is_contiguous():
        raise ValueError("the aggregate must be contiguous")
    return _tail_on_card(agg, with_uniqueness, k5_route(agg.shape, agg.dtype))


def _tail_on_card(agg: torch.Tensor, with_uniqueness: bool, route: str) -> Tuple[torch.Tensor, ...]:
    """K5 on a contiguous CUDA aggregate [..., H, W, D] by ``route``
    ("segments" or "wide"; ``sgm_tail`` passes ``k5_route``'s)."""
    squeeze = agg.ndim == 3
    if squeeze:
        agg = agg[None]
    b, h, w, d = agg.shape
    outs = [torch.empty((b, h, w), dtype=dt, device=agg.device)
            for dt in (torch.int32, torch.float32, torch.int32, torch.int32)]
    if with_uniqueness:
        outs.append(torch.empty((b, h, w), dtype=torch.int32, device=agg.device))
    c2_ptr = outs[4].data_ptr() if with_uniqueness else None
    _launch("sgm_tail", agg.device, agg.data_ptr(), agg.element_size(),
            *[o.data_ptr() for o in outs[:4]], c2_ptr, b, h, w, d,
            {"wide": 0, "segments": 1}[route])
    sgm_tail.launches += 1
    return tuple(o[0] for o in outs) if squeeze else tuple(outs)


sgm_tail.launches = 0
