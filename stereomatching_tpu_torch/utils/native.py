"""ctypes binding of the port's host codec, ``csrc/stereo_io.cpp`` (the
counterpart of ``stereomatching_tpu/utils/native.py``): 8-bit grayscale
PNG decode and encode and the PPM-P3 renderer, byte-equal to the plain
versions in ``utils/imageio.py``.

The library is built (``utils/build.py``, host C++ compiler and zlib) and
loaded at the first call, never at import, and it is not optional: a
library that fails to build or load raises.  It is loaded with
``ctypes.CDLL``, which releases the interpreter lock for each call, so
the loader's decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_P = ctypes.c_void_p
_IMTYPE_CODE = {"binary": 0, "gray_int": 2}
_MESSAGES = {
    -1: "not a PNG file",
    -2: "truncated PNG chunk",
    -3: "missing IHDR",
    -4: "bad IHDR chunk (length is not 13)",
    -6: "truncated PNG data",
}
_ERR_ZLIB, _ERR_FILTER, _ERR_RANGE = -5, -7, -10


@functools.cache
def _lib() -> ctypes.CDLL:
    from stereomatching_tpu_torch.utils import build

    lib = build.load("stereo_io")
    lib.stereo_png_info.argtypes = [_P, _I64, *[ctypes.POINTER(t) for t in
                                                (_I64, _I64, _I32, _I32, _I32, _I64)]]
    lib.stereo_png_read_gray.argtypes = [_P, _I64, _P, _I64, _I64, ctypes.POINTER(_I64)]
    lib.stereo_png_size_bound.argtypes = [_I64, _I64]
    lib.stereo_png_size_bound.restype = _I64
    lib.stereo_png_write_gray.argtypes = [_P, _I64, _I64, _P, ctypes.POINTER(_I64)]
    lib.stereo_ppm_size_bound.argtypes = [_I64, _I64]
    lib.stereo_ppm_size_bound.restype = _I64
    lib.stereo_ppm_render.argtypes = [_P, _I64, _I64, _I32, _P, ctypes.POINTER(_I64)]
    lib.stereo_ppm_render_float.argtypes = [_P, ctypes.c_double, _I64, _I64, _P,
                                            ctypes.POINTER(_I64)]
    for fn in (lib.stereo_png_info, lib.stereo_png_read_gray, lib.stereo_png_write_gray,
               lib.stereo_ppm_render, lib.stereo_ppm_render_float):
        fn.restype = ctypes.c_int
    return lib


def library_name() -> str:
    """File name of the codec's library (built and loaded if need be)."""
    return Path(_lib()._name).name


def _refuse(rc: int, detail: int = 0) -> ValueError:
    if rc == _ERR_ZLIB:
        return ValueError(f"corrupt PNG data stream (zlib error {detail})")
    if rc == _ERR_FILTER:
        return ValueError(f"bad PNG filter type {detail}")
    return ValueError(_MESSAGES.get(rc, f"PNG decode failed (code {rc})"))


# Deflate expands a byte at most 1032-fold, so a stream of n bytes holds
# fewer than 1032 * (n + 1) bytes: an image larger than that is truncated
# before any buffer of its size is allocated.
_DEFLATE_MAX_RATIO = 1032


def png_read_gray(data: bytes) -> np.ndarray:
    """Decode 8-bit grayscale PNG bytes -> uint8 [H, W].  Raises
    ``ValueError`` on what ``imageio.png_read_gray_plain`` refuses, with
    its message (zlib's own text aside)."""
    lib = _lib()
    w, h, idat = _I64(), _I64(), _I64()
    depth, ctype, interlace = _I32(), _I32(), _I32()
    rc = lib.stereo_png_info(data, len(data), w, h, depth, ctype, interlace, idat)
    if rc:
        raise _refuse(rc)
    if ctype.value != 0:
        raise ValueError("wrong number of channels (image must be grayscale, "
                         f"color type 0, got {ctype.value})")
    if depth.value != 8:
        raise ValueError(f"only 8-bit grayscale supported, got depth {depth.value}")
    if interlace.value != 0:
        raise ValueError("interlaced PNG not supported")
    if (w.value + 1) * h.value > _DEFLATE_MAX_RATIO * (idat.value + 1):
        raise _refuse(-6)
    out = np.empty((h.value, w.value), dtype=np.uint8)
    detail = _I64()
    rc = lib.stereo_png_read_gray(data, len(data), out.ctypes.data, w, h, detail)
    if rc:
        raise _refuse(rc, detail.value)
    return out


def png_write_gray(pixels: np.ndarray) -> bytes:
    """Encode uint8 [H, W] -> the plain writer's PNG bytes (filter-0 rows,
    one IDAT of zlib level 9)."""
    lib = _lib()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape
    n = _I64(lib.stereo_png_size_bound(w, h))
    out = np.empty(n.value, dtype=np.uint8)
    rc = lib.stereo_png_write_gray(pixels.ctypes.data, w, h, out.ctypes.data, n)
    if rc:
        raise RuntimeError(f"PNG encode failed (code {rc})")
    return out[:n.value].tobytes()


def ppm_render(data: np.ndarray, imtype: str) -> bytes:
    """Render a 2-D plane as PPM-P3 bytes under the mapping ``imtype``
    (``"binary"``, ``"gray_int"`` or ``"gray_float"``), equal to
    ``imageio.ppm_bytes_plain``.  ``"gray_float"`` takes values in
    [0, 1) only: ``imageio.ppm_bytes`` sends the others to the plain
    renderer."""
    lib = _lib()
    data = np.asarray(data)
    h, w = data.shape
    n = _I64(lib.stereo_ppm_size_bound(w, h))
    out = np.empty(n.value, dtype=np.uint8)
    if imtype == "gray_float":
        # The plain renderer's data * 255.0 rounds in the input's float
        # type: float64 is scaled here, any other type before the call.
        if data.dtype == np.float64:
            arr, scale = np.ascontiguousarray(data), 255.0
        else:
            arr, scale = np.ascontiguousarray(data * 255.0, dtype=np.float64), 1.0
        rc = lib.stereo_ppm_render_float(arr.ctypes.data, scale, w, h, out.ctypes.data, n)
        if rc == _ERR_RANGE:
            raise ValueError("gray_float values outside [0, 1)")
    elif imtype in _IMTYPE_CODE:
        if data.dtype.kind not in "biu":
            if imtype == "binary":
                data = data == 1
            elif not np.isfinite(data).all():
                raise ValueError("gray_int of non-finite values")
        if imtype == "gray_int" and data.size == 0:
            raise ValueError("gray_int of an empty plane")
        arr = np.ascontiguousarray(data, dtype=np.int64)
        rc = lib.stereo_ppm_render(arr.ctypes.data, w, h, _IMTYPE_CODE[imtype],
                                   out.ctypes.data, n)
    else:
        raise ValueError(imtype)
    if rc:
        raise RuntimeError(f"PPM render failed (code {rc})")
    return out[:n.value].tobytes()
