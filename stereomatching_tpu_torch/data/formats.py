"""Ground-truth disparity formats: PFM and 16-bit disparity PNG (the
port's own copy of ``stereomatching_tpu/data/formats.py``, numpy only).

The BASELINE.md quality gate ("bad-pixel rate vs serial reference ...
bit-comparable maps on Tsukuba/Middlebury") needs the standard dataset
encodings, which the reference never reads (its harness is bitwise PPM
equality only, test/diff.sh):

  * PFM (Portable Float Map) — Middlebury MiddEval3 ground truth
    (``disp0GT.pfm``).  Header ``Pf``/``PF``, dimensions, a scale whose
    sign encodes endianness, rows stored bottom-to-top.  +inf/NaN mark
    unknown disparity; they are returned as NaN.
  * 16-bit grayscale disparity PNG — the KITTI convention (value/256,
    0 == invalid) and the older Middlebury integer-scaled 8-bit maps
    (value * 1/scale_factor).

Everything decodes to float32 [H, W] with NaN for invalid pixels, the
contract ``tools/eval_quality_torch.py`` and ``utils/metrics.py`` consume (the
metrics mask non-finite ground truth).  The PNG path shares the
from-scratch zlib codec approach of utils/imageio.py, extended to
16-bit samples (PNG filters operate on bytes with bpp=2; 16-bit
samples are big-endian per the PNG spec).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def read_pfm(path: str) -> np.ndarray:
    """Decode a PFM file -> float32 [H, W] (grayscale ``Pf``) or
    [H, W, 3] (color ``PF``), top-to-bottom row order, non-finite
    values normalized to NaN (Middlebury's unknown-disparity marker)."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: three whitespace-separated tokens (type, "W H", scale),
    # each terminated by a single whitespace byte.  Comments (#) are
    # tolerated between tokens as some writers emit them.
    pos = 0

    def token():
        nonlocal pos
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            return token()
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tok = data[start:pos]
        pos += 1  # exactly one whitespace terminates the token
        return tok

    magic = token()
    if magic not in (b"Pf", b"PF"):
        raise ValueError(f"{path}: not a PFM file (magic {magic!r})")
    channels = 3 if magic == b"PF" else 1
    try:
        w = int(token())
        h = int(token())
        scale = float(token())
    except ValueError:
        raise ValueError(f"{path}: malformed PFM header") from None
    endian = "<" if scale < 0 else ">"
    count = w * h * channels
    raw = np.frombuffer(data, dtype=endian + "f4", count=count, offset=pos)
    if raw.size < count:
        raise ValueError(f"{path}: truncated PFM data")
    img = raw.reshape(h, w, channels) if channels == 3 else raw.reshape(h, w)
    img = np.flipud(img).astype(np.float32)  # PFM rows are bottom-to-top
    img = np.where(np.isfinite(img), img, np.float32(np.nan))
    return np.ascontiguousarray(img)


def write_pfm(path: str, img: np.ndarray, little_endian: bool = True) -> None:
    """Encode float32 [H, W] (or [H, W, 3]) as PFM; NaN passes through
    (the standard unknown marker)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        magic, channels = b"Pf", 1
    elif img.ndim == 3 and img.shape[2] == 3:
        magic, channels = b"PF", 3
    else:
        raise ValueError(f"PFM needs [H, W] or [H, W, 3], got {img.shape}")
    del channels
    h, w = img.shape[:2]
    scale = -1.0 if little_endian else 1.0
    body = np.flipud(img).astype("<f4" if little_endian else ">f4")
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale:.1f}\n".encode())
        f.write(body.tobytes())


def _decode_png_gray_any(data: bytes, path: str) -> np.ndarray:
    """Decode an 8- or 16-bit grayscale non-interlaced PNG -> uint8 or
    uint16 [H, W].  Vectorized per-row defiltering (bpp-aware), unlike
    imageio.read_png_gray's scalar 8-bit spec loop."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = depth = ctype = interlace = None
    idat = bytearray()
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            width, height, depth, ctype, _c, _f, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif ctag == b"IDAT":
            idat.extend(chunk)
        elif ctag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if ctype != 0:
        raise ValueError(
            f"{path}: disparity PNG must be grayscale (color type 0, "
            f"got {ctype})"
        )
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported bit depth {depth}")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG not supported")

    bpp = depth // 8
    stride = width * bpp
    raw = zlib.decompress(bytes(idat))
    if len(raw) < (stride + 1) * height:
        raise ValueError(f"{path}: truncated PNG data")

    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(height):
        ftype = raw[off]
        row = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        off += stride + 1
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub: sequential in x, vector over nothing
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            row = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = row.astype(np.uint8)
        prev = row
    if depth == 8:
        return out
    return out.reshape(height, width, 2).astype(np.uint16)[
        :, :, 0
    ] * np.uint16(256) + out.reshape(height, width, 2).astype(np.uint16)[:, :, 1]


def read_disparity_png(
    path: str,
    scale: float | None = None,
    zero_invalid: bool | None = None,
) -> np.ndarray:
    """Decode a disparity-encoding grayscale PNG -> float32 [H, W] with
    NaN at invalid pixels.

    Default conventions by bit depth:
      16-bit — KITTI: disparity = value / 256, value 0 == invalid
               (scale=1/256, zero_invalid=True)
      8-bit  — Middlebury integer-scaled maps: disparity = value * scale
               (scale defaults to 1.0; pass 1/4 or 1/8 for the
               quarter/eighth-pixel encodings; zero_invalid=False)
    """
    with open(path, "rb") as f:
        data = f.read()
    img = _decode_png_gray_any(data, path)
    is16 = img.dtype == np.uint16
    if scale is None:
        scale = 1.0 / 256.0 if is16 else 1.0
    if zero_invalid is None:
        zero_invalid = is16
    disp = img.astype(np.float32) * np.float32(scale)
    if zero_invalid:
        disp = np.where(img == 0, np.float32(np.nan), disp)
    return disp


def write_disparity_png(path: str, disp: np.ndarray, scale: float = 256.0) -> None:
    """Encode float disparity as a 16-bit grayscale PNG (KITTI layout:
    round(d * scale) clamped to uint16, NaN/negative -> 0 == invalid)."""
    disp = np.asarray(disp, np.float64)
    vals = np.where(np.isfinite(disp), np.round(disp * scale), 0.0)
    vals = np.clip(vals, 0, 65535).astype(np.uint16)
    h, w = vals.shape
    be = vals.astype(">u2").tobytes()
    stride = w * 2
    raw = b"".join(
        b"\x00" + be[y * stride : (y + 1) * stride] for y in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(chunk(b"IEND", b""))


def read_ground_truth(path: str, scale: float | None = None) -> np.ndarray:
    """Dispatch on extension: .pfm -> read_pfm, .png -> read_disparity_png,
    .npy -> np.load.  -> float32 [H, W], NaN == invalid.  ``scale``
    multiplies PNG values (see read_disparity_png) and is ignored for
    PFM/npy."""
    lower = path.lower()
    if lower.endswith(".pfm"):
        return read_pfm(path)
    if lower.endswith(".png"):
        return read_disparity_png(path, scale=scale)
    if lower.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        return np.where(np.isfinite(arr), arr, np.float32(np.nan))
    raise ValueError(f"{path}: unknown ground-truth format")
