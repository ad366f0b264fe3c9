"""Image I/O of the port's CLI: an 8-bit grayscale PNG/PGM reader, a PNG
writer, the PPM-P3 writer byte-compatible with the reference's
``write_image`` (src/image.c:71-88), so artifacts dumped here can be
byte-diffed against the reference binaries' and the JAX package's, and
its reader (the knife-edge gate's, ``tools/knife_edge_torch.py``).

The port's own copy of what its CLI needs from
``stereomatching_tpu/utils/imageio.py``, pure numpy (no native library;
the JAX package's native code has this code as its executable spec, so
the bytes are the same).  One repair over that copy: a binary PGM's
payload must be exactly W·H bytes after one whitespace byte or after
``\\r\\n`` (the other reader skips one byte and reads on, so a CRLF
header shifts every pixel by one).
"""

from __future__ import annotations

import io
import struct
import zlib
from enum import Enum

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class ImageType(Enum):
    """PPM pixel mappings (reference ``ImageType``, src/image.h:15-19)."""

    BINARY = "binary"  # 1 -> 0 (black), else 255 (src/image.c:45)
    GRAY_FLOAT = "gray_float"  # trunc(v * 255.0) (src/image.c:46)
    GRAY_INT = "gray_int"  # min/max normalized to 0..255 (src/image.c:47)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _pgm_payload_start(data: bytes, pos: int, n: int, path: str) -> int:
    """Offset of a P5 payload of ``n`` bytes whose header's maxval token
    ends at ``pos``: one whitespace byte, or ``\\r\\n``, then exactly
    ``n`` bytes to the end of the file; anything else raises."""
    if pos < len(data) and data[pos:pos + 1].isspace() and len(data) - pos - 1 == n:
        return pos + 1
    if data[pos:pos + 2] == b"\r\n" and len(data) - pos - 2 == n:
        return pos + 2
    raise ValueError(
        f"{path}: PGM payload is {max(len(data) - pos - 1, 0)} bytes after the "
        f"header, expected {n} (one whitespace byte or CRLF after maxval)"
    )


def _read_pgm_gray(data: bytes, path: str) -> np.ndarray:
    """Decode an 8-bit PGM (P5 binary / P2 ASCII) to uint8 [H, W]."""
    magic = data[:2]
    # Tokenize the header: magic, width, height, maxval, with
    # '#' comments running to end-of-line.
    tokens = []
    pos = 2
    while len(tokens) < 3 and pos < len(data):
        c = data[pos:pos + 1]
        if c == b"#":
            pos = data.find(b"\n", pos)
            if pos < 0:
                break
            pos += 1
        elif c.isspace():
            pos += 1
        else:
            end = pos
            while end < len(data) and not data[end:end + 1].isspace():
                end += 1
            tokens.append(data[pos:end])
            pos = end
    if len(tokens) < 3:
        raise ValueError(f"{path}: truncated PGM header")
    width, height, maxval = (int(t) for t in tokens)
    if maxval > 255:
        raise ValueError(
            f"{path}: 16-bit PGM (maxval {maxval}) unsupported — the "
            f"pipelines take 8-bit grayscale (src/image.c:8-15)"
        )
    if magic == b"P5":
        start = _pgm_payload_start(data, pos, width * height, path)
        px = np.frombuffer(data, np.uint8, count=width * height, offset=start)
    else:  # P2: ASCII samples
        vals = data[pos:].split()
        if len(vals) < width * height:
            raise ValueError(f"{path}: truncated PGM data")
        px = np.array(vals[: width * height], dtype=np.uint8)
    return px.reshape(height, width).copy()


def read_png_gray(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale image to uint8 [H, W]: PNG (color
    type 0) or PGM (P5/P2).  Mirrors the reference's input contract:
    1-channel grayscale only (src/image.c:27-31); anything else is an
    error."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in (b"P5", b"P2"):
        return _read_pgm_gray(data, path)
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = None
    depth = ctype = interlace = None
    idat = io.BytesIO()
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            width, height, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif ctag == b"IDAT":
            idat.write(chunk)
        elif ctag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if ctype != 0:
        raise ValueError(
            f"{path}: wrong number of channels (image must be grayscale, "
            f"color type 0, got {ctype})"
        )
    if depth != 8:
        raise ValueError(f"{path}: only 8-bit grayscale supported, got depth {depth}")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG not supported")

    raw = zlib.decompress(idat.getvalue())
    stride = width  # 1 byte/pixel
    if len(raw) < (stride + 1) * height:
        raise ValueError(f"{path}: truncated PNG data")

    out = np.empty((height, width), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for y in range(height):
        ftype = raw[off]
        row = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=off + 1).copy()
        off += stride + 1
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub: a running sum mod 256
            row = (np.cumsum(row, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif ftype == 2:  # Up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            left = 0
            for x in range(stride):
                row[x] = (int(row[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
                left = int(row[x])
        elif ftype == 4:  # Paeth
            left = 0
            upleft = 0
            for x in range(stride):
                row[x] = (int(row[x]) + _paeth(left, int(prev[x]), upleft)) & 0xFF
                upleft = int(prev[x])
                left = int(row[x])
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = row
        prev = row
    return out


def write_png_gray(path: str, pixels: np.ndarray) -> None:
    """Encode uint8 [H, W] as an 8-bit grayscale PNG (filter 0 rows)."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(chunk(b"IEND", b""))


def to_brightness(pixels: np.ndarray, dtype: np.dtype = np.dtype(np.float64)) -> np.ndarray:
    """uint8 pixel values -> brightness in [0, 1): exactly ``v / 256.0``
    (reference ``convert_image``, src/image.c:8-15).  Exact in both f32 and
    f64 (v * 2^-8 is representable)."""
    return pixels.astype(dtype) / np.dtype(dtype).type(256.0)


def _map_long(x: np.ndarray, in_min: int, in_max: int) -> np.ndarray:
    """Reference ``map()`` (src/image.c:37-40): (x-min)*255/(max-min) in C
    long arithmetic.  Numerator is non-negative so C truncation == floor.
    in_max == in_min would divide by zero in the reference; we output 0."""
    rng = in_max - in_min
    if rng == 0:
        return np.zeros_like(x, dtype=np.int64)
    return (x.astype(np.int64) - in_min) * 255 // rng


# "{v} {v} {v}\n" for v in 0..255, as fixed-width byte rows and lengths.
_TRIPLES = [f"{v} {v} {v}\n".encode("ascii") for v in range(256)]
_TRIPLE_LEN = np.array([len(t) for t in _TRIPLES])
_TRIPLE_BYTES = np.array([list(t.ljust(12)) for t in _TRIPLES], dtype=np.uint8)


def _triples(v: np.ndarray) -> bytes:
    """The concatenated ``"{p} {p} {p}\\n"`` lines of int64 values ``v``."""
    if v.size and 0 <= v.min() and v.max() <= 255:
        rows = _TRIPLE_BYTES[v]
        return rows[np.arange(12) < _TRIPLE_LEN[v][:, None]].tobytes()
    return "".join(f"{int(p)} {int(p)} {int(p)}\n" for p in v).encode("ascii")


def ppm_bytes(data: np.ndarray, imtype: ImageType) -> bytes:
    """Render an array as ASCII PPM P3 bytes, byte-identical to the
    reference's ``write_image`` (src/image.c:71-88): header
    ``P3\\n{w} {h}\\n255\\n`` then one ``{v} {v} {v}\\n`` line per pixel,
    with min/max computed over the full array for GRAY_INT
    (src/image.c:78-79)."""
    h, w = data.shape
    if imtype == ImageType.BINARY:
        v = np.where(data == 1, 0, 255).astype(np.int64)
    elif imtype == ImageType.GRAY_FLOAT:
        v = (data * 255.0).astype(np.int64)  # C cast truncates toward zero
    elif imtype == ImageType.GRAY_INT:
        v = _map_long(data, int(data.min()), int(data.max()))
    else:
        raise ValueError(imtype)
    return f"P3\n{w} {h}\n255\n".encode("ascii") + _triples(v.ravel())


def write_ppm(path: str, data: np.ndarray, imtype: ImageType) -> None:
    with open(path, "wb") as f:
        f.write(ppm_bytes(data, imtype))


def read_ppm(path: str) -> np.ndarray:
    """Parse an ASCII PPM P3 written by this module or the reference,
    returning the (equal-RGB) gray channel as int64 [H, W]."""
    with open(path, "rb") as f:
        tokens = f.read().split()
    if tokens[0] != b"P3":
        raise ValueError(f"{path}: not an ASCII PPM")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + 3 * w * h], dtype=np.int64).reshape(h, w, 3)
    if maxv != 255:
        raise ValueError(f"{path}: unexpected maxval {maxv}")
    return vals[:, :, 0]


def artifact_ppm_type(name: str) -> ImageType:
    """Which PPM mapping the reference uses for each dumped artifact
    (src/stereo.c:302-320)."""
    base = name.rsplit("-", 1)[0]
    if base in ("edges", "matches", "output"):
        return ImageType.BINARY
    if base in ("score_all", "scores", "score_best", "web"):
        return ImageType.GRAY_INT
    raise KeyError(name)
