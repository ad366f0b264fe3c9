"""The port's host codec (``stereomatching_tpu_torch/csrc/stereo_io.cpp``
through ``utils/native.py`` and ``utils/imageio.py``) against the port's
plain versions and the JAX package's ``stereomatching_tpu.utils.imageio``,
byte for byte: PNG decode across filter types 0-4 and rows of mixed
filters, several IDAT chunks and a ``tEXt`` chunk before them; the
refusals of malformed files (the same ``ValueError`` on both sides, also
under random corruption); PNG encode; the PPM render's three mappings.
Then the build (a missing or failing compiler raises; two processes that
build at once both load), the loader and the CLI on adaptive-filter PNGs,
and the codec's first call importing no torch and loading nothing of the
JAX package's ``native/``.  CPU only: the codec is built here with the
host C++ compiler and zlib."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from stereomatching_tpu.data.loader import StereoPairDataset as JStereoPairDataset
from stereomatching_tpu.utils import imageio as j_imageio
from stereomatching_tpu_torch import cli
from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset
from stereomatching_tpu_torch.utils import build, imageio, native
from stereomatching_tpu_torch.utils.imageio import ImageType

ROOT = Path(__file__).resolve().parent.parent


# -- a test-side PNG encoder with every filter type -------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind, row, prev):
    """PNG filter ``kind`` (0-4) of one row (int arrays) -> its bytes."""
    left = np.concatenate([[0], row[:-1]])
    upleft = np.concatenate([[0], prev[:-1]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
            4: _paeth(left, prev, upleft)}[kind]
    return ((row - pred) & 0xFF).astype(np.uint8)


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode(pixels, filters, idat_parts=1, text=True, ihdr=None, level=6):
    """An 8-bit grayscale PNG of ``pixels`` whose row y uses filter type
    ``filters[y % len(filters)]``, its zlib stream split over
    ``idat_parts`` IDAT chunks, a ``tEXt`` chunk before them;
    ``ihdr`` overrides (depth, color type, interlace)."""
    h, w = pixels.shape
    depth, ctype, interlace = ihdr or (8, 0, 0)
    prev = np.zeros(w, np.int64)
    raw = bytearray()
    for y in range(h):
        row = pixels[y].astype(np.int64)
        kind = filters[y % len(filters)]
        raw.append(kind)
        raw += _filter_row(kind, row, prev).tobytes()
        prev = row
    comp = zlib.compress(bytes(raw), level)
    cut = np.linspace(0, len(comp), idat_parts + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, interlace))
    if text:
        out += _chunk(b"tEXt", b"Comment\x00adaptive filters")
    for a, b in zip(cut[:-1], cut[1:]):
        out += _chunk(b"IDAT", comp[a:b])
    return out + _chunk(b"IEND", b"")


def image(shape, seed):
    """A smooth-plus-noise uint8 image (so every filter has work to do)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[:h, :w]
    base = 128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0)
    return np.clip(base + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)


FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [4, 0, 3, 1, 2, 3, 4]}
SHAPES = [(1, 1), (1, 29), (23, 1), (7, 13), (16, 33), (135, 240)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("filters", list(FILTERS), ids=str)
def test_decode_equals_plain_and_jax(filters, shape, tmp_path):
    """Each filter type alone and mixed per row, three IDAT chunks and a
    tEXt chunk: the codec == the plain decoder == the JAX package's
    reader == the pixels."""
    px = image(shape, seed=len(filters) * 100 + shape[0])
    data = encode(px, FILTERS[filters], idat_parts=3)
    got = native.png_read_gray(data)
    assert got.dtype == np.uint8 and got.shape == shape
    assert np.array_equal(got, px)
    assert np.array_equal(imageio.png_read_gray_plain(data), px)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    assert np.array_equal(imageio.read_png_gray(str(path)), px)
    assert np.array_equal(j_imageio.read_png_gray(str(path)), px)


def test_decode_wide_rows_of_every_filter():
    """A 64x1024 image, its rows cycling through all five filters, one
    IDAT at zlib level 9: the codec == the pixels (the plain decoder's
    Paeth and Average loops are held at the small shapes above)."""
    px = image((64, 1024), seed=3)
    data = encode(px, [0, 1, 2, 3, 4], idat_parts=1, text=False, level=9)
    assert np.array_equal(native.png_read_gray(data), px)


# -- refusals ---------------------------------------------------------------

def _good():
    return encode(image((9, 14), seed=1), FILTERS["mixed"], idat_parts=2)


def _with_idat_stream(pixels, raw):
    h, w = pixels.shape
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", raw) + _chunk(b"IEND", b""))


def _bad_cases():
    px = image((9, 14), seed=1)
    good = _good()
    idat_at = good.index(b"IDAT")
    filt5 = bytearray()
    for y in range(9):
        filt5 += bytes([5 if y == 4 else 0]) + px[y].tobytes()
    return {
        "bad signature": (b"\x89PNX" + good[4:], "not a PNG file"),
        "empty": (b"", "not a PNG file"),
        "color type 2": (encode(px, [0], ihdr=(8, 2, 0)), "wrong number of channels"),
        "depth 16": (encode(px, [0], ihdr=(16, 0, 0)), "only 8-bit grayscale supported"),
        "interlaced": (encode(px, [0], ihdr=(8, 0, 1)), "interlaced PNG not supported"),
        "truncated IDAT chunk": (good[:idat_at + 20], "truncated PNG chunk"),
        "truncated stream": (_with_idat_stream(px, zlib.compress(bytes(filt5)[:50])),
                             "truncated PNG data"),
        "stream cut short": (_with_idat_stream(px, zlib.compress(bytes(filt5))[:-9]),
                             "corrupt PNG data stream"),
        "filter type 5": (_with_idat_stream(px, zlib.compress(bytes(filt5))),
                          "bad PNG filter type 5"),
        "corrupt zlib stream": (_with_idat_stream(px, b"\x78\x9c" + bytes(range(7, 90))),
                                "corrupt PNG data stream"),
        "no IDAT": (good[:33] + _chunk(b"IEND", b""), "corrupt PNG data stream"),
        "missing IHDR": (b"\x89PNG\r\n\x1a\n" + good[33:], "missing IHDR"),
        "short IHDR": (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", good[16:28]) + good[33:],
                       "bad IHDR chunk"),
        "huge header": (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 1 << 30, 1 << 30, 8, 0, 0, 0, 0)) + good[33:], "truncated PNG data"),
    }


BAD = list(_bad_cases())


@pytest.mark.parametrize("case", BAD)
def test_refusals_match_plain(case, tmp_path):
    """Every malformed file raises ValueError from the codec and from the
    plain decoder, with the same message (zlib's own text aside), and
    ``read_png_gray`` prefixes the path."""
    data, want = _bad_cases()[case]
    with pytest.raises(ValueError) as plain:
        imageio.png_read_gray_plain(data)
    with pytest.raises(ValueError) as codec:
        native.png_read_gray(data)
    p, c = str(plain.value), str(codec.value)
    assert p.startswith(want) and c.startswith(want), (p, c)
    if not want.startswith("corrupt PNG data stream"):
        assert p == c
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"^{path}: "):
        imageio.read_png_gray(str(path))


@pytest.mark.parametrize("seed", range(4))
def test_random_corruptions_agree(seed):
    """Random byte changes and cuts of a valid file: the codec and the
    plain decoder either both refuse with ValueError or both return the
    same pixels."""
    rng = np.random.default_rng(seed)
    good = _good()
    agreed = {"refused": 0, "decoded": 0}
    for _ in range(60):
        data = bytearray(good)
        if rng.random() < 0.3:
            data = data[:rng.integers(0, len(data))]
        else:
            for _ in range(rng.integers(1, 4)):
                data[rng.integers(0, len(data))] = rng.integers(0, 256)
        data = bytes(data)
        try:
            want = imageio.png_read_gray_plain(data)
        except ValueError:
            with pytest.raises(ValueError):
                native.png_read_gray(data)
            agreed["refused"] += 1
            continue
        assert np.array_equal(native.png_read_gray(data), want)
        agreed["decoded"] += 1
    assert agreed["refused"] and agreed["decoded"], agreed


# -- encode -----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES + [(256, 300)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_plain_and_jax(shape, tmp_path):
    px = image(shape, seed=shape[1])
    want = imageio.png_bytes_plain(px)
    assert native.png_write_gray(px) == want
    imageio.write_png_gray(str(tmp_path / "port.png"), px)
    j_imageio.write_png_gray(str(tmp_path / "jax.png"), px)
    assert (tmp_path / "port.png").read_bytes() == want == (tmp_path / "jax.png").read_bytes()
    assert np.array_equal(native.png_read_gray(want), px)


def test_encode_takes_non_contiguous_and_wider_ints():
    px = image((40, 50), seed=9)
    assert native.png_write_gray(px.T) == imageio.png_bytes_plain(px.T)
    assert native.png_write_gray(px.astype(np.int64)) == imageio.png_bytes_plain(px)


# -- PPM --------------------------------------------------------------------

def _ppm_cases():
    rng = np.random.default_rng(11)
    big = 1 << 52
    return {
        "binary ints": (rng.integers(-1, 3, (17, 23)), ImageType.BINARY),
        "binary bool": (rng.random((9, 5)) < 0.5, ImageType.BINARY),
        "binary constant": (np.ones((6, 7), np.int32), ImageType.BINARY),
        "gray_int random": (rng.integers(-17, 9000, (21, 64)), ImageType.GRAY_INT),
        "gray_int constant": (np.full((5, 8), -3, np.int64), ImageType.GRAY_INT),
        "gray_int negative": (rng.integers(-10**6, -10**3, (13, 11)), ImageType.GRAY_INT),
        "gray_int large": (rng.integers(-big, big, (12, 19)), ImageType.GRAY_INT),
        "gray_int int32": (rng.integers(0, 65, (31, 33)).astype(np.int32), ImageType.GRAY_INT),
        "gray_int uint8": (rng.integers(0, 256, (8, 9)).astype(np.uint8), ImageType.GRAY_INT),
        "gray_int float": (rng.normal(0, 40, (14, 15)), ImageType.GRAY_INT),
        "gray_int 1x1": (np.array([[7]]), ImageType.GRAY_INT),
        "gray_float in range": (rng.integers(0, 256, (19, 37)) / 256.0, ImageType.GRAY_FLOAT),
        "gray_float random": (rng.random((10, 12)), ImageType.GRAY_FLOAT),
        "gray_float float32": (rng.random((10, 12)).astype(np.float32), ImageType.GRAY_FLOAT),
        "gray_float near 1": (np.nextafter(np.ones((3, 4)), 0), ImageType.GRAY_FLOAT),
        "gray_float constant": (np.zeros((4, 4)), ImageType.GRAY_FLOAT),
        "gray_float out of range": (rng.normal(0, 30, (9, 11)), ImageType.GRAY_FLOAT),
        "gray_float negative": (-rng.random((6, 6)) - 1e-3, ImageType.GRAY_FLOAT),
        "gray_float huge": (np.array([[1e15, 0.5], [-2e12, 3.0]]), ImageType.GRAY_FLOAT),
    }


PPM = list(_ppm_cases())


@pytest.mark.parametrize("case", PPM)
def test_ppm_equals_plain_and_jax(case):
    data, imtype = _ppm_cases()[case]
    want = imageio.ppm_bytes_plain(data, imtype)
    assert imageio.ppm_bytes(data, imtype) == want
    assert j_imageio.ppm_bytes(data, j_imageio.ImageType(imtype.value)) == want
    if imtype != ImageType.GRAY_FLOAT or ((data >= 0) & (data < 1)).all():
        assert native.ppm_render(data, imtype.value) == want


def test_ppm_binary_of_floats_and_refusals():
    """BINARY of non-integral floats compares with 1 as the plain
    renderer does (1.5 is not 1); empty and non-finite GRAY_INT planes
    and GRAY_FLOAT outside [0, 1) are refused by the codec, an unknown
    mapping too."""
    data = np.array([[1.0, 1.5, 0.0], [np.nan, 1.0, -1.0]])
    assert imageio.ppm_bytes(data, ImageType.BINARY) == imageio.ppm_bytes_plain(
        data, ImageType.BINARY)
    with pytest.raises(ValueError):
        native.ppm_render(np.zeros((0, 3), np.int64), "gray_int")
    with pytest.raises(ValueError):
        native.ppm_render(np.array([[1.0, np.nan]]), "gray_int")
    with pytest.raises(ValueError):
        native.ppm_render(np.array([[0.5, 1.5]]), "gray_float")
    with pytest.raises(ValueError):
        native.ppm_render(np.zeros((2, 2)), "gray")
    assert imageio.ppm_bytes(np.zeros((0, 3), np.int64), ImageType.BINARY) == b"P3\n3 0\n255\n"


def test_write_ppm_round_trips(tmp_path):
    data = np.random.default_rng(2).integers(0, 500, (30, 41))
    imageio.write_ppm(str(tmp_path / "x.ppm"), data, ImageType.GRAY_INT)
    assert (tmp_path / "x.ppm").read_bytes() == imageio.ppm_bytes_plain(data, ImageType.GRAY_INT)
    assert np.array_equal(imageio.read_ppm(str(tmp_path / "x.ppm")),
                          imageio._map_long(data, int(data.min()), int(data.max())))


# -- the build --------------------------------------------------------------

def test_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="names no compiler"):
        build.build("stereo_io")
    assert not list(tmp_path.iterdir())


def test_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    cxx = build.find_cxx()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", f"{cxx[0]} --no-such-option-of-any-compiler")
    with pytest.raises(RuntimeError, match="no-such-option-of-any-compiler") as e:
        build.build("stereo_io")
    assert "failed (exit" in str(e.value)
    assert not list(tmp_path.glob("*.tmp")) and not list(tmp_path.glob("*.so"))


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it at the same moment:
    both load a complete one, and one library and no temporary file is
    left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from stereomatching_tpu_torch.utils import build, native\n"
        f"build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "px = np.arange(60, dtype=np.uint8).reshape(6, 10)\n"
        "assert np.array_equal(native.png_read_gray(native.png_write_gray(px)), px)\n"
        "assert Path(native._lib()._name).parent == build.BUILD_DIR\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert len(list(tmp_path.glob("stereo_io-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_first_call_loads_only_the_ports_library(tmp_path):
    """The codec's first call in a fresh process (a build into an empty
    directory included), through ``imageio``: no torch, nothing of the
    JAX package imported, and the one stereo_io library mapped is the
    port's, not ``native/libstereo_io.so``."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from stereomatching_tpu_torch.utils import build, imageio, native\n"
        f"build.BUILD_DIR = Path({str(tmp_path / 'b')!r})\n"
        "assert native._lib.cache_info().currsize == 0\n"
        "px = np.arange(35, dtype=np.uint8).reshape(5, 7)\n"
        f"imageio.write_png_gray({str(tmp_path / 'x.png')!r}, px)\n"
        f"assert np.array_equal(imageio.read_png_gray({str(tmp_path / 'x.png')!r}), px)\n"
        "imageio.ppm_bytes(px, imageio.ImageType.GRAY_INT)\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if 'stereo_io' in l]\n"
        "assert maps and {str(Path(m).parent) for m in maps} == {str(build.BUILD_DIR)}, maps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
        "'stereomatching_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_do_not_reach_the_jax_native_library():
    """No module of the port names the JAX package's library or its
    directory as a path to load."""
    pkg = ROOT / "stereomatching_tpu_torch"
    for f in pkg.rglob("*.py"):
        text = f.read_text()
        assert "libstereo_io" not in text, f
        assert '"native"' not in text and "'native'" not in text, f


# -- the loader and the CLI on adaptive-filter PNGs ---------------------------

def _adaptive_pairs(root, n=5, shape=(24, 40)):
    pixels = []
    for i in range(n):
        left, right = image(shape, seed=2 * i), image(shape, seed=2 * i + 1)
        d = root / f"s{i}"
        d.mkdir()
        (d / "a.png").write_bytes(encode(left, FILTERS["mixed"][i:] + [i % 5], idat_parts=2))
        (d / "b.png").write_bytes(encode(right, [(i + 2) % 5, 4, 3], idat_parts=1))
        pixels.append((left, right))
    return pixels


def test_loader_decodes_adaptive_pngs(tmp_path):
    """StereoPairDataset and BatchLoader (numpy batches, 4 decode
    threads) on adaptive-filter PNGs == the pixels == the JAX package's
    dataset."""
    pixels = _adaptive_pairs(tmp_path)
    ds = StereoPairDataset.from_root(str(tmp_path))
    jds = JStereoPairDataset.from_root(str(tmp_path))
    for i, (left, right) in enumerate(pixels):
        got, want = ds[i], jds[i]
        assert np.array_equal(got[0], left) and np.array_equal(got[1], right)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    batches = list(BatchLoader(ds, batch_size=2, device_put=False))
    assert [k for _, _, k in batches] == [2, 2, 1]
    lefts = np.concatenate([lb[:k] for lb, _, k in batches])
    assert np.array_equal(lefts, np.stack([l for l, _ in pixels]).astype(np.float32) / 256)


def test_cli_on_adaptive_pngs_equals_filter0(tmp_path):
    """The CLI's --tier oracle on adaptive-filter PNGs writes the same
    PPMs as on the port's own filter-0 PNGs of the same pixels."""
    left, right = image((30, 44), seed=5), image((30, 44), seed=6)
    runs = {}
    for label, enc in (("adaptive", lambda px: encode(px, FILTERS["mixed"], idat_parts=2)),
                       ("filter0", imageio.png_bytes_plain)):
        (tmp_path / f"{label}_l.png").write_bytes(enc(left))
        (tmp_path / f"{label}_r.png").write_bytes(enc(right))
        out = tmp_path / label
        assert cli.main([str(tmp_path / f"{label}_l.png"), str(tmp_path / f"{label}_r.png"),
                         "--shifts", "6", "--tier", "oracle", "--outdir", str(out)]) == 0
        runs[label] = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    assert len(runs["adaptive"]) == 6 and runs["adaptive"] == runs["filter0"]


def test_cli_reports_a_malformed_png(tmp_path, capsys):
    bad = tmp_path / "bad.png"
    bad.write_bytes(_bad_cases()["filter type 5"][0])
    good = tmp_path / "good.png"
    good.write_bytes(imageio.png_bytes_plain(image((9, 14), seed=1)))
    assert cli.main([str(bad), str(good), "--tier", "oracle",
                     "--outdir", str(tmp_path / "o")]) == 1
    assert capsys.readouterr().err == f"error: {bad}: bad PNG filter type 5\n"
