"""The port's data side (``stereomatching_tpu_torch/data``) against the JAX
package's (``stereomatching_tpu/data``) on the same files: pair discovery
on the three layouts, the PFM and disparity-PNG readers (both
endiannesses, NaN and 0 as invalid, every PNG row filter at 8 and 16
bits), and ``BatchLoader``'s batches (counts, ``kept``, ``drop_last``,
the skip warning, ``pad_to``) bitwise; the port's placement on the CPU
and on a virtual CPU mesh, the mesh's batch check, the loader feeding
``Matcher``, and no silent fallback when the card is asked for."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatching_tpu.data import BatchLoader as JBatchLoader
from stereomatching_tpu.data import StereoPairDataset as JStereoPairDataset
from stereomatching_tpu.data import discover_pairs as j_discover_pairs
from stereomatching_tpu.data import formats as j_formats
from stereomatching_tpu_torch import data
from stereomatching_tpu_torch.config import StereoParams
from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset, discover_pairs, formats
from stereomatching_tpu_torch.parallel import Sharded, make_mesh
from stereomatching_tpu_torch.serving import Matcher
from stereomatching_tpu_torch.utils.imageio import write_png_gray
from tests.util import synthetic_pair


def write_pair(path_l, path_r, h=32, w=48, seed=0):
    left, right = synthetic_pair(h=h, w=w, seed=seed)
    write_png_gray(str(path_l), left)
    write_png_gray(str(path_r), right)


@pytest.fixture
def dataset_root(tmp_path):
    """Five a/b.png directories, one left/right.png directory and one flat
    ``<stem>_left/_right.png`` pair: 7 pairs of 32 x 48."""
    for i in range(5):
        d = tmp_path / f"{i}-pair"
        d.mkdir()
        write_pair(d / "a.png", d / "b.png", seed=i)
    d = tmp_path / "lr"
    d.mkdir()
    write_pair(d / "left.png", d / "right.png", seed=7)
    write_pair(tmp_path / "x_left.png", tmp_path / "x_right.png", seed=9)
    (tmp_path / "y_left.png").write_bytes((tmp_path / "x_left.png").read_bytes())  # no mate
    return str(tmp_path)


def test_discover_pairs_three_layouts(dataset_root, tmp_path):
    pairs = discover_pairs(dataset_root)
    assert pairs == j_discover_pairs(dataset_root)
    names = [(p[0][len(dataset_root) + 1:], p[1][len(dataset_root) + 1:]) for p in pairs]
    assert names == [("x_left.png", "x_right.png")] + [
        (f"{i}-pair/a.png", f"{i}-pair/b.png") for i in range(5)] + [
        ("lr/left.png", "lr/right.png")]
    ds = StereoPairDataset.from_root(dataset_root)
    jds = JStereoPairDataset.from_root(dataset_root)
    assert len(ds) == len(jds) == 7
    for i in range(len(ds)):
        for a, b in zip(ds[i], jds[i]):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no stereo pairs"):
        StereoPairDataset.from_root(str(empty))


def test_dataset_refuses_unequal_pair(tmp_path):
    write_png_gray(str(tmp_path / "a.png"), np.zeros((8, 9), np.uint8))
    write_png_gray(str(tmp_path / "b.png"), np.zeros((8, 10), np.uint8))
    with pytest.raises(ValueError, match="equal width and height"):
        StereoPairDataset.from_root(str(tmp_path))[0]


def gt_plane(h=23, w=37, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.0, 64.0, size=(h, w)).astype(np.float32)
    gt[rng.random((h, w)) < 0.1] = np.nan  # unknown-disparity holes
    return gt


def same_floats(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("color", [False, True])
def test_pfm_round_trip_against_jax(tmp_path, little_endian, color):
    """Written by either package, read by either: the same bits, rows
    stored bottom to top, +inf read as NaN."""
    gt = gt_plane()
    if color:
        gt = np.stack([gt, gt[::-1], gt * 2], axis=-1)
    gt.flat[5] = np.inf
    port, jax_file = str(tmp_path / "p.pfm"), str(tmp_path / "j.pfm")
    formats.write_pfm(port, gt, little_endian=little_endian)
    j_formats.write_pfm(jax_file, gt, little_endian=little_endian)
    assert Path(port).read_bytes() == Path(jax_file).read_bytes()
    back = formats.read_pfm(port)
    assert same_floats(back, j_formats.read_pfm(port))
    assert np.isnan(back.flat[5])
    finite = np.isfinite(gt)
    assert np.array_equal(back[finite], gt[finite]) and np.isnan(back[~finite]).all()
    # Bottom-to-top rows: the file's first stored row is the image's last.
    body = Path(port).read_bytes().split(b"\n", 3)[3]
    first = np.frombuffer(body, "<f4" if little_endian else ">f4",
                          count=gt.shape[1] * (3 if color else 1))
    last = gt[-1].reshape(-1)
    assert np.array_equal(first[np.isfinite(last)], last[np.isfinite(last)])


def test_pfm_refusals_match_jax(tmp_path):
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P5\n2 2\n255\n\x00\x00\x00\x00")
    for reader in (formats.read_pfm, j_formats.read_pfm):
        with pytest.raises(ValueError, match="not a PFM"):
            reader(str(bad))
    short = tmp_path / "short.pfm"
    short.write_bytes(b"Pf\n4 4\n-1.0\n" + b"\x00" * 12)
    with pytest.raises(ValueError):
        formats.read_pfm(str(short))
    with pytest.raises(ValueError, match="PFM needs"):
        formats.write_pfm(str(tmp_path / "x.pfm"), np.zeros((2, 2, 2), np.float32))


def filtered_png(path, vals: np.ndarray, depth: int) -> None:
    """An 8- or 16-bit grayscale PNG whose rows cycle through the five
    filter types (None, Sub, Up, Average, Paeth), so that a reader's
    every defiltering branch runs."""
    h, w = vals.shape
    bpp = depth // 8
    raw = vals.astype(">u2").tobytes() if depth == 16 else vals.astype(np.uint8).tobytes()
    stride = w * bpp
    rows = [np.frombuffer(raw, np.uint8, stride, y * stride).astype(np.int32) for y in range(h)]
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y, row in enumerate(rows):
        ft = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros(stride, np.int32)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(ft)
        out.extend(((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
def test_disparity_png_filters_against_jax(tmp_path, depth):
    """Every row filter at 8 and 16 bits (big-endian samples): the port's
    reader returns the JAX reader's planes bit for bit, with each depth's
    default convention and with an explicit scale."""
    rng = np.random.default_rng(depth)
    top = 256 if depth == 8 else 65536
    vals = rng.integers(0, top, (13, 17))
    vals[0, :3] = 0
    path = str(tmp_path / "f.png")
    filtered_png(path, vals, depth)
    got = formats.read_disparity_png(path)
    assert same_floats(got, j_formats.read_disparity_png(path))
    if depth == 16:  # KITTI: value / 256, 0 == invalid
        ok = vals != 0
        assert np.isnan(got[~ok]).all() and np.array_equal(got[ok], (vals[ok] / 256.0).astype(np.float32))
    else:  # 8-bit: value * 1.0, 0 kept
        assert np.array_equal(got, vals.astype(np.float32))
    for scale, zero_invalid in ((0.25, False), (0.125, True)):
        assert same_floats(formats.read_disparity_png(path, scale, zero_invalid),
                           j_formats.read_disparity_png(path, scale, zero_invalid))


def test_disparity_png_round_trip_against_jax(tmp_path):
    """The KITTI writer's bytes equal the JAX writer's; 0, negative and NaN
    disparities all read back as invalid."""
    gt = gt_plane(h=31, w=29, seed=2)
    gt[0, 0], gt[0, 1] = 0.0, -3.0
    port, jax_file = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    formats.write_disparity_png(port, gt)
    j_formats.write_disparity_png(jax_file, gt)
    assert Path(port).read_bytes() == Path(jax_file).read_bytes()
    back = formats.read_disparity_png(port)
    assert same_floats(back, j_formats.read_disparity_png(port))
    assert np.isnan(back[0, :2]).all()
    ok = np.isfinite(gt) & (gt > 0)
    assert np.array_equal(np.isnan(back), ~ok)
    assert np.abs(back[ok] - gt[ok]).max() <= 0.5 / 256


def test_read_ground_truth_dispatch_against_jax(tmp_path):
    gt = gt_plane(h=9, w=11, seed=4)
    gt[1, 1] = np.inf
    paths = {ext: str(tmp_path / f"a.{ext}") for ext in ("pfm", "png", "npy")}
    formats.write_pfm(paths["pfm"], gt)
    formats.write_disparity_png(paths["png"], gt)
    np.save(paths["npy"], gt)
    for ext, path in paths.items():
        got = formats.read_ground_truth(path)
        assert same_floats(got, j_formats.read_ground_truth(path)), ext
        assert np.isnan(got[1, 1]), ext
    assert same_floats(formats.read_ground_truth(paths["png"], scale=0.5),
                       j_formats.read_ground_truth(paths["png"], scale=0.5))
    with pytest.raises(ValueError, match="unknown ground-truth"):
        formats.read_ground_truth(str(tmp_path / "a.exr"))
    assert data.__all__ == __import__("stereomatching_tpu.data", fromlist=["x"]).__all__


def batches_equal(port, ref):
    assert len(port) == len(ref)
    for (pl, pr, pk), (jl, jr, jk) in zip(port, ref):
        assert pk == jk
        for a, b in ((pl, jl), (pr, jr)):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert same_floats(a, np.asarray(b))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, drop_last=True),
    dict(batch_size=3, prefetch=1, num_threads=1),
    dict(batch_size=7),
    dict(batch_size=2, pad_to=(40, 50)),
], ids=["padded-last", "drop-last", "prefetch1", "one-batch", "pad-to"])
def test_batch_loader_against_jax(dataset_root, kw):
    """Numpy batches (``device_put=False``) and CPU tensors equal the JAX
    loader's numpy batches bitwise: shapes, counts and ``kept``."""
    ds = StereoPairDataset.from_root(dataset_root)
    ref = list(JBatchLoader(JStereoPairDataset.from_root(dataset_root),
                            device_put=False, **kw))
    port = list(BatchLoader(ds, device_put=False, **kw))
    batches_equal(port, ref)
    cpu = list(BatchLoader(ds, device="cpu", **kw))
    assert all(isinstance(b[0], torch.Tensor) and b[0].device.type == "cpu" for b in cpu)
    batches_equal(cpu, ref)
    b = kw["batch_size"]
    assert [k for _, _, k in port] == (
        [b] * (7 // b) if kw.get("drop_last") else [b] * (7 // b) + ([7 % b] if 7 % b else []))
    shape = kw.get("pad_to", (32, 48))
    assert all(x.shape == (b, *shape) for x, _, _ in port)
    if 7 % b and not kw.get("drop_last"):  # the last batch repeats its last pair
        last = port[-1][0]
        assert all(np.array_equal(last[i], last[7 % b - 1]) for i in range(7 % b, b))


def test_batch_loader_skips_mixed_shapes_with_warning(tmp_path, capsys):
    for i, (h, w) in enumerate([(32, 48), (16, 24), (32, 48)]):
        d = tmp_path / f"{i}"
        d.mkdir()
        write_pair(d / "a.png", d / "b.png", h, w, seed=i)
    ref = list(JBatchLoader(JStereoPairDataset.from_root(str(tmp_path)), 3, device_put=False))
    capsys.readouterr()
    port = list(BatchLoader(StereoPairDataset.from_root(str(tmp_path)), 3, device="cpu"))
    err = capsys.readouterr().err
    assert "warning: skipping pair 1 with shape (16, 24) != (32, 48)" in err
    batches_equal(port, ref)
    assert port[0][2] == 2
    with pytest.raises(ValueError, match="larger than pad_to"):
        list(BatchLoader(StereoPairDataset.from_root(str(tmp_path)), 3, pad_to=(20, 30),
                         device="cpu"))


def test_batch_loader_on_virtual_cpu_mesh(dataset_root):
    """A mesh refuses a batch its data axis does not divide (the JAX
    loader's check); otherwise batches are sharded planes of the mesh
    (the JAX loader's ``NamedSharding``, tests/test_data_serving.py:226),
    and the sharded Matcher fed by them equals the direct call."""
    ds = StereoPairDataset.from_root(dataset_root)
    mesh = make_mesh(data=2, rows=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="data axis"):
        BatchLoader(ds, batch_size=3, mesh=mesh)
    params = StereoParams(square_width=5, times=2, num_shifts=4, edge_rule="exact")
    sharded = Matcher(params, mesh=mesh)
    loader = BatchLoader(ds, batch_size=4, mesh=mesh)
    assert loader.device == sharded.device == torch.device("cpu")
    total = 0
    for lb, rb, kept in loader:
        assert isinstance(lb, Sharded) and lb.mesh == mesh and lb.layout == "plane"
        assert all(blk.device == sharded.device for blk in lb.blocks + rb.blocks)
        got = sharded(lb, rb)
        want = Matcher(params, device="cpu")(np.asarray(lb), np.asarray(rb))
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        total += kept
    assert total == 7


def test_loader_fed_matcher_equals_direct_call(dataset_root):
    params = StereoParams(square_width=5, times=3, num_shifts=6, edge_rule="exact")
    m = Matcher(params, device="cpu")
    ds = StereoPairDataset.from_root(dataset_root)
    pairs = [ds[i] for i in range(len(ds))]
    direct = m(np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs]))
    got = [m(lb, rb) for lb, rb, _ in BatchLoader(ds, batch_size=7, device="cpu")]
    assert len(got) == 1
    for k in direct:
        assert np.array_equal(got[0][k], direct[k]), k


def test_batch_loader_refuses_missing_gpu(dataset_root):
    """The default device is the card, and a host without one raises; the
    numpy form needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal is for hosts without one")
    ds = StereoPairDataset.from_root(dataset_root)
    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="cuda"):
            BatchLoader(ds, batch_size=2, **kw)
    assert len(list(BatchLoader(ds, batch_size=2, device_put=False))) == 4
