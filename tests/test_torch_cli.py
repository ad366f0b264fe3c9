"""The PyTorch port's CLI (``python -m stereomatching_tpu_torch.cli``) on
the CPU (``--tier cpu``) against the JAX package's CLI (``--tier jax``) on
the same small PNG pair: byte-identical PPM dumps for the classic
pipeline, equal ``disparity.npz`` contents for the modern one, the
checkpoint resume, the refusals (``--resume`` with ``--collect``,
``--tier cuda`` without a GPU), and the port's image reader against the
JAX package's, with the binary-PGM header repair."""

import os
import re

import numpy as np
import pytest
import torch

from stereomatching_tpu import cli as j_cli
from stereomatching_tpu.utils import imageio as j_imageio
from stereomatching_tpu_torch import cli
from stereomatching_tpu_torch.utils import imageio
from tests.util import synthetic_pair

TIMING_RE = re.compile(
    r"^width = (\d+), height = (\d+), t1 = [\d.]+, t2 = [\d.]+, elapsed = ([\d.]+)$"
)


@pytest.fixture
def pair_paths(tmp_path):
    left, right = synthetic_pair(h=40, w=56, seed=2)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    j_imageio.write_png_gray(a, left)
    j_imageio.write_png_gray(b, right)
    return a, b


def dumps(outdir):
    return {f: open(os.path.join(outdir, f), "rb").read()
            for f in sorted(os.listdir(outdir)) if f.endswith(".ppm")}


def run_both(tmp_path, argv, name):
    """Run the port (cpu) and the JAX CLI (jax) with ``argv`` -> the two
    output directories."""
    port_dir, jax_dir = str(tmp_path / f"{name}-port"), str(tmp_path / f"{name}-jax")
    assert cli.main([*argv, "--tier", "cpu", "--outdir", port_dir]) == 0
    assert j_cli.main([*argv, "--tier", "jax", "--outdir", jax_dir]) == 0
    return port_dir, jax_dir


@pytest.mark.parametrize("flags", [
    ["--mode", "wrap", "--edge-rule", "reference"],
    ["0.2", "9", "6", "4", "--mode", "ghost", "--edge-rule", "exact"],
    ["--mode", "ghost", "--collect"],
], ids=["wrap-reference", "ghost-exact", "collect"])
def test_classic_ppms_byte_identical_to_jax_cli(pair_paths, tmp_path, capsys, flags):
    a, b = pair_paths
    port_dir, jax_dir = run_both(tmp_path, [a, b, *flags, "--shifts", "12"], "classic")
    lines = capsys.readouterr().out.strip().splitlines()
    m = TIMING_RE.match(lines[0])
    assert m and (int(m.group(1)), int(m.group(2))) == (56, 40), lines
    assert lines[0].split()[14] == m.group(3)  # the reference's time.sh field
    port, ref = dumps(port_dir), dumps(jax_dir)
    assert sorted(port) == sorted(ref)
    assert len(port) == (6 + 3 * 12 if "--collect" in flags else 6)
    for f in ref:
        assert port[f] == ref[f], f


def test_save_then_resume_equals_uninterrupted(pair_paths, tmp_path):
    a, b = pair_paths
    ck = str(tmp_path / "ck.npz")
    full, resumed = str(tmp_path / "full"), str(tmp_path / "resumed")
    base = [a, b, "0.15", "7", "5", "3", "--shifts", "10", "--tier", "cpu"]
    assert cli.main([*base, "--save-artifacts", ck, "--outdir", full]) == 0
    assert cli.main([*base, "--resume", ck, "--outdir", resumed]) == 0
    assert dumps(full) == dumps(resumed) and len(dumps(full)) == 6
    # The JAX CLI resumes the port's checkpoint to the same bytes.
    jax_resumed = str(tmp_path / "jax-resumed")
    assert j_cli.main([*base[:-2], "--tier", "jax", "--resume", ck,
                       "--outdir", jax_resumed]) == 0
    assert dumps(jax_resumed) == dumps(full)
    # Upstream params that differ from the checkpoint's are refused.
    assert cli.main([a, b, "0.15", "9", "--shifts", "10", "--tier", "cpu",
                     "--resume", ck, "--outdir", resumed]) == 1


def test_refusals(pair_paths, tmp_path, capsys):
    a, b = pair_paths
    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck.npz")
    assert cli.main([a, b, "--tier", "cpu", "--save-artifacts", ck, "--outdir", out]) == 0
    capsys.readouterr()
    # F4: --resume with --collect is refused, where the JAX CLI drops
    # --collect silently.
    assert cli.main([a, b, "--tier", "cpu", "--resume", ck, "--collect",
                     "--outdir", out]) == 1
    assert capsys.readouterr().err.startswith("error: --collect")
    assert j_cli.main([a, b, "--tier", "jax", "--resume", ck, "--collect",
                       "--outdir", out]) == 0
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-GPU refusal cannot be shown")
    assert cli.main([a, b, "--outdir", out]) == 1  # --tier cuda is the default
    assert cli.main([a, b, "--tier", "cuda", "--outdir", out]) == 1
    assert capsys.readouterr().err.startswith("error: --tier cuda")
    assert cli.main([a, b, "--tier", "cpu", "0.15", "99"]) == 1  # window > image
    assert cli.main([a, b, "--tier", "cpu", "--pipeline", "modern",
                     "--save-artifacts", ck]) == 1


@pytest.mark.parametrize("flags", [
    ["--scales", "1", "--cost", "census", "--aggregation", "sgm", "--sgm-directions", "8",
     "--uniqueness", "--median"],
    ["--scales", "2"],
    ["--scales", "2", "--cost", "census", "--aggregation", "sgm", "--fill-mode",
     "background"],
], ids=["sgm8-scales1", "box-scales2", "sgm-scales2"])
def test_modern_npz_equals_jax_cli(pair_paths, tmp_path, flags):
    a, b = pair_paths
    argv = [a, b, "0.15", "5", "--pipeline", "modern", "--shifts", "12", *flags]
    port_dir, jax_dir = run_both(tmp_path, argv, "modern")
    with np.load(os.path.join(port_dir, "disparity.npz")) as p, \
            np.load(os.path.join(jax_dir, "disparity.npz")) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k
    assert dumps(port_dir) == dumps(jax_dir)


def test_reader_matches_jax_and_repairs_crlf_pgm(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (13, 21), dtype=np.uint8)
    png = str(tmp_path / "x.png")
    j_imageio.write_png_gray(png, img)
    imageio.write_png_gray(str(tmp_path / "y.png"), img)
    for path in (png, str(tmp_path / "y.png")):
        assert np.array_equal(imageio.read_png_gray(path), j_imageio.read_png_gray(path))
        assert np.array_equal(imageio.read_png_gray(path), img)
    head = b"P5\n# comment\n21 13\n255"
    files = {
        "p5": head + b"\n" + img.tobytes(),
        "p2": b"P2\n21 13\n255\n" + " ".join(map(str, img.ravel())).encode(),
    }
    for name, data in files.items():
        path = tmp_path / f"{name}.pgm"
        path.write_bytes(data)
        assert np.array_equal(imageio.read_png_gray(str(path)), img)
        assert np.array_equal(j_imageio.read_png_gray(str(path)), img)
    # F3: a CRLF after maxval skips both bytes (the JAX reader shifts every
    # pixel by one there); any other payload length raises.
    crlf = tmp_path / "crlf.pgm"
    crlf.write_bytes(head + b"\r\n" + img.tobytes())
    assert np.array_equal(imageio.read_png_gray(str(crlf)), img)
    assert not np.array_equal(j_imageio.read_png_gray(str(crlf)), img)
    for bad in (head + b"\n" + img.tobytes()[:-1], head + b"\n" + img.tobytes() + b"\0",
                head + b"\r\n" + img.tobytes()[:-2]):
        path = tmp_path / "bad.pgm"
        path.write_bytes(bad)
        with pytest.raises(ValueError, match="payload"):
            imageio.read_png_gray(str(path))


def test_ppm_render_matches_jax():
    rng = np.random.default_rng(5)
    web = rng.integers(-3, 70, (9, 11)).astype(np.int32)
    edges = rng.integers(0, 2, (9, 11)).astype(np.int32)
    flt = rng.random((9, 11)).astype(np.float32)
    for data, t in ((web, imageio.ImageType.GRAY_INT), (edges, imageio.ImageType.BINARY),
                    (flt, imageio.ImageType.GRAY_FLOAT), (flt * 400 - 50,
                                                          imageio.ImageType.GRAY_FLOAT)):
        assert imageio.ppm_bytes(data, t) == j_imageio.ppm_bytes(data, j_imageio.ImageType(t.value))
    for name in ("edges-1", "web-2", "scores-3", "output-0"):
        assert imageio.artifact_ppm_type(name).value == j_imageio.artifact_ppm_type(name).value
