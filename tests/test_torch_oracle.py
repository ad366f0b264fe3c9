"""The port's numpy serial oracle (``stereomatching_tpu_torch/oracle``)
against the JAX package's (``stereomatching_tpu/oracle``), function for
function and bitwise, on random small pairs in both boundary modes, both
edge rules, several shift counts and ``times``; and the port CLI's
``--tier oracle`` against the JAX CLI's, called in process: the same PPM
bytes for a plain run, ``--collect`` and save-then-``--resume``, the
refusal of ``--pipeline modern``, and no torch import on that tier."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stereomatching_tpu import cli as j_cli
from stereomatching_tpu.config import BoundaryMode
from stereomatching_tpu.config import StereoParams as JStereoParams
from stereomatching_tpu.oracle import pipeline as j_oracle
from stereomatching_tpu_torch import cli, interop
from stereomatching_tpu_torch import oracle as port_oracle_pkg
from stereomatching_tpu_torch.oracle import pipeline as oracle
from stereomatching_tpu_torch.utils.imageio import write_png_gray
from tests.util import synthetic_pair

ROOT = Path(__file__).resolve().parent.parent
MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def random_pair(seed, h=19, w=23):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)) / 256.0, rng.integers(0, 256, (h, w)) / 256.0)


@pytest.mark.parametrize("rule", ["reference", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_find_edges_against_jax(mode, rule):
    """Both edge rules, float64 and float32 (the reference rule's ops run
    in the given dtype), on random and blob pairs."""
    pm = oracle.BoundaryMode(mode.value)
    for seed in range(3):
        left, right = random_pair(seed)
        blob = synthetic_pair(24, 30, seed=seed)[0] / 256.0
        for img in (left, right, blob):
            for dtype in (np.float64, np.float32):
                for thr in (0.0, 0.15, 0.5, 1.0):
                    got = oracle.find_edges(img, thr, pm, np.dtype(dtype), rule)
                    want = j_oracle.find_edges(img, thr, mode, np.dtype(dtype), rule)
                    assert same(got, want), (seed, dtype, thr)


@pytest.mark.parametrize("mode", MODES)
def test_matching_phases_against_jax(mode):
    """fill_matches, box_sum, record_scores and best_and_winner on random
    edge maps: shift counts 1-40 (past the width), windows 1-25."""
    pm = oracle.BoundaryMode(mode.value)
    rng = np.random.default_rng(5)
    for shifts, sw in ((1, 1), (7, 3), (16, 9), (40, 25)):
        el, er = (rng.integers(0, 2, (17, 21)).astype(np.uint8) for _ in range(2))
        m = oracle.fill_matches(el, er, shifts, pm)
        assert same(m, j_oracle.fill_matches(el, er, shifts, mode))
        sums = np.stack([oracle.box_sum(m[i], sw, pm) for i in range(shifts)])
        assert same(sums, np.stack([j_oracle.box_sum(m[i], sw, mode) for i in range(shifts)]))
        scores = oracle.record_scores(m, sums)
        assert same(scores, j_oracle.record_scores(m, sums))
        for a, b in zip(oracle.best_and_winner(scores), j_oracle.best_and_winner(scores)):
            assert same(a, b)


def test_finishing_phases_against_jax():
    """fill_web_holes at times 0-12 (webs with and without holes, where the
    flat-index reads cross rows and the buffer's ends) and draw_contour
    at 1-12 lines (and the clamped interval)."""
    rng = np.random.default_rng(6)
    webs = [rng.integers(1, 31, (13, 17)), rng.integers(0, 4, (13, 17)),
            np.where(rng.random((9, 11)) < 0.4, 0, rng.integers(1, 9, (9, 11)))]
    for web in webs:
        web = web.astype(np.int32)
        for times in (0, 1, 2, 5, 12):
            got = oracle.fill_web_holes(web, times)
            assert same(got, j_oracle.fill_web_holes(web, times))
            for lines in (1, 3, 12):
                for a, b in zip(oracle.draw_contour(got, lines), j_oracle.draw_contour(got, lines)):
                    assert same(a, b)


@pytest.mark.parametrize("times", [0, 4])
@pytest.mark.parametrize("shifts", [3, 12])
@pytest.mark.parametrize("rule", ["reference", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_run_pipeline_against_jax(mode, rule, shifts, times):
    """run_pipeline with collect (every per-shift plane) and
    run_pipeline_from_edges, in float64 and float32."""
    jp = JStereoParams(num_shifts=shifts, square_width=5, times=times, lines=4,
                       mode=mode, edge_rule=rule)
    pp = interop.params_from_jax(jp)
    left, right = (x / 256.0 for x in synthetic_pair(20, 28, seed=shifts + times))
    for dtype in (np.float64, np.float32):
        got = oracle.run_pipeline(left, right, pp, np.dtype(dtype), collect=True)
        want = j_oracle.run_pipeline(left, right, jp, np.dtype(dtype), collect=True)
        assert list(got) == list(want)
        assert len(got) == 6 + 3 * shifts
        for k in want:
            assert same(got[k], want[k]), k
    edges = (got["edges-1"], got["edges-2"])
    a = oracle.run_pipeline_from_edges(*edges, pp)
    b = j_oracle.run_pipeline_from_edges(*edges, jp)
    assert list(a) == list(b) and all(same(a[k], b[k]) for k in b)
    assert port_oracle_pkg.__all__ == __import__(
        "stereomatching_tpu.oracle", fromlist=["x"]).__all__


def test_run_pipeline_validates_image():
    left, right = random_pair(0, 10, 12)
    with pytest.raises(ValueError) as port:
        oracle.run_pipeline(left, right, oracle.StereoParams(square_width=21))
    with pytest.raises(ValueError) as ref:
        j_oracle.run_pipeline(left, right, JStereoParams(square_width=21))
    assert str(port.value) == str(ref.value)


@pytest.fixture
def pair_paths(tmp_path):
    left, right = synthetic_pair(h=40, w=56, seed=3)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, left)
    write_png_gray(b, right)
    return a, b


def dumps(outdir):
    return {f: (Path(outdir) / f).read_bytes()
            for f in sorted(os.listdir(outdir)) if f.endswith(".ppm")}


@pytest.mark.parametrize("flags", [
    ["--mode", "wrap"],
    ["0.2", "9", "6", "4", "--mode", "ghost", "--edge-rule", "exact"],
    ["--mode", "ghost", "--collect"],
], ids=["wrap-reference", "ghost-exact", "collect"])
def test_cli_oracle_ppms_byte_identical_to_jax_cli(pair_paths, tmp_path, capsys, flags):
    argv = [*pair_paths, *flags, "--shifts", "10", "--tier", "oracle"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main([*argv, "--outdir", port_dir]) == 0
    assert j_cli.main([*argv, "--outdir", jax_dir]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(ln.startswith("width = 56, height = 40, t1 = ") for ln in lines)
    port, ref = dumps(port_dir), dumps(jax_dir)
    assert sorted(port) == sorted(ref)
    assert len(port) == (6 + 3 * 10 if "--collect" in flags else 6)
    for f in ref:
        assert port[f] == ref[f], f


def test_cli_oracle_save_then_resume(pair_paths, tmp_path):
    """Save on the oracle tier, resume there (with other times and lines):
    the same bytes as the JAX CLI's oracle resume of the same checkpoint,
    and as an uninterrupted run; the JAX CLI's checkpoint resumes too."""
    base = [*pair_paths, "0.15", "7", "5", "3", "--shifts", "10", "--tier", "oracle"]
    ck, jck = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    full = str(tmp_path / "full")
    assert cli.main([*base, "--save-artifacts", ck, "--outdir", full]) == 0
    assert j_cli.main([*base, "--save-artifacts", jck, "--outdir", str(tmp_path / "jfull")]) == 0
    assert dumps(full) == dumps(str(tmp_path / "jfull"))
    resumed = {}
    for name, main, path in (("port", cli.main, ck), ("jax", j_cli.main, ck),
                             ("port-on-jax-ck", cli.main, jck)):
        out = str(tmp_path / name)
        assert main([*pair_paths, "0.15", "7", "9", "2", "--shifts", "10", "--tier", "oracle",
                     "--resume", path, "--outdir", out]) == 0
        resumed[name] = dumps(out)
    assert resumed["port"] == resumed["jax"] == resumed["port-on-jax-ck"]
    direct = str(tmp_path / "direct")
    assert cli.main([*pair_paths, "0.15", "7", "9", "2", "--shifts", "10", "--tier", "oracle",
                     "--outdir", direct]) == 0
    assert dumps(direct) == resumed["port"] and len(resumed["port"]) == 6


def test_cli_oracle_refuses_modern(pair_paths, tmp_path, capsys):
    argv = [*pair_paths, "--pipeline", "modern", "--tier", "oracle",
            "--outdir", str(tmp_path / "o")]
    assert cli.main(argv) == 1
    port_err = capsys.readouterr().err
    assert j_cli.main(argv) == 1
    assert port_err == capsys.readouterr().err
    assert port_err == "error: --tier oracle is not available for --pipeline modern\n"
    assert not (tmp_path / "o").exists()


def test_cli_oracle_imports_no_torch(pair_paths, tmp_path):
    """The oracle tier, the host codec's first call included (its build
    into an empty directory, the PNG reads and the PPM writes), imports
    no torch and nothing of JAX."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from stereomatching_tpu_torch import cli\n"
        "from stereomatching_tpu_torch.utils import build, native\n"
        f"build.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        f"assert cli.main([{pair_paths[0]!r}, {pair_paths[1]!r}, '--shifts', '6', "
        f"'--tier', 'oracle', '--outdir', {str(tmp_path / 'o')!r}]) == 0\n"
        "assert native._lib.cache_info().currsize == 1\n"
        "assert len(list(build.BUILD_DIR.glob('stereo_io-*.so'))) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
        "'stereomatching_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(dumps(str(tmp_path / "o"))) == 6
