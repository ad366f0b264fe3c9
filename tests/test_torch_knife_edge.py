"""The port's knife-edge gate (``tools/knife_edge_torch.py``) on a scene
with planted rational ties of the edge predicate.

At threshold 0.15 the exact rule's predicate 2|ka - kb| > 0.15 (ka + kb)
ties where 40 |ka - kb| = 3 (ka + kb), for example at 3-pixel sums 43
and 37.  Whether the reference rule's float order fires there is a matter
of rounding, so some such patches flip between the two rules; the test
searches small candidates with the port's oracle under both rules and
plants those that flip.  The gate then passes on the port's ``--tier cpu
--edge-rule exact`` PPMs against the ``--tier oracle --edge-rule
reference`` ones with at least one proven tie, fails on a flipped non-tie
edge pixel and on a corrupted downstream PPM, and counts what the JAX
package's ``tools/knife_edge.py`` counts on the same directories.  No
test reads the C reference's fixtures.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest

from stereomatching_tpu.config import BoundaryMode as JBoundaryMode
from stereomatching_tpu.config import StereoParams as JStereoParams
from stereomatching_tpu_torch import cli
from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.oracle.pipeline import find_edges
from stereomatching_tpu_torch.utils.imageio import (
    artifact_ppm_type, read_ppm, to_brightness, write_png_gray, write_ppm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The pipeline's params for the CLI runs and the gate: small, to keep the
# oracle quick.
SW, TIMES, LINES, SHIFTS = 9, 6, 4, 8


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


def _patch(ka: int, kb: int) -> np.ndarray:
    """A 9x9 cell whose centre's left-right operator compares 3-pixel sums
    ka (left column) and kb (right column); the rest is their mean, so no
    other operator fires there."""
    m = (ka + kb) // 6
    cell = np.full((9, 9), m, np.uint8)
    cell[3:6, 3] = [ka // 3 + (i < ka % 3) for i in range(3)]
    cell[3:6, 5] = [kb // 3 + (i < kb % 3) for i in range(3)]
    return cell


def _flipping_ties():
    """Tie patches (ka, kb) = (43k, 37k) and swapped whose centre the two
    rules decide differently."""
    out = []
    for k in range(1, 18):
        for ka, kb in ((43 * k, 37 * k), (37 * k, 43 * k)):
            assert 40 * abs(ka - kb) == 3 * (ka + kb)  # a rational tie at t = 0.15
            br = to_brightness(_patch(ka, kb))
            ref = find_edges(br, 0.15, BoundaryMode.WRAP, rule="reference")
            exact = find_edges(br, 0.15, BoundaryMode.WRAP, rule="exact")
            if ref[4, 4] != exact[4, 4]:
                out.append((ka, kb))
    return out


def _scene(ties):
    """48 x 64 random texture with two flipping tie patches planted; the
    right image is the left shifted 4 pixels (right(x) = left(x - 4))."""
    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    for (y, x), (ka, kb) in zip(((6, 6), (30, 34)), ties):
        left[y:y + 9, x:x + 9] = _patch(ka, kb)
    return left, np.roll(left, 4, axis=1)


@pytest.fixture(scope="module")
def ties():
    found = _flipping_ties()
    assert len(found) >= 1, "no candidate tie flips between the two rules"
    return found


def _dirs(tmp_path, ties, mode: str):
    left, right = _scene(ties[:2])
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, left)
    write_png_gray(b, right)
    pos = ["0.15", str(SW), str(TIMES), str(LINES), "--shifts", str(SHIFTS), "--mode", mode]
    ref, ours = str(tmp_path / "ref"), str(tmp_path / "ours")
    assert cli.main([a, b, *pos, "--tier", "oracle", "--edge-rule", "reference",
                     "--outdir", ref]) == 0
    assert cli.main([a, b, *pos, "--tier", "cpu", "--edge-rule", "exact",
                     "--outdir", ours]) == 0
    return a, b, ref, ours


def _gate_args(ref, ours, a, b, mode):
    return [ref, ours, a, b, "--mode", mode, "--square-width", str(SW), "--times", str(TIMES),
            "--lines", str(LINES), "--shifts", str(SHIFTS)]


def test_planted_ties_flip(ties):
    left, _ = _scene(ties[:2])
    br = to_brightness(left)
    ref = find_edges(br, 0.15, BoundaryMode.WRAP, rule="reference")
    exact = find_edges(br, 0.15, BoundaryMode.WRAP, rule="exact")
    assert ref[10, 10] != exact[10, 10]  # the first planted patch's centre
    ke = _tool("knife_edge_torch")
    diffs = ke.classify_edge_diffs(br, ref, exact, "0.15", BoundaryMode.WRAP)
    assert (10, 10) in {(d.y, d.x) for d in diffs}
    assert all(d.is_tie and d.margin == 0.0 for d in diffs)


@pytest.mark.parametrize("mode", ["ghost", "wrap"])
def test_gate_passes_with_ties_and_matches_jax_tool(tmp_path, ties, mode, capsys):
    a, b, ref, ours = _dirs(tmp_path, ties, mode)
    ke = _tool("knife_edge_torch")
    params = StereoParams(square_width=SW, times=TIMES, lines=LINES, num_shifts=SHIFTS,
                          mode=BoundaryMode(mode), edge_rule="exact")
    n_tie, n_ok = ke.gate_pair(ref, ours, a, b, "0.15", params, 2e-4, verbose=False)
    assert n_tie >= 1
    assert n_ok == len(ke.DOWNSTREAM)
    assert ke.main(_gate_args(ref, ours, a, b, mode)) == 0
    assert f"OK [{mode}]: {n_tie} edge diff(s)" in capsys.readouterr().out

    jke = _tool("knife_edge")
    jparams = JStereoParams(square_width=SW, times=TIMES, lines=LINES, num_shifts=SHIFTS,
                            mode=JBoundaryMode(mode), edge_rule="exact")
    assert jke.gate_pair(ref, ours, a, b, "0.15", jparams, 2e-4, verbose=False) == (n_tie, n_ok)


def test_gate_fails_on_non_tie_edge_flip(tmp_path, ties, capsys):
    a, b, ref, ours = _dirs(tmp_path, ties, "ghost")
    bad = str(tmp_path / "bad")
    shutil.copytree(ours, bad)
    edges = (read_ppm(os.path.join(bad, "edges-1.ppm")) == 0).astype(np.uint8)
    flat = np.flatnonzero(edges == 0)
    edges.flat[flat[len(flat) // 2]] = 1  # a pixel no rule calls an edge
    write_ppm(os.path.join(bad, "edges-1.ppm"), edges, artifact_ppm_type("edges-1"))
    ke = _tool("knife_edge_torch")
    assert ke.main(_gate_args(ref, bad, a, b, "ghost")) == 1
    assert "NOT an edge-rule knife edge" in capsys.readouterr().err


def test_gate_fails_on_corrupted_downstream_ppm(tmp_path, ties, capsys):
    a, b, ref, ours = _dirs(tmp_path, ties, "ghost")
    path = os.path.join(ours, "web-2.ppm")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    i = data.rindex(b"\n", 0, len(data) - 1) + 1  # the last pixel's line
    data[i:] = b"7 7 7\n" if not data[i:].startswith(b"7 ") else b"8 8 8\n"
    with open(path, "wb") as f:
        f.write(bytes(data))
    ke = _tool("knife_edge_torch")
    assert ke.main(_gate_args(ref, ours, a, b, "ghost")) == 1
    assert "web-2: tier artifact differs" in capsys.readouterr().err
