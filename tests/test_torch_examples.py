"""The port's demos (``examples/torch_*_demo.py``) end to end on the CPU
(``--device cpu``) at the JAX demo tests' small sizes: each exits 0 and
writes its artifacts, the serving demo prints its pad-and-slice line, and
none reads a fixture outside the repository (the classic demo defaults to
the port's synthetic scene)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run(script, *args, cwd):
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_torch_classic_demo(tmp_path):
    r = run("torch_classic_demo.py", "--outdir", str(tmp_path / "out"), cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "pair: 240x135"
    assert sum(ln.startswith("width = 240, height = 135, t1 = ") for ln in lines) == 2
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"{m}-{n}.ppm" for m in ("wrap", "ghost") for n in ("output-0", "web-2", "edges-1"))
    assert all(p.read_bytes().startswith(b"P3\n") for p in (tmp_path / "out").iterdir())


def test_torch_modern_demo(tmp_path):
    r = run("torch_modern_demo.py", "--disparities", "8", "--outdir", str(tmp_path / "out"),
            cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    labels = [ln.split()[0] for ln in r.stdout.splitlines()[:4]]
    assert labels == ["box-sad", "box-census", "sgm-census", "sgm-8dir-full"]
    assert len(list((tmp_path / "out").glob("*-disparity.npy"))) == 4


def test_torch_serving_demo(tmp_path):
    r = run("torch_serving_demo.py", "--size", "128", "--batch", "4", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "equal to the host batch: True" in r.stdout
    assert "single pair via pad-and-slice: (1, 128, 128)" in r.stdout
    assert "sharded over {'data': 2, 'rows': 2}" in r.stdout
