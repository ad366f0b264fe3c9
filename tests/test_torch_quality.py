"""The port's quality side against the JAX package's on the same seeded
inputs: every synthetic scene and perturbation array-equal to
``stereomatching_tpu/utils/synthetic.py``'s, the metric reports equal key
for key, and ``tools/eval_quality_torch.py --device cpu`` printing the
JSON of ``tools/eval_quality.py`` (JAX on the CPU), both tools called in
process: the box route on the built-in synthetic scene, and the SGM
route on PNG files with PFM ground truth under a photometric
perturbation."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from stereomatching_tpu.utils import metrics as j_metrics
from stereomatching_tpu.utils import synthetic as j_synthetic
from stereomatching_tpu_torch.data.formats import write_pfm
from stereomatching_tpu_torch.utils import metrics, synthetic
from stereomatching_tpu_torch.utils.imageio import write_png_gray

ROOT = Path(__file__).resolve().parent.parent


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name, kwargs", [
    ("blob_scene", {}),
    ("blob_scene", dict(h=64, w=90, seed=3, max_disparity=20, n_blobs=9)),
    ("textured_shift", dict(h=20, w=33, shift=5, seed=2)),
    ("random_dot_stereogram", dict(h=30, w=41, seed=1)),
    ("random_dot_stereogram", dict(h=30, w=41, seed=4, max_disparity=13)),
    ("slanted_plane", dict(h=25, w=37, seed=0)),
    ("slanted_plane", dict(h=25, w=37, seed=6, d_min=0.5, d_max=11.0)),
])
def test_synthetic_scenes_against_jax(name, kwargs):
    got = getattr(synthetic, name)(**kwargs)
    want = getattr(j_synthetic, name)(**kwargs)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert same(a, b)
    assert same(synthetic.occlusion_mask(np.asarray(got[2]).astype(np.int32)),
                j_synthetic.occlusion_mask(np.asarray(want[2]).astype(np.int32)))


@pytest.mark.parametrize("kwargs", [
    {}, dict(noise_sigma=3.0), dict(gain=1.3, bias=-12.0),
    dict(noise_sigma=2.0, gain=0.8, bias=5.0, seed=7),
])
def test_photometric_perturb_against_jax(kwargs):
    left, right, _ = synthetic.blob_scene(40, 60, seed=1)
    for a, b in zip(synthetic.photometric_perturb(left, right, **kwargs),
                    j_synthetic.photometric_perturb(left, right, **kwargs)):
        assert same(a, b)
    assert synthetic.size_sweep_sizes() == j_synthetic.size_sweep_sizes()


def test_metric_reports_against_jax():
    """bad-1, bad-2, EPE and coverage: with and without a validity mask,
    NaN ground truth excluded, an all-masked plane, float32 and int
    disparity planes; the same keys and the same floats."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 30, (21, 27))
    gt[rng.random(gt.shape) < 0.1] = np.nan
    pred = gt + rng.normal(0, 1.5, gt.shape)
    valid = rng.random(gt.shape) < 0.8
    cases = [(pred, gt, None), (pred.astype(np.float32), gt, valid),
             (np.rint(np.nan_to_num(pred)).astype(np.int32), gt.astype(np.float32), valid),
             (pred, gt, np.zeros(gt.shape, bool)), (pred, np.full(gt.shape, np.nan), None)]
    for d, g, v in cases:
        got, want = metrics.disparity_report(d, g, v), j_metrics.disparity_report(d, g, v)
        assert list(got) == list(want) == ["bad1", "bad2", "epe", "coverage"]
        for k in want:
            assert type(got[k]) is float and got[k] == want[k], k
        for t in (0.5, 1.0, 3.0):
            assert metrics.bad_pixel_rate(d, g, t, v) == j_metrics.bad_pixel_rate(d, g, t, v)
        assert metrics.end_point_error(d, g, v) == j_metrics.end_point_error(d, g, v)


def run_tool(path: Path, argv, capsys, monkeypatch) -> dict:
    """Load a tool's file as a module, run its ``main`` with ``argv``
    and -> its printed JSON."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    capsys.readouterr()
    assert mod.main() == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("case", ["box-synthetic", "sgm-files"])
def test_eval_quality_torch_equals_jax_tool(tmp_path, capsys, monkeypatch, case):
    if case == "box-synthetic":
        argv = ["--synthetic", "12"]
    else:
        left, right, gt = synthetic.blob_scene(60, 96, seed=2, max_disparity=10)
        files = [str(tmp_path / n) for n in ("l.png", "r.png", "gt.pfm")]
        write_png_gray(files[0], left)
        write_png_gray(files[1], right)
        write_pfm(files[2], gt.astype(np.float32))
        argv = [*files, "--aggregation", "sgm", "--cost", "census", "--disparities", "16",
                "--noise", "2", "--gain", "1.1", "--uniqueness-min", "1.05"]
    port = run_tool(ROOT / "tools" / "eval_quality_torch.py", [*argv, "--device", "cpu"],
                    capsys, monkeypatch)
    ref = run_tool(ROOT / "tools" / "eval_quality.py", argv, capsys, monkeypatch)
    assert port == ref
    assert set(port) >= {"valid_pixels", "filled_all_pixels", "params"}
    if case == "box-synthetic":
        assert set(port) == {"valid_pixels", "filled_all_pixels", "params",
                             "nonoccluded_valid", "occlusion"}
        assert port["valid_pixels"]["bad2"] < 0.2


def test_eval_quality_torch_refuses_missing_gpu(capsys, monkeypatch):
    """The tool defaults to the card; a host without one is an error."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal is for hosts without one")
    spec = importlib.util.spec_from_file_location(
        "eval_quality_torch", ROOT / "tools" / "eval_quality_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval_quality_torch.py", "--synthetic", "12"])
    assert mod.main() == 1
    assert "error: --device cuda" in capsys.readouterr().err
