"""The port at the sizes the JAX package runs, at CPU sizes:
``tools/size_sweep_torch.py`` (the counterpart of
``tools/size_sweep_tpu.py``: its ladder, its batch rule, its checksum of
four planes against the JAX XLA tier), the classic pipeline at D=256 and
at D past the image's width, box and SGM at D=256 with the LR check and
the sub-pixel plane, all bitwise the JAX XLA tier, and the package data
that an installed port builds its kernels from.  The full sizes
themselves run on the card (``chip_smoke.py`` phase 36)."""

import ast
import fnmatch
import importlib.util
import json
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import BoundaryMode, StereoParams
from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.models import classic as j_classic
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import classic, modern
from stereomatching_tpu_torch.utils import build

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "size_sweep_torch.py"
JAX_TOOL = ROOT / "tools" / "size_sweep_tpu.py"
JAX_KEYS = {"size", "batch", "d", "ms_per_pair", "pairs_per_sec", "checksum"}


def load_tool():
    spec = importlib.util.spec_from_file_location("size_sweep_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tool_sizes():
    """``SIZES`` of the JAX tool, read from its source (importing it sets
    JAX's cache variables)."""
    for node in ast.parse(JAX_TOOL.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SIZES":
            return ast.literal_eval(node.value)
    raise AssertionError("no SIZES in the JAX tool")


def jax_batch(w, h):
    """The JAX tool's batch rule, as it is written there."""
    return max(1, min(128, int(2 ** np.floor(np.log2(128 * 1024 * 1024 / max(w * h, 1))))))


def jax_plane_sum(left_u8, right_u8, params):
    """The JAX XLA tier's sum of the tool's four planes on one batch."""
    out = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(left_u8.astype(np.float32) / np.float32(256.0)),
        jnp.asarray(right_u8.astype(np.float32) / np.float32(256.0)), params, use_pallas=False))
    return sum(int(np.asarray(out[k]).astype(np.int64).sum())
               for k in ("score_best", "web-2", "output-0", "edges-1"))


def assert_equal(port, ref):
    port = {k: v.numpy() for k, v in port.items()}
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        assert np.array_equal(port[k].view(np.uint8), v.view(np.uint8)), k


def shifted_textures(n, h, w, seed=0):
    """uint8 pairs [n, h, w] whose right image is the left one shifted by
    a disparity between 0 and w - 1 (np.roll: right(x) = left(x + s))."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    right = np.stack([np.roll(a, -int(s), axis=1)
                      for a, s in zip(left, rng.integers(0, w, n))])
    return left, right


@pytest.mark.parametrize("i", range(6))
def test_sweep_ladder_and_batch_rule_match_the_jax_tool(i):
    tool = load_tool()
    sizes = jax_tool_sizes()
    assert tool.SIZES == sizes and len(sizes) == 6 and sizes[-1] == (7680, 4320)
    w, h = sizes[i]
    assert tool.batch_for(w, h) == jax_batch(w, h)
    assert tool.batch_for(7680, 4320) == 4


def test_sweep_tool_checksums_match_the_jax_xla_tier():
    res = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--sizes", "24x40,36x64", "--iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert [r["size"] for r in lines] == ["24x40", "36x64"]
    tool = load_tool()
    params = StereoParams(num_shifts=64, mode=BoundaryMode.GHOST, edge_rule="exact")
    for r in lines:
        assert JAX_KEYS | {"route", "device", "peak_mib", "card"} == set(r)
        w, h = (int(v) for v in r["size"].split("x"))
        assert (r["batch"], r["d"], r["route"], r["device"]) == (128, 64, "plain", "cpu")
        assert r["peak_mib"] is None and r["card"] is None and r["ms_per_pair"] > 0
        want = sum(jax_plane_sum(a, b, params) for a, b in tool.sweep_pairs(w, h, 2))
        assert r["checksum"] == want


def test_sweep_tool_takes_the_card_by_default_and_imports_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(TOOL)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "m.main(['--device', 'cpu', '--sizes', '24x24', '--iters', '1'])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'stereomatching_tpu')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    m.main(['--sizes', '24x24', '--iters', '1'])\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "refused: device 'cuda' requested" in res.stdout


# (mode, rule, D, H, W): D 256 on rows wider than it, and D past W.
CLASSIC_CASES = [(mode, rule, 256, 24, 300) for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)
                 for rule in ("exact", "reference")]
CLASSIC_CASES += [(BoundaryMode.WRAP, rule, 100, 24, 48) for rule in ("exact", "reference")]
CLASSIC_CASES += [(BoundaryMode.GHOST, "exact", 100, 24, 48)]


@pytest.mark.parametrize("mode,rule,d,h,w", CLASSIC_CASES)
def test_classic_at_large_d_matches_jax(mode, rule, d, h, w):
    params = StereoParams(num_shifts=d, square_width=21, times=8, mode=mode, edge_rule=rule)
    lu, ru = shifted_textures(2, h, w, seed=d + w)
    left, right = (x.astype(np.float32) / np.float32(256.0) for x in (lu, ru))
    ref = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(left), jnp.asarray(right), params, use_pallas=False, subpixel=True))
    pp = params_from_jax(params)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    assert_equal(classic.classic_forward_batched(lt, rt, pp, subpixel=True), ref)
    assert_equal(classic.classic_forward_reference(lt, rt, pp, subpixel=True), ref)


# Box (K7 twice, LR, K6), SGM (K3, K4 x 4, K5, K6) and the 8-direction
# stack (K4 x 8, K5 with the second best) at phase 36's D and params.
MODERN_CASES = {
    "box SAD window 9": dict(num_disparities=256, window=9, cost="sad"),
    "SGM census 4 paths": dict(num_disparities=256, aggregation="sgm", cost="census"),
    "SGM census 8 paths, median, uniqueness": dict(
        num_disparities=256, aggregation="sgm", cost="census", sgm_directions=8,
        median_filter=True, uniqueness=True),
}


@pytest.mark.parametrize("name", MODERN_CASES)
def test_modern_at_256_disparities_matches_jax(name):
    jp = JModernParams(**MODERN_CASES[name])
    lu, ru = shifted_textures(2, 20, 290, seed=256)
    fn = j_modern.build_modern_pipeline(jp, batched=True)
    ref = jax.device_get(fn(jnp.asarray(lu, jnp.int32), jnp.asarray(ru, jnp.int32)))
    pp = params_from_jax(jp)
    assert modern.plain_stages(pp) == {}
    lt, rt = torch.from_numpy(lu), torch.from_numpy(ru)
    assert_equal(modern.modern_forward(lt, rt, pp), ref)
    assert_equal(modern.modern_forward_reference(lt, rt, pp), ref)


def test_package_data_ships_every_source_the_build_compiles():
    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["stereomatching_tpu_torch"]
    sources = sorted(p.name for p in build.CSRC.iterdir() if p.is_file())
    assert {Path(s).suffix for s in sources} == {".cu", ".cuh", ".cpp"}
    for name in sources:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
    # The host codec is one of them (the build's ``.cpp`` route).
    assert build._host("stereo_io")
