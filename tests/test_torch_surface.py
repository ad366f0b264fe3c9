"""The port's public surface against the JAX package's: every name of the
JAX ``__all__`` lists (the package, ``models``, ``ops``, ``bench``,
``parallel``, ``oracle``, ``data``) and every public function of
``utils/artifacts.py`` resolves in the port, under the same name but for
two (``ops.match_and_score_pallas`` is the kernel wrapper
``ops.match_and_score_kernel``, ``bench.time_jitted`` is
``bench.time_fn``); the constants are equal; ``compare_artifacts`` gives
the JAX function's lists; and importing the package, ``models`` or
``ops`` imports nothing of JAX and builds no kernel."""

import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import stereomatching_tpu
from stereomatching_tpu.utils import artifacts as j_artifacts
from stereomatching_tpu_torch.utils import artifacts as p_artifacts

ROOT = Path(__file__).resolve().parent.parent

# JAX name -> port name, where they differ.
RENAMED = {
    ("ops", "match_and_score_pallas"): "match_and_score_kernel",
    ("bench", "time_jitted"): "time_fn",
}
SUBPACKAGES = ["", "models", "ops", "bench", "parallel", "oracle", "data"]


def _module(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}" if sub else pkg)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    jax_mod = _module("stereomatching_tpu", sub)
    port_mod = _module("stereomatching_tpu_torch", sub)
    missing = []
    for name in jax_mod.__all__:
        port_name = RENAMED.get((sub, name), name)
        if port_name not in port_mod.__all__ or not hasattr(port_mod, port_name):
            missing.append(f"{name} -> {port_name}")
    assert not missing, f"stereomatching_tpu_torch.{sub}: {missing}"


def test_renamed_exports_are_the_counterparts():
    from stereomatching_tpu_torch import bench, ops
    from stereomatching_tpu_torch.bench import harness
    from stereomatching_tpu_torch.ops import fused

    assert ops.match_and_score_kernel is fused.match_and_score
    assert bench.time_fn is harness.time_fn


def test_artifact_functions_resolve_in_the_port():
    public = [n for n, f in inspect.getmembers(j_artifacts, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == j_artifacts.__name__]
    assert sorted(public) == ["compare_artifacts", "load_artifacts", "save_artifacts"]
    for name in public:
        assert callable(getattr(p_artifacts, name)), name


@pytest.mark.parametrize("name", ["DEFAULT_THRESHOLD", "DEFAULT_SQUARE_WIDTH",
                                  "DEFAULT_TIMES", "DEFAULT_LINES", "NUM_SHIFTS"])
def test_constants_equal_the_jax_package(name):
    import stereomatching_tpu_torch

    assert name in stereomatching_tpu_torch.__all__
    got, want = getattr(stereomatching_tpu_torch, name), getattr(stereomatching_tpu, name)
    assert type(got) is type(want) and got == want


def _compare_cases():
    """``tests/test_bench_metrics.py``'s artifact cases, as (a, b, atol)."""
    arts = {"web-1": np.arange(12, dtype=np.int32).reshape(3, 4),
            "output-0": np.ones((3, 4), np.uint8)}
    changed = {"web-1": arts["web-1"].copy(), "output-0": arts["output-0"]}
    changed["web-1"][0, 0] = 99
    a = {"x": np.array([1.0, 2.0])}
    b = {"x": np.array([1.0, 2.0 + 1e-7])}
    return [(arts, dict(arts), 0.0), (arts, changed, 0.0), (arts, {"web-1": arts["web-1"]}, 0.0),
            (a, b, 0.0), (a, b, 1e-6)]


def _random_dicts(seed):
    """Two artifact dicts that share some names, differ in some shapes,
    values (by more or less than 1e-3) and dtypes, and hold NaN."""
    rng = np.random.default_rng(seed)
    a, b = {}, {}
    for i in range(int(rng.integers(1, 9))):
        name = f"k{int(rng.integers(0, 12))}-{i}"
        shape = tuple(int(s) for s in rng.integers(1, 5, int(rng.integers(0, 3))))
        x = rng.normal(size=shape).astype(rng.choice([np.float32, np.float64]))
        if rng.random() < 0.2 and x.size:
            x.flat[0] = np.nan
        where = rng.integers(0, 6)
        if where != 1:
            a[name] = x
        if where == 1 or where >= 2:
            y = x.copy()
            if where == 3:
                y = y + rng.choice([1e-4, 1e-2])
            elif where == 4:
                y = y.reshape(-1)[:max(y.size - 1, 0)]
            elif where == 5:
                y = np.nan_to_num(y).astype(np.int32)
            b[name] = y
    return a, b, float(rng.choice([0.0, 1e-3]))


@pytest.mark.parametrize("case", range(5 + 12))
def test_compare_artifacts_matches_jax(case):
    a, b, atol = _compare_cases()[case] if case < 5 else _random_dicts(case)
    want = j_artifacts.compare_artifacts(a, b, atol=atol)
    assert p_artifacts.compare_artifacts(a, b, atol=atol) == want
    assert p_artifacts.compare_artifacts(b, a, atol=atol) == j_artifacts.compare_artifacts(
        b, a, atol=atol)


def test_package_imports_build_no_kernel_and_import_no_jax():
    """``import stereomatching_tpu_torch`` imports no torch; importing
    ``models`` and ``ops`` (every kernel wrapper module with them), and
    the host codec's binding with the modules that call it, calls no
    library build, loads no library and imports nothing of JAX."""
    code = (
        "import os, sys\n"
        "import stereomatching_tpu_torch as p\n"
        "assert p.NUM_SHIFTS == 30 and p.DEFAULT_TIMES == 32\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'torch']\n"
        "from stereomatching_tpu_torch.utils import build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a kernel was built at import')\n"
        "build.load = build.build_all = refuse\n"
        "import stereomatching_tpu_torch.models, stereomatching_tpu_torch.ops\n"
        "from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_modern, "
        "fused_sgm\n"
        "from stereomatching_tpu_torch.models import build_classic_pipeline\n"
        "from stereomatching_tpu_torch.ops import match_and_score_kernel\n"
        "import stereomatching_tpu_torch.utils.native, stereomatching_tpu_torch.utils.imageio\n"
        "import stereomatching_tpu_torch.data.loader, stereomatching_tpu_torch.cli\n"
        "from stereomatching_tpu_torch.utils import native\n"
        "assert native._lib.cache_info().currsize == 0\n"
        "assert not list(build.BUILD_DIR.glob(f'*.{os.getpid()}.*.tmp'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'stereomatching_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
