"""The PyTorch port's classic pipeline as a whole: ``classic_forward``,
``classic_forward_batched``, ``ClassicPipeline`` and ``Matcher`` held
bitwise against the JAX package's XLA tier and the numpy oracle, the
checkpoint resume across the two packages, and the port's boundaries
(no jax import, no silent CPU fallback)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu.models import classic as j_classic
from stereomatching_tpu.oracle import run_pipeline
from stereomatching_tpu.utils.artifacts import load_artifacts, save_artifacts
from stereomatching_tpu_torch import interop
from stereomatching_tpu_torch.config import ModernParams as PortModernParams
from stereomatching_tpu_torch.config import StereoParams as PortStereoParams
from stereomatching_tpu_torch.models import classic
from stereomatching_tpu_torch.ops.contour import contour_bands
from stereomatching_tpu_torch.ops.fused import match_score_edges_reference
from stereomatching_tpu_torch.ops.fused_diffusion import fill_web_holes_range_reference
from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
from stereomatching_tpu_torch.utils import build
from stereomatching_tpu_torch.utils.device import resolve_device
from tests.util import synthetic_pair

ROOT = Path(__file__).resolve().parent.parent
MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


def u8_batch(n=3, h=48, w=64):
    pairs = [synthetic_pair(h, w, seed=s) for s in range(n)]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def to_f32(u8):
    return u8.astype(np.float32) / np.float32(256.0)


def assert_artifacts_equal(port, ref):
    port = interop.artifacts_to_numpy(port)
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert port[k].dtype == v.dtype, k
        assert np.array_equal(port[k], v), k


def params_for(mode, rule, d=16, sw=21):
    return StereoParams(num_shifts=d, square_width=sw, times=8, mode=mode, edge_rule=rule)


@pytest.mark.parametrize("shifts_sw", [(8, 7), (16, 21)])
@pytest.mark.parametrize("rule", ["exact", "reference"])
@pytest.mark.parametrize("mode", MODES)
def test_classic_batched_matches_jax_and_oracle(mode, rule, shifts_sw):
    params = params_for(mode, rule, *shifts_sw)
    lu, ru = u8_batch()
    left, right = to_f32(lu), to_f32(ru)
    port = classic.classic_forward_batched(torch.from_numpy(left), torch.from_numpy(right),
                                           interop.params_from_jax(params))
    ref = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(left), jnp.asarray(right), params, use_pallas=False))
    assert_artifacts_equal(port, ref)
    # The oracle in float64 (the reference rule's float ops run in the
    # input dtype, so the port gets float64 input for this comparison).
    port64 = classic.classic_forward_batched(
        torch.from_numpy(lu / 256.0), torch.from_numpy(ru / 256.0), interop.params_from_jax(params))
    for i in range(lu.shape[0]):
        for k, v in run_pipeline(lu[i] / 256.0, ru[i] / 256.0, params).items():
            assert np.array_equal(port64[k][i].numpy(), v), k


@pytest.mark.parametrize("mode", MODES)
def test_classic_forward_single_pair_and_plain_route(mode):
    params = params_for(mode, "exact")
    lu, ru = u8_batch(1)
    left, right = torch.from_numpy(to_f32(lu[0])), torch.from_numpy(to_f32(ru[0]))
    port = classic.classic_forward(left, right, interop.params_from_jax(params))
    ref = jax.device_get(j_classic.classic_forward(
        jnp.asarray(to_f32(lu[0])), jnp.asarray(to_f32(ru[0])), params))
    assert_artifacts_equal(port, ref)
    assert port["min_elevation"].ndim == 0
    # On CPU tensors the pipeline takes the kernels' plain versions.
    pp = interop.params_from_jax(params)
    best, winner, edges_l, edges_r = match_score_edges_reference(left, right, pp)
    web, min_e, max_e = fill_web_holes_range_reference(winner, pp.times)
    assert_artifacts_equal({
        "edges-1": edges_l, "edges-2": edges_r, "score_best": best, "web-1": winner,
        "web-2": web, "output-0": contour_bands(web, params.lines, min_e, max_e),
        "min_elevation": min_e, "max_elevation": max_e,
    }, ref)
    with pytest.raises(ValueError):
        classic.classic_forward_batched(left, right, pp)


def test_classic_pipeline_module():
    params = params_for(BoundaryMode.GHOST, "exact")
    pipe = classic.build_classic_pipeline(interop.params_from_jax(params))
    assert isinstance(pipe, torch.nn.Module)
    assert list(pipe.parameters()) == []
    lu, ru = u8_batch(2)
    left, right = torch.from_numpy(to_f32(lu)), torch.from_numpy(to_f32(ru))
    batched = pipe(left, right)
    single = pipe(left[1], right[1])
    for k in batched:
        assert torch.equal(batched[k][1], single[k]), k
    with pytest.raises(ValueError):
        pipe(left[:, :10, :10], right[:, :10, :10])  # square_width 21 > 10


@pytest.mark.parametrize("mode", MODES)
def test_matcher_cpu_matches_jax(mode):
    params = params_for(mode, "exact")
    lu, ru = u8_batch()
    m = Matcher(interop.params_from_jax(params), device="cpu")
    arts = m(lu, ru)
    ref = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(to_f32(lu)), jnp.asarray(to_f32(ru)), params))
    assert_artifacts_equal(arts, ref)
    single = m(lu[2], ru[2])
    for k, v in arts.items():
        assert np.array_equal(single[k], v[2]), k
    with pytest.raises(ValueError):
        m(lu, ru[:, :, :32])


def test_resume_across_packages(tmp_path):
    """A web-1 checkpoint written by the JAX package resumes in the
    port's classic_finish, and the other way round."""
    params = params_for(BoundaryMode.GHOST, "exact")
    lu, ru = u8_batch(2)
    jax_arts = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(to_f32(lu)), jnp.asarray(to_f32(ru)), params))
    path = tmp_path / "jax.npz"
    save_artifacts(str(path), {**jax_arts, "params": np.asarray(params.to_json())})
    ck = interop.artifacts_from_numpy(load_artifacts(str(path)), "cpu")
    assert ck["web-1"].dtype == torch.int32 and ck["min_elevation"].shape == (2,)
    assert isinstance(ck["params"], np.ndarray)  # non-numeric entries pass through
    fin = classic.classic_finish(ck["web-1"], PortStereoParams.from_json(str(ck["params"])))
    assert_artifacts_equal(fin, {k: jax_arts[k] for k in fin})

    port_arts = classic.classic_forward_batched(
        torch.from_numpy(to_f32(lu)), torch.from_numpy(to_f32(ru)),
        interop.params_from_jax(params))
    path2 = tmp_path / "port.npz"
    save_artifacts(str(path2), interop.artifacts_to_numpy(port_arts))
    winner = load_artifacts(str(path2))["web-1"]
    jfin = jax.device_get(jax.vmap(lambda w: j_classic.classic_finish(w, params))(
        jnp.asarray(winner)))
    assert_artifacts_equal({k: port_arts[k] for k in jfin}, jfin)


@pytest.mark.parametrize("rule", ["exact", "reference"])
def test_classic_routes_pass_k2_their_bound(monkeypatch, rule):
    """The forward and the collect pipeline hand K2 the winner plane's
    proven bound ``num_shifts + 1`` (its values lie in [0, num_shifts]);
    the resume path hands it ``None``, so a web read from a file runs on
    int32 storage.  The artifacts equal the JAX XLA tier's either way."""
    seen = []
    real = classic.fill_web_holes_range

    def spy(web, times, value_bound=None):
        seen.append(value_bound)
        if value_bound is not None:
            assert 0 <= int(web.min()) and int(web.max()) < value_bound
        return real(web, times, value_bound)

    monkeypatch.setattr(classic, "fill_web_holes_range", spy)
    params = params_for(BoundaryMode.GHOST, rule)
    pp = interop.params_from_jax(params)
    lu, ru = u8_batch(2)
    left, right = torch.from_numpy(to_f32(lu)), torch.from_numpy(to_f32(ru))
    arts = classic.build_classic_pipeline(pp)(left, right)
    collect = classic.build_classic_collect_pipeline(pp)(left, right)
    resumed = classic.build_classic_finish_pipeline(pp)(arts["web-1"])
    assert seen == [pp.num_shifts + 1, pp.num_shifts + 1, None]
    ref = jax.device_get(j_classic.classic_forward_batched(
        jnp.asarray(to_f32(lu)), jnp.asarray(to_f32(ru)), params))
    assert_artifacts_equal(arts, ref)
    for k in resumed:
        assert torch.equal(resumed[k], arts[k]) and torch.equal(collect[k], arts[k]), k


def test_import_does_not_load_jax():
    """Importing every module of the port (and its lazy exports) loads
    neither jax nor any module of the JAX package."""
    code = (
        "import pkgutil, sys\n"
        "import stereomatching_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "from stereomatching_tpu_torch import (\n"
        "    Matcher, ClassicPipeline, ModernMatcher, ModernPipeline, ModernParams)\n"
        "import stereomatching_tpu_torch.ops.fused_modern\n"
        "import stereomatching_tpu_torch.cli, stereomatching_tpu_torch.utils.imageio\n"
        "import stereomatching_tpu_torch.utils.artifacts\n"
        "for m in ('ops.fused_modern', 'cli', 'utils.imageio', 'utils.artifacts'):\n"
        "    assert 'stereomatching_tpu_torch.' + m in names, names\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'stereomatching_tpu' or m.startswith('stereomatching_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("jax_params", [
    StereoParams(),
    StereoParams(threshold=0.3, square_width=7, times=4, lines=3, num_shifts=16,
                 mode=BoundaryMode.GHOST, edge_rule="exact"),
    ModernParams(),
    ModernParams(num_disparities=48, window=5, lr_max_diff=2, fill_iterations=3,
                 fill_mode="background", scales=2, coarse_weight=2, cost="census",
                 census_window=3, aggregation="sgm", sgm_p1=4, sgm_p2=50,
                 sgm_directions=8, median_filter=True, uniqueness=True),
])
def test_params_from_jax_round_trip(jax_params):
    """The JAX package's params cross into the port's classes with every
    field kept, and back through JSON."""
    port = interop.params_from_jax(jax_params)
    cls = PortStereoParams if isinstance(jax_params, StereoParams) else PortModernParams
    assert type(port) is cls
    assert port.to_json() == jax_params.to_json()
    assert type(jax_params).from_json(port.to_json()) == jax_params
    assert cls.from_json(port.to_json()) == port
    if cls is PortStereoParams:
        assert port.mode == jax_params.mode and port.half == jax_params.half
    with pytest.raises(TypeError):
        interop.params_from_jax({"num_shifts": 8})


def test_no_silent_cpu_fallback(tmp_path, monkeypatch):
    """Asking for CUDA without a GPU raises, and so does building the
    kernels without nvcc; neither returns a CPU stand-in."""
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Matcher(device="cuda")
    with pytest.raises(RuntimeError):
        ModernMatcher(PortModernParams(aggregation="sgm", cost="census"), device="cuda")
    with pytest.raises(RuntimeError):
        ModernMatcher()  # the box route on the default device, "cuda"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    for name in ("match_score_edges", "match_and_score", "sgm_volume", "sgm_directional",
                 "sgm_tail", "fill_invalid", "disparity"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build(name)
    assert not (tmp_path / "build").exists() or not os.listdir(tmp_path / "build")



def test_load_builds_once_across_threads(tmp_path, monkeypatch):
    """Two threads (two devices of a sharded mesh) asking for one library
    at once against an empty build dir run one nvcc and load one complete
    file.  The stub nvcc writes its output in two parts with a pause
    between, so a second build into the same temporary file, or a load of
    a half-written one, shows."""
    import threading

    nvcc, runs = tmp_path / "nvcc", tmp_path / "runs"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {runs}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'printf part > "$2"; sleep 0.5; printf done >> "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Path(path).read_text())
    start = threading.Barrier(2)
    got = []

    def one():
        start.wait()
        got.append(build.load("fill_invalid"))

    build._load.cache_clear()
    try:
        threads = [threading.Thread(target=one) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        build._load.cache_clear()
    assert got == ["partdone", "partdone"]
    assert runs.read_text().split() == ["run"]
    assert [f.suffix for f in (tmp_path / "build").iterdir()] == [".so"]
