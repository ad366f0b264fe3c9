"""The port's sharded classic tier (``stereomatching_tpu_torch.parallel``)
on CPU meshes of repeated ``"cpu"`` devices, held bitwise (tolerance 0
on every plane) against the JAX package's XLA sharded tier on its
8-device CPU mesh (``tests/conftest.py``) for the listed mesh shapes, and
against the port's own single-device pipeline for the rest of the JAX
tests' mesh lists.  Also: K9's plain version against the JAX prehalo
kernel in interpret mode, the halo exchanges, the validation errors, the
matchers with a mesh, and the CLI's ``--tier sharded``.

Inputs are ``tests/util.synthetic_pair`` pairs at 48x48 to 88x64 with 12
shifts and sw 9 (or the reference defaults).  JAX meshes and pipelines
are built once per shape and cached.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu import cli as j_cli
from stereomatching_tpu.config import BoundaryMode, StereoParams
from stereomatching_tpu.ops.fused import match_and_score_pallas_prehalo
from stereomatching_tpu.parallel import build_sharded_pipeline as j_build
from stereomatching_tpu.parallel import make_mesh as j_make_mesh
from stereomatching_tpu.utils import imageio as j_imageio
from stereomatching_tpu_torch import cli, interop
from stereomatching_tpu_torch.models.classic import classic_forward_batched
from stereomatching_tpu_torch.ops import fused
from stereomatching_tpu_torch.parallel import (
    build_sharded_pipeline, exchange_col_halo, exchange_row_halo, make_mesh,
    sharded_classic_forward, with_col_halo, with_row_halo)
from stereomatching_tpu_torch.parallel.mesh import Shards
from stereomatching_tpu_torch.parallel import distributed
from stereomatching_tpu_torch.serving import Matcher
from tests.util import synthetic_pair

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh (conftest)")

MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]
PLANES = ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0",
          "min_elevation", "max_elevation")


def _batch(n_pairs, h, w, seed0=0):
    pairs = [synthetic_pair(h=h, w=w, seed=seed0 + i) for i in range(n_pairs)]
    to_f = lambda x: x.astype(np.float32) / np.float32(256.0)  # noqa: E731
    return (np.stack([to_f(a) for a, _ in pairs]), np.stack([to_f(b) for _, b in pairs]))


def cpu_mesh(data, rows, cols=None):
    return make_mesh(data=data, rows=rows, cols=cols,
                     devices=["cpu"] * (data * rows * (cols or 1)))


@functools.cache
def _jax_pipeline(params, shape):
    n = int(np.prod(shape))
    mesh = j_make_mesh(*shape, devices=jax.devices()[:n]) if len(shape) == 3 else \
        j_make_mesh(data=shape[0], rows=shape[1], devices=jax.devices()[:n])
    return mesh, j_build(params, mesh)


def assert_planes_equal(got, want, names=PLANES, tag=""):
    for name in names:
        w = np.asarray(want[name])
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) else np.asarray(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, tag)
        assert np.array_equal(g, w), f"{name} {tag}"


@pytest.mark.parametrize("rule", ["exact", "reference"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("data,rows", [(1, 8), (2, 4)])
def test_sharded_classic_matches_jax_sharded_tier(data, rows, mode, rule):
    params = StereoParams(square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
                          edge_rule=rule)
    jmesh, jfn = _jax_pipeline(params, (data, rows))
    lefts, rights = _batch(data, rows * 12, 48, seed0=data)
    want = jax.device_get(jfn(lefts, rights))
    mesh = cpu_mesh(*interop.mesh_shape_from_jax(jmesh))
    got = build_sharded_pipeline(interop.params_from_jax(params), mesh)(lefts, rights)
    assert_planes_equal(got, want, tag=f"{mode} {rule} {data}x{rows}")


@pytest.mark.parametrize("mode", MODES)
def test_sharded_classic_2d_matches_jax_sharded_tier(mode):
    params = StereoParams(square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
                          edge_rule="exact")
    jmesh, jfn = _jax_pipeline(params, (1, 2, 4))
    lefts, rights = _batch(1, 24, 80, seed0=4)
    want = jax.device_get(jfn(lefts, rights))
    assert interop.mesh_shape_from_jax(jmesh) == (1, 2, 4)
    got = build_sharded_pipeline(interop.params_from_jax(params), cpu_mesh(1, 2, 4))(
        lefts, rights)
    assert_planes_equal(got, want, tag=str(mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("data,rows,cols", [
    (8, 1, None), (4, 2, None), (2, 2, 2), (1, 1, 8), (1, 2, 4),
])
def test_sharded_classic_matches_single_device(data, rows, cols, mode):
    """The rest of the JAX tests' mesh lists (tests/test_sharded.py:44,
    :123-126) against the port's own single-device pipeline."""
    from stereomatching_tpu_torch.config import StereoParams as PParams

    params = PParams(square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
                     edge_rule="exact")
    lefts, rights = _batch(data, max(rows * 12, 16), (cols or 2) * 20 + (8 if not cols else 0),
                           seed0=7)
    got = build_sharded_pipeline(params, cpu_mesh(data, rows, cols))(lefts, rights)
    want = classic_forward_batched(torch.from_numpy(lefts), torch.from_numpy(rights), params)
    assert_planes_equal(got, {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("mode", MODES)
def test_sharded_default_params_and_reference_rule_match_single_device(mode):
    """Reference defaults (sw 21, times 32, 30 shifts) on a 2x4 mesh
    (shard height 22 > halo 10), and the reference edge rule on 1x8."""
    from stereomatching_tpu_torch.config import StereoParams as PParams

    for params, (data, rows), (h, w) in (
        (PParams(mode=mode, edge_rule="exact"), (2, 4), (88, 64)),
        (PParams(square_width=9, times=6, lines=4, num_shifts=12, mode=mode), (1, 8), (64, 48)),
    ):
        lefts, rights = _batch(data, h, w, seed0=5)
        got = build_sharded_pipeline(params, cpu_mesh(data, rows))(lefts, rights)
        want = classic_forward_batched(torch.from_numpy(lefts), torch.from_numpy(rights),
                                       params)
        assert_planes_equal(got, {k: v.numpy() for k, v in want.items()})


def test_validation_errors():
    from stereomatching_tpu_torch.config import StereoParams as PParams

    lefts = np.zeros((1, 64, 32), np.float32)  # shard height 8 < halo 10
    with pytest.raises(ValueError, match="halo"):
        sharded_classic_forward(lefts, lefts, PParams(square_width=21, mode=BoundaryMode.GHOST),
                                cpu_mesh(1, 8))
    lefts = np.zeros((1, 16, 64), np.float32)  # 8 cols -> ws=8 < 16
    with pytest.raises(ValueError, match="x halo reach"):
        sharded_classic_forward(lefts, lefts, PParams(square_width=9, num_shifts=12),
                                cpu_mesh(1, 1, 8))
    with pytest.raises(ValueError, match="does not divide"):
        sharded_classic_forward(lefts[:, :15], lefts[:, :15], PParams(square_width=3),
                                cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=2, rows=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="contiguous run"):
        make_mesh(data=1, rows=3, devices=["cpu", torch.device("cpu", 0), "cpu"])


def test_mesh_default_devices_refuse_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(data=1, rows=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(data=1, rows=2, devices=["cuda:0"] * 2)
    with pytest.raises(TypeError):
        interop.mesh_shape_from_jax(object())


# ------------------------------------------------------------------ K9


@pytest.mark.parametrize("mode,pre_extended", [
    (BoundaryMode.WRAP, False), (BoundaryMode.GHOST, False), (BoundaryMode.GHOST, True),
])
def test_prehalo_plain_matches_jax_kernel_interpret(mode, pre_extended):
    """K9's plain version against ``match_and_score_pallas_prehalo`` in
    interpret mode on one tiny shape per mode: a top shard of a 2-shard
    image, halo 3 > half 2.  The JAX entry takes the ghost mask as the
    sentinel 2 in the left map; the port takes the shard's global rows."""
    jparams = StereoParams(square_width=5, num_shifts=4, mode=mode)
    params = interop.params_from_jax(jparams)
    rng = np.random.default_rng(21)
    b, hs, w, halo = 2, 8, 16, 3
    rows = hs + 2 * halo
    l_blk = (rng.random((b, rows, w)) < 0.4).astype(np.int32)
    r_blk = (rng.random((b, rows, w + 4)) < 0.4).astype(np.int32)
    row0 = np.array([-halo, hs - halo], np.int32)  # the top and the bottom shard
    col0 = np.array([-2, 6], np.int32) if pre_extended else np.zeros(b, np.int32)
    w_global = w + 4 if pre_extended else w
    l_in = l_blk
    if mode == BoundaryMode.GHOST:
        gy = row0[:, None] + np.arange(rows)
        gx = col0[:, None] + np.arange(w)
        ok = ((gy >= 0) & (gy < 2 * hs))[:, :, None] & ((gx >= 0) & (gx < w_global))[:, None, :]
        l_in = np.where(ok, l_blk, 2)
    want = match_and_score_pallas_prehalo(jnp.asarray(l_in), jnp.asarray(r_blk), jparams, halo,
                                          interpret=True, pre_extended=pre_extended)
    got = fused.match_and_score_prehalo(
        torch.from_numpy(l_blk), torch.from_numpy(r_blk), params, halo, torch.from_numpy(row0),
        2 * hs, torch.from_numpy(col0) if pre_extended else None,
        w_global if pre_extended else None, pre_extended=pre_extended)
    assert fused.match_and_score_prehalo.launches == 0  # CPU tensors: no kernel
    for g, wv in zip(got, want):
        cols = slice(2, w - 2) if pre_extended else slice(None)  # the kept core
        assert np.array_equal(g.numpy()[..., cols], np.asarray(wv)[..., cols])
    with pytest.raises(ValueError, match="halo"):
        fused.match_and_score_prehalo(torch.from_numpy(l_blk), torch.from_numpy(r_blk), params,
                                      1, torch.from_numpy(row0), 2 * hs)


# ------------------------------------------------------------- halos


def _shards(data, rows, cols=None, bl=1, hs=4, ws=5):
    mesh = cpu_mesh(data, rows, cols)
    box, grid, local, _ = mesh.blocks
    return Shards(mesh, distributed.LocalComm(), (0, 0, 0), local[0][0], bl, hs, ws)


@pytest.mark.parametrize("circular", [True, False])
def test_row_halo_exchange(circular):
    sh = _shards(1, 4, hs=4, ws=3)
    x = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 1, 1, 4, 3)
    top, bottom = exchange_row_halo(x, 2, sh, circular, fill=128.0)
    for r in range(4):
        up, down = (r - 1) % 4, (r + 1) % 4
        want_top = x[up, 0, 0, 2:] if (circular or r > 0) else torch.full((2, 3), 128.0)
        want_bot = x[down, 0, 0, :2] if (circular or r < 3) else torch.full((2, 3), 128.0)
        assert torch.equal(top[r, 0, 0], want_top) and torch.equal(bottom[r, 0, 0], want_bot)
    ext = with_row_halo(x, 1, sh, circular)
    assert ext.shape == (4, 1, 1, 6, 3)
    if not circular:  # zeros where no shard sends, as ppermute
        assert ext[0, 0, 0, 0].eq(0).all() and ext[3, 0, 0, -1].eq(0).all()
    with pytest.raises(ValueError, match="exceeds shard extent"):
        exchange_row_halo(x, 5, sh, circular)


def test_col_halo_exchange_asymmetric_right_halo():
    sh = _shards(1, 1, cols=4, hs=2, ws=5)
    x = torch.arange(4 * 2 * 5).reshape(1, 4, 1, 2, 5)
    ext = with_col_halo(x, 1, sh, circular=True, right_halo=3)
    assert ext.shape == (1, 4, 1, 2, 9)
    glob = torch.cat([x[0, c, 0] for c in range(4)], dim=-1)  # [2, 20]
    for c in range(4):
        cols = torch.arange(c * 5 - 1, c * 5 + 8) % 20
        assert torch.equal(ext[0, c, 0], glob[:, cols])
    left, right = exchange_col_halo(x, 2, sh, circular=False, fill=7)
    assert left[0, 0].eq(7).all() and right[0, 3].eq(7).all()
    assert torch.equal(left[0, 1, 0], x[0, 0, 0, :, 3:])
    with pytest.raises(ValueError, match="exceeds shard extent"):
        with_col_halo(x, 6, sh, circular=True)


# ----------------------------------------------------- matcher and CLI


def test_matcher_with_cpu_mesh_pads_the_batch():
    from stereomatching_tpu_torch.config import StereoParams as PParams

    params = PParams(square_width=9, times=6, lines=4, num_shifts=12, edge_rule="exact",
                     mode=BoundaryMode.GHOST)
    pairs = [synthetic_pair(48, 48, seed=s) for s in range(3)]
    lu8, ru8 = np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])
    single = Matcher(params, device="cpu")
    sharded = Matcher(params, mesh=cpu_mesh(2, 4))
    sharded.warmup((48, 48))
    got, want = sharded(lu8, ru8), single(lu8, ru8)  # 3 pairs on a data axis of 2
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    one = sharded(lu8[0], ru8[0])
    assert one["web-2"].shape == (48, 48) and np.array_equal(one["web-2"], want["web-2"][0])
    with pytest.raises(ValueError, match="rows axis"):
        sharded(lu8[:, :46], ru8[:, :46])


@pytest.fixture
def pair_paths(tmp_path):
    left, right = synthetic_pair(h=40, w=56, seed=2)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    j_imageio.write_png_gray(a, left)
    j_imageio.write_png_gray(b, right)
    return a, b


def _dumps(outdir):
    return {f: open(os.path.join(outdir, f), "rb").read()
            for f in sorted(os.listdir(outdir)) if f.endswith(".ppm")}


@pytest.mark.parametrize("argv", [
    ["0.2", "9", "6", "4", "--mode", "ghost", "--edge-rule", "exact", "--shifts", "12"],
    ["--pipeline", "modern", "--aggregation", "sgm", "--cost", "census", "--shifts", "8",
     "--sgm-directions", "8"],
], ids=["classic-ghost", "modern-sgm8"])
def test_cli_sharded_matches_jax_cli(pair_paths, tmp_path, monkeypatch, argv):
    """``--tier sharded`` over a CPU mesh of 8 devices (the JAX CLI's row
    choice: 8 row shards of 5 rows for the classic run, sw 9 needs >= 4)
    against the JAX CLI's ``--tier sharded``: byte-identical PPMs, equal
    ``disparity.npz``."""
    a, b = pair_paths
    monkeypatch.setattr(cli, "sharded_devices", lambda: [torch.device("cpu")] * 8)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main([a, b, *argv, "--tier", "sharded", "--outdir", port_dir]) == 0
    assert j_cli.main([a, b, *argv, "--tier", "sharded", "--outdir", jax_dir]) == 0
    assert _dumps(port_dir) == _dumps(jax_dir) and _dumps(port_dir)
    if "modern" in argv:
        with np.load(os.path.join(port_dir, "disparity.npz")) as p, \
                np.load(os.path.join(jax_dir, "disparity.npz")) as j:
            assert sorted(p.files) == sorted(j.files)
            for k in j.files:
                assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k


def test_cli_sharded_refuses_without_gpu(pair_paths, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    a, b = pair_paths
    assert cli.main([a, b, "--tier", "sharded", "--outdir", str(tmp_path)]) == 1
    assert "--tier sharded" in capsys.readouterr().err
    assert cli.main([a, b, "--tier", "sharded", "--collect", "--outdir", str(tmp_path)]) == 1
    assert "--collect" in capsys.readouterr().err
    assert not os.listdir(tmp_path) or not any(f.endswith(".ppm") for f in os.listdir(tmp_path))


def test_two_device_blocks_in_one_process_match_single_device():
    """Two blocks in one process (two distinct device objects, ``cpu``
    and ``cpu:0``): each block's body runs in its own thread and the
    halos cross between the blocks through the thread communicator;
    an error in one block reaches the caller."""
    from stereomatching_tpu_torch.config import StereoParams as PParams

    devices = ["cpu", "cpu", torch.device("cpu", 0), torch.device("cpu", 0)]
    lefts, rights = _batch(2, 48, 64, seed0=3)
    for mode in MODES:
        params = PParams(square_width=9, times=6, lines=4, num_shifts=12, mode=mode)
        want = classic_forward_batched(torch.from_numpy(lefts), torch.from_numpy(rights), params)
        for shape in ((1, 4, None), (1, 2, 2), (2, 2, None)):
            mesh = make_mesh(*shape, devices=devices)
            assert len(mesh.blocks[2]) == 2 and mesh.blocks[3] is None
            got = build_sharded_pipeline(params, mesh)(lefts[:shape[0]], rights[:shape[0]])
            assert_planes_equal(got, {k: v[:shape[0]].numpy() for k, v in want.items()})
    # The SGM chain's carries cross between the two blocks too.
    from stereomatching_tpu_torch.config import ModernParams
    from stereomatching_tpu_torch.models.modern import modern_forward
    from stereomatching_tpu_torch.parallel import build_sharded_modern_pipeline

    mparams = ModernParams(num_disparities=8, aggregation="sgm", cost="census",
                           sgm_directions=8, median_filter=True)
    lp, rp = (torch.from_numpy((x * 256).astype(np.int32)) for x in (lefts, rights))
    got = build_sharded_modern_pipeline(mparams, make_mesh(1, 4, devices=devices))(lp, rp)
    want = modern_forward(lp, rp, mparams)
    for k, v in want.items():
        assert torch.equal(got[k].to_global(), v), k
    with pytest.raises(ValueError, match="exceeds shard extent"):
        build_sharded_pipeline(PParams(square_width=31), make_mesh(1, 4, devices=devices))(
            lefts[:1], rights[:1])
