"""The port's sharded modern tier on CPU meshes of repeated ``"cpu"``
devices, held bitwise (tolerance 0 on every plane, the float sub-pixel,
filled and uniqueness planes included) against the JAX package's XLA
sharded tier on its 8-device CPU mesh for the listed configurations, and
against the port's own single-device pipeline for the rest of the JAX
tests' mesh lists (``tests/test_sharded_modern.py:53``, ``:88``,
``:164``, ``:208``).  Also: the plain seeded SGM chain (``sgm.path`` with
``seed`` / ``with_carry``) against the JAX package's per-shard pass and
against one unsharded pass, the validation errors, and
``ModernMatcher`` with a mesh.

Inputs: ``tests/util.synthetic_pair`` pairs at 48x64 (32x48 for D=32),
D = 8, windows 1-5, or seeded random pixels for the 2-D box meshes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import ModernParams
from stereomatching_tpu.parallel import build_sharded_modern_pipeline as j_build
from stereomatching_tpu.parallel import make_mesh as j_make_mesh
from stereomatching_tpu.parallel.modern import _sgm_local_pass
from stereomatching_tpu_torch import interop
from stereomatching_tpu_torch.config import ModernParams as PParams
from stereomatching_tpu_torch.models.modern import modern_forward
from stereomatching_tpu_torch.ops import sgm
from stereomatching_tpu_torch.parallel import (
    build_sharded_modern_pipeline, make_mesh, sharded_modern_forward)
from stereomatching_tpu_torch.serving import ModernMatcher
from tests.util import synthetic_pair

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh (conftest)")

KEYS = ("disparity", "subpixel", "disparity_right", "valid", "filled", "cost")


def cpu_mesh(data, rows, cols=None):
    return make_mesh(data=data, rows=rows, cols=cols,
                     devices=["cpu"] * (data * rows * (cols or 1)))


def pixels(data, h=48, w=64, seed=0):
    pairs = [synthetic_pair(h=h, w=w, seed=seed + i) for i in range(data)]
    return (np.stack([a for a, _ in pairs]).astype(np.int32),
            np.stack([b for _, b in pairs]).astype(np.int32))


def random_pixels(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, shape).astype(np.int32) for _ in range(2))


@functools.cache
def _jax_pipeline(params, shape):
    n = int(np.prod(shape))
    kw = dict(data=shape[0], rows=shape[1], devices=jax.devices()[:n])
    if len(shape) == 3:
        kw["cols"] = shape[2]
    mesh = j_make_mesh(**kw)
    return mesh, j_build(params, mesh)


def assert_same(got, want, keys=KEYS):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in keys:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert np.array_equal(g, w), k


def run_vs_jax(jparams, shape, lb, rb):
    jmesh, jfn = _jax_pipeline(jparams, shape)
    want = jax.device_get(jfn(lb, rb))
    got = build_sharded_modern_pipeline(
        interop.params_from_jax(jparams), cpu_mesh(*interop.mesh_shape_from_jax(jmesh)))(lb, rb)
    assert_same(got, want, tuple(want))


def run_vs_single(params, shape, lb, rb):
    got = build_sharded_modern_pipeline(params, cpu_mesh(*shape))(lb, rb)
    want = modern_forward(torch.from_numpy(lb), torch.from_numpy(rb), params)
    assert_same(got, {k: v.numpy() for k, v in want.items()}, tuple(want))


# ------------------------------------------------- against the JAX tier


@pytest.mark.parametrize("jparams,shape,seed", [
    (ModernParams(num_disparities=8, window=5), (2, 4), 0),
    (ModernParams(num_disparities=8, aggregation="sgm", cost="census", census_window=5),
     (1, 4), 13),
    (ModernParams(num_disparities=8, aggregation="sgm", cost="census", sgm_directions=8,
                  median_filter=True, uniqueness=True), (1, 4), 19),
], ids=["sad-box-2x4", "census-sgm4-rows4", "census-sgm8-rows4"])
def test_sharded_modern_matches_jax_sharded_tier(jparams, shape, seed):
    run_vs_jax(jparams, shape, *pixels(shape[0], seed=seed))


def test_sharded_modern_2d_box_matches_jax_sharded_tier():
    jparams = ModernParams(num_disparities=8, window=5, cost="census", median_filter=True)
    run_vs_jax(jparams, (1, 2, 4), *random_pixels((1, 24, 96), 37))


# -------------------------------------- against the port's single device


@pytest.mark.parametrize("kw,shape", [
    (dict(window=5), (1, 8)), (dict(window=5), (4, 2)), (dict(window=5), (8, 1)),
    (dict(window=5, cost="census", census_window=5), (1, 2)),
    (dict(window=5, cost="census", census_window=5), (1, 8)),
    (dict(window=5, median_filter=True), (2, 4)),
    (dict(window=1), (1, 8)),
    (dict(aggregation="sgm"), (1, 8)), (dict(aggregation="sgm"), (2, 4)),
    (dict(aggregation="sgm"), (8, 1)),
    (dict(aggregation="sgm", uniqueness=True), (1, 4)),
    (dict(aggregation="sgm", fill_mode="background"), (1, 4)),
    (dict(aggregation="sgm", median_filter=True), (2, 4)),
    (dict(aggregation="sgm", cost="census", sgm_directions=8), (1, 8)),
    (dict(aggregation="sgm", cost="census", sgm_directions=4), (1, 8)),
])
def test_sharded_modern_matches_single_device(kw, shape):
    run_vs_single(PParams(num_disparities=8, **kw), shape, *pixels(shape[0], seed=11))


@pytest.mark.parametrize("dirs", [4, 8])
def test_sharded_modern_sgm_int8_storage_matches_single_device(dirs):
    from stereomatching_tpu_torch.models.modern import _sgm_storage_dtype

    params = PParams(num_disparities=32, aggregation="sgm", cost="census", sgm_directions=dirs)
    assert _sgm_storage_dtype(params) == torch.int8
    run_vs_single(params, (1, 4), *pixels(1, h=32, w=48, seed=29))


@pytest.mark.parametrize("cost", ["sad", "census"])
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 4), (1, 2, 4)])
def test_sharded_modern_2d_matches_single_device(cost, shape):
    params = PParams(num_disparities=8, window=5, cost=cost, median_filter=True)
    data, rows, cols = shape
    run_vs_single(params, shape, *random_pixels((data, rows * 12, cols * 24), 37))


def test_sharded_modern_cols_one_mesh_takes_the_rows_route():
    """A (data, rows, cols=1) mesh runs the rows-only routes (SGM too)."""
    lb, rb = pixels(1, seed=3)
    for params in (PParams(num_disparities=8, window=5), PParams(num_disparities=8,
                                                                 aggregation="sgm")):
        run_vs_single(params, (1, 4, 1), lb, rb)


# ------------------------------------------------ the seeded SGM chain


def _chain(vol, direction, reverse, bounds, pass_fn):
    """Run ``pass_fn(part, seed) -> (L, carry)`` over the row shards of
    ``bounds`` in the walk's order -> the stitched L."""
    order = range(len(bounds) - 1)
    order = reversed(order) if reverse else order
    seed, outs = None, {}
    for j in order:
        outs[j], seed = pass_fn(vol[:, bounds[j]:bounds[j + 1]], seed)
    return np.concatenate([outs[j] for j in range(len(bounds) - 1)], axis=1)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("direction,reverse", [
    (sgm.Y, False), (sgm.Y, True), (sgm.DIAG_PLUS, False), (sgm.DIAG_PLUS, True),
    (sgm.DIAG_MINUS, False), (sgm.DIAG_MINUS, True),
])
def test_seeded_chain_matches_jax_local_pass_and_unsharded(direction, reverse, dtype):
    """The plain seeded chain against the JAX package's ``_sgm_local_pass``
    (the sharded tier's per-shard pass) and against one unsharded
    ``sgm.path``; shards of 5, 1 and 6 rows."""
    rng = np.random.default_rng(41)
    vol = rng.integers(0, 40, (2, 12, 9, 8)).astype(dtype)
    bounds = [0, 5, 6, 12]
    # The JAX pairs: top-down dx=+1 with bottom-up dx=-1, and dx=-1 with +1.
    dx = {sgm.Y: 0, sgm.DIAG_PLUS: 1, sgm.DIAG_MINUS: -1}[direction]
    dx = -dx if reverse else dx

    def port_pass(part, seed):
        L, carry = sgm.path(torch.from_numpy(part), 8, 96, direction, reverse,
                            None if seed is None else torch.from_numpy(seed), True)
        return L.numpy(), carry.numpy()

    def jax_pass(part, seed):
        rows = jnp.moveaxis(jnp.asarray(part.astype(np.int32)), 1, 0)  # [h, B, W, D]
        if reverse:
            rows = rows[::-1]
        seeded = seed is not None
        out, carry = _sgm_local_pass(rows, jnp.asarray(seed) if seeded else rows[0],
                                     seeded, 8, 96, dx=dx)
        out = np.asarray(out)[::-1] if reverse else np.asarray(out)
        return np.moveaxis(out, 0, 1), np.asarray(carry)

    got = _chain(vol, direction, reverse, bounds, port_pass)
    want = _chain(vol, direction, reverse, bounds, jax_pass)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, sgm.path(torch.from_numpy(vol), 8, 96, direction, reverse).numpy())


# ------------------------------------------------- validation, matcher


def test_sharded_modern_validation():
    lb = np.zeros((1, 48, 64), np.int32)
    mesh = cpu_mesh(1, 8)
    with pytest.raises(ValueError, match="scales=1"):
        sharded_modern_forward(lb, lb, PParams(num_disparities=8, scales=2), mesh)
    with pytest.raises(ValueError, match="scales=1"):
        build_sharded_modern_pipeline(PParams(num_disparities=8, aggregation="sgm", scales=2),
                                      cpu_mesh(1, 2))(lb[:, :32], lb[:, :32])
    with pytest.raises(ValueError, match="row shards"):
        sharded_modern_forward(lb[:, :44], lb[:, :44], PParams(num_disparities=8), mesh)
    with pytest.raises(ValueError, match="row shards"):  # census reach 2 > 1-row shards
        sharded_modern_forward(lb[:, :8], lb[:, :8], PParams(
            num_disparities=8, aggregation="sgm", cost="census"), mesh)
    lb = np.zeros((1, 16, 64), np.int32)
    with pytest.raises(ValueError, match="x halo reach"):
        sharded_modern_forward(lb, lb, PParams(num_disparities=8), cpu_mesh(1, 1, 8))
    with pytest.raises(ValueError, match="rows-only"):
        sharded_modern_forward(lb, lb, PParams(num_disparities=8, aggregation="sgm"),
                               cpu_mesh(1, 2, 4))
    with pytest.raises(ValueError, match="background"):
        sharded_modern_forward(lb, lb, PParams(num_disparities=8, fill_mode="background"),
                               cpu_mesh(1, 2, 4))
    with pytest.raises(ValueError, match="integer"):
        sharded_modern_forward(lb.astype(np.float32), lb.astype(np.float32),
                               PParams(num_disparities=8), cpu_mesh(1, 2))


def test_modern_matcher_with_cpu_mesh_pads_the_batch():
    params = PParams(num_disparities=8, aggregation="sgm", cost="census", uniqueness=True)
    lb, rb = pixels(3, seed=5)
    lu8, ru8 = lb.astype(np.uint8), rb.astype(np.uint8)
    sharded = ModernMatcher(params, mesh=cpu_mesh(2, 4))
    sharded.warmup((48, 64), batch=2)
    got = sharded(lu8, ru8)
    want = ModernMatcher(params, device="cpu")(lu8, ru8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (3, 48, 64) and np.array_equal(got[k], want[k]), k
    one = sharded(lu8[1], ru8[1])
    assert np.array_equal(one["filled"], want["filled"][1])
