"""The census of both views (``ops/fused_census.py``, K10's wrapper) on
the CPU: its plain route held bitwise against ``ops.costvolume.
census_transform`` and the JAX package's ``census_transform`` on every
input width it takes, its refusals, and its place in the modern route
(``models/modern.py``: a kernel stage of both routes for every config,
the plain census in ``_PLAIN``).  The kernel itself runs only on a CUDA
card and is held against the plain version in ``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.ops import costvolume as j_cv
from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.models import build_modern_pipeline, modern
from stereomatching_tpu_torch.ops import costvolume, fused_census
from stereomatching_tpu_torch.utils import tracing

# [H, W] and [B, H, W] shapes: one pixel, planes under the window, odd sizes.
SHAPES = [(1, 1), (2, 3), (5, 1), (1, 7), (3, 1, 1), (2, 3, 2), (2, 9, 13), (1, 17, 29),
          (3, 6, 5)]
# dtype -> the range drawn: 8-bit pixels, int32 with negatives and values
# past 255 (the coarse level's sums reach 1020), the extremes of int32,
# and the widths the plain version widens first.
DTYPES = {"uint8": (np.uint8, 0, 256), "int32": (np.int32, -300, 1021),
          "int32-full": (np.int32, -2**31, 2**31), "int16": (np.int16, -2**15, 2**15),
          "int64": (np.int64, -2**31, 2**31)}


@functools.cache
def _jax_census(window):
    return jax.jit(lambda x: j_cv.census_transform(x, window))


def _planes(shape, dtype, seed):
    """Two planes of ``shape`` drawn from ``DTYPES[dtype]``; every other
    pixel of the second is a copy of its left neighbour, so ties occur."""
    np_dtype, lo, hi = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi, shape, dtype=np.int64).astype(np_dtype)
    b = rng.integers(lo, hi, shape, dtype=np.int64).astype(np_dtype)
    b[..., 1::2] = b[..., :-1:2][..., :b[..., 1::2].shape[-1]]
    return a, b


def _jax_codes(x: np.ndarray, window: int) -> np.ndarray:
    planes = x.reshape(-1, *x.shape[-2:]).astype(np.int32)
    return np.stack([np.asarray(_jax_census(window)(jnp.asarray(p)))
                     for p in planes]).reshape(x.shape)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [3, 5])
def test_plain_route_equals_costvolume_and_jax(window, dtype, shape):
    a, b = _planes(shape, dtype, seed=len(shape) * 100 + shape[-1])
    before = fused_census.census.launches
    got = fused_census.census(torch.from_numpy(a), torch.from_numpy(b), window)
    assert fused_census.census.launches == before
    for g, x in zip(got, (a, b)):
        want = costvolume.census_transform(torch.from_numpy(x), window)
        assert g.dtype == torch.int32 and g.shape == x.shape and g.is_contiguous()
        assert torch.equal(g, want)
        assert np.array_equal(g.numpy(), _jax_codes(x, window))


def test_codes_by_hand():
    """A 3 x 3 plane at window 3: the centre's bits in row-major order,
    bit 0 the top-left neighbour; a corner's replicated neighbours equal
    it and set no bit."""
    x = torch.tensor([[1, 9, 2], [9, 5, 9], [3, 9, 4]], dtype=torch.uint8)
    cl, cr = fused_census.census(x, x.to(torch.int32), 3)
    # Neighbours of the centre: 1 9 2 / 9 _ 9 / 3 9 4 -> below 5 at bits
    # 0 (1), 2 (2), 5 (3), 7 (4).
    assert cl[1, 1] == 0b10100101
    assert cl[0, 0] == 0 and torch.equal(cl, cr)


@pytest.mark.parametrize("window", [1, 2, 4, 7])
def test_other_windows_are_refused(window):
    x = torch.zeros((2, 5, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="census window must be 3 or 5"):
        fused_census.census(x, x, window)
    if window == 7:
        with pytest.raises(ValueError, match="census window must be 3 or 5"):
            fused_census.census_reference(x, x, window)
        with pytest.raises(ValueError):
            ModernParams(aggregation="sgm", cost="census", census_window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_float_planes_are_refused(dtype):
    x, f = torch.zeros((1, 4, 4), dtype=torch.uint8), torch.zeros((1, 4, 4), dtype=dtype)
    for pair in ((f, f), (x, f), (f, x)):
        with pytest.raises(ValueError, match="integer planes"):
            fused_census.census(*pair)
    pipe = build_modern_pipeline(ModernParams(aggregation="sgm", cost="census",
                                              num_disparities=4))
    with pytest.raises(ValueError, match="integer pixel planes"):
        pipe(f, f)


@pytest.mark.parametrize("shapes", [((2, 4, 4), (2, 4, 5)), ((4,), (4,)), ((3, 4), (4, 3))])
def test_unequal_or_flat_shapes_are_refused(shapes):
    a, b = (torch.zeros(s, dtype=torch.uint8) for s in shapes)
    with pytest.raises(ValueError, match="equal"):
        fused_census.census(a, b)


@pytest.mark.parametrize("shape", [(0, 5, 7), (2, 0, 7), (2, 5, 0), (0, 0)])
def test_empty_planes_give_empty_codes(shape):
    x = torch.zeros(shape, dtype=torch.uint8)
    before = fused_census.census.launches
    cl, cr = fused_census.census(x, x)
    assert cl.shape == cr.shape == shape and cl.dtype == cr.dtype == torch.int32
    assert fused_census.census.launches == before


def test_mixed_widths_take_the_plain_codes():
    a, b = _planes((2, 7, 9), "uint8", seed=4)
    got = fused_census.census(torch.from_numpy(a), torch.from_numpy(b.astype(np.int16)))
    for g, x in zip(got, (a, b)):
        assert torch.equal(g, costvolume.census_transform(torch.from_numpy(x)))


# Configs across both routes, both costs, both windows, scales 1 and 2, and
# the limits of K7 and K4.
CONFIGS = [dict(), dict(aggregation="sgm", cost="census"),
           dict(aggregation="sgm", cost="sad", num_disparities=300),
           dict(cost="census", census_window=3, window=301, scales=2),
           dict(aggregation="sgm", cost="census", census_window=3, num_disparities=257,
                sgm_directions=8)]


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_census_is_a_kernel_stage_for_every_config(kw):
    params = ModernParams(**kw)
    assert modern.modern_kernels_supported(params)["census"] == (True, "")
    assert "census" in modern._ROUTE_STAGES[params.aggregation]
    assert "census" not in modern.plain_stages(params)
    assert modern._route(params).census is fused_census.census


def test_plain_route_keeps_the_plain_census():
    assert modern._PLAIN.census is fused_census.census_reference
    assert modern._KERNELS.census is fused_census.census
    x = torch.from_numpy(_planes((2, 9, 13), "int32", seed=5)[0])
    for window in (3, 5):
        got = modern._PLAIN.census(x, x + 1, window)
        assert torch.equal(got[0], costvolume.census_transform(x, window))
        assert torch.equal(got[1], costvolume.census_transform(x + 1, window))


@pytest.mark.parametrize("kw", [dict(aggregation="sgm", cost="census", num_disparities=8),
                                dict(cost="census", num_disparities=8, window=5),
                                dict(aggregation="sgm", cost="census", num_disparities=8,
                                     census_window=3, scales=2)], ids=str)
def test_forward_takes_uint8_as_int32(kw):
    """The forward on uint8 planes equals the forward on the same pixels
    as int32 and the plain route, plane by plane; the CPU counts no
    K10 launch."""
    params = ModernParams(**kw)
    a, b = _planes((2, 12, 21), "uint8", seed=6)
    u8 = [torch.from_numpy(x) for x in (a, b)]
    i32 = [x.to(torch.int32) for x in u8]
    tracing.enable()
    got = modern.modern_forward(*u8, params)
    tracing.disable()
    (req,) = tracing.records()["requests"]
    assert "launches.K10" not in req["counters"]
    for want in (modern.modern_forward(*i32, params),
                 modern.modern_forward_reference(*u8, params)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    tracing.clear()


@pytest.mark.parametrize("window", [5, 3])
def test_k10_bound_is_the_work_models_census(window):
    """``utils/bench.k10_bound_ms`` at the SGM cells' size charges what
    the benchmark's work model charges the census stage: 72 int32 ops a
    pixel and view at window 5 (0.0133 ms a pair), so the card's K10 time
    reads against the same least time."""
    from stereobench import workmodel
    from stereomatching_tpu_torch.utils import bench

    npix = 1110 * 1390
    ms, by = bench.k10_bound_ms(npix, window)
    nbytes, ops, rate = bench.k10_work(npix, window)
    assert ops == 2 * bench.K10_NEIGHBOUR_OPS * (window * window - 1) * npix
    assert nbytes == 2 * 8 * npix
    if window == 5:
        params = {"cost": "census", "census_window": 5, "num_disparities": 256, "sgm_p2": 96,
                  "sgm_directions": 4}
        assert ms / 1e3 == pytest.approx(workmodel.least_s(
            workmodel.sgm_stages(params, 1110, 1390)["census"]), rel=1e-12)
        assert by == "operations" and round(ms, 4) == 0.0133
