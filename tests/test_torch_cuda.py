"""The port's CUDA kernels held bitwise against their plain torch
versions on the card (tolerance 0 on every plane: the integer ones, and
the float sub-pixel and filled planes, whose kernels round as the plain
versions do).

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU.  The file imports no jax (the GPU host need not
have it); run it there without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.ops import (
    costvolume, fused, fused_census, fused_diffusion, fused_modern, fused_sgm, sgm)
# By the module's own name (pytest puts tests/ on the path): on a GPU host
# an installed package named ``tests`` can shadow this directory.
from test_torch_fill import special_disparities

MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# (shape, D, square_width) for K1: K8's coverage (D 1 to 256, D > W;
# windows 1, 21 and 255, the last past the two-word row-sum path) on
# widths that are not a multiple of K1's 128-column tile (1, 31, 33, 129,
# 200) and heights below and above one tile (128 rows; 64 with the
# sub-pixel plane), batch 3.
K1_CASES = [
    ((3, 48, 64), 16, 21), ((2, 37, 45), 80, 5), ((1, 96, 128), 64, 21), ((2, 33, 70), 12, 3),
    ((3, 20, 1), 1, 1), ((3, 70, 31), 30, 21), ((3, 65, 33), 256, 1), ((3, 130, 129), 64, 21),
    ((3, 40, 200), 256, 21), ((3, 37, 45), 30, 255), ((3, 66, 129), 64, 255),
    ((3, 37, 45), 256, 255), ((3, 33, 33), 1, 31), ((3, 29, 200), 40, 33),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape_shifts_sw", K1_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_match_score_edges_kernel_matches_plain(cuda_device, mode, shape_shifts_sw):
    shape, d, sw = shape_shifts_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
    rng = np.random.default_rng(11)
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32) / 256.0)
                   .to(cuda_device) for _ in range(2))
    before = fused.match_score_edges.launches
    got = fused.match_score_edges(left, right, params)
    torch.cuda.synchronize()
    assert fused.match_score_edges.launches == before + 1
    ref = fused.match_score_edges_reference(left, right, params)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# K2 on odd shapes: one cell, one row, one column, 3 x 61 x 97, and tiles
# cut by the image's edge (W not a multiple of the tiles' 128 or 64), and
# 300 x 260, whose middle tiles reach no cell outside the image.
K2_SHAPES = [(1, 1, 1), (2, 1, 300), (2, 300, 1), (3, 61, 97), (2, 130, 200), (1, 300, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("value_bound", [65, 256, 65536, None])
@pytest.mark.parametrize("times", [0, 1, 2, 3, 32, 100])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_fill_web_holes_range_kernel_matches_plain(cuda_device, shape, times, value_bound):
    """K2 at every storage width, one launch and chained (times 100; 32
    at int32), on webs within the bound with 40% holes; the input is
    never written; ``k2_plan``'s launches."""
    rng = np.random.default_rng(12)
    web = rng.integers(1, 65 if value_bound is None else value_bound, shape).astype(np.int32)
    web[rng.random(web.shape) < 0.4] = 0
    web_t = torch.from_numpy(web).to(cuda_device)
    before = fused_diffusion.fill_web_holes_range.launches
    got = fused_diffusion.fill_web_holes_range(web_t, times, value_bound)
    torch.cuda.synchronize()
    assert (fused_diffusion.fill_web_holes_range.launches
            == before + fused_diffusion.k2_plan(times, value_bound).launches)
    assert torch.equal(web_t.cpu(), torch.from_numpy(web))  # input untouched
    for a, b in zip(got, fused_diffusion.fill_web_holes_range_reference(web_t, times)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("times", [2, 17, 32, 100])
def test_fill_web_holes_range_resumed_web_any_values(cuda_device, times):
    """A web with no proven bound (negative, large, int32-extreme values,
    as a resumed file may hold) runs on int32 storage and equals the
    plain version, whose sums wrap as int32."""
    rng = np.random.default_rng(13)
    web = rng.integers(-(2**31), 2**31 - 1, (2, 70, 150), dtype=np.int64).astype(np.int32)
    web[rng.random(web.shape) < 0.5] = 0
    web[0, 0, :4] = [2**31 - 1, -(2**31), 2**31 - 1, 0]
    web_t = torch.from_numpy(web).to(cuda_device)
    assert fused_diffusion.k2_plan(times, None).storage_bytes == 4
    got = fused_diffusion.fill_web_holes_range(web_t, times, None)
    for a, b in zip(got, fused_diffusion.fill_web_holes_range_reference(web_t, times)):
        assert torch.equal(a, b)
    assert torch.equal(web_t.cpu(), torch.from_numpy(web))


@pytest.mark.cuda
def test_k2_mirrors_match_the_library(cuda_device):
    """``K2_MAX_STEPS`` and ``k2_smem_bytes``, by which ``k2_plan``
    counts launches, give the library's own figures."""
    lib = fused_diffusion._lib("fill_web_holes")
    for nbytes, steps in fused_diffusion.K2_MAX_STEPS.items():
        assert lib.fill_web_holes_max_steps(nbytes) == steps
        for h in range(steps + 1):
            assert lib.fill_web_holes_smem_bytes(nbytes, h) == fused_diffusion.k2_smem_bytes(
                nbytes, h)
        assert fused_diffusion.k2_smem_bytes(nbytes, steps) <= 232448


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(cuda_device):
    params = StereoParams(num_shifts=8, square_width=7, edge_rule="exact")
    x = torch.zeros((2, 16, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fused.match_score_edges(x.double(), x.double(), params)
    with pytest.raises(ValueError):
        fused.match_score_edges(x, x[:1], params)
    with pytest.raises(ValueError):
        fused.match_score_edges(x.transpose(1, 2), x.transpose(1, 2), params)
    with pytest.raises(ValueError):
        fused_diffusion.fill_web_holes_range(x, 4)  # float32, not int32


SGM_SHAPES = [(2, 37, 45), (1, 64, 96), (3, 19, 130)]
DISPARITIES = [8, 11, 64]


def rand_codes(device, shape, cost, seed):
    rng = np.random.default_rng(seed)
    hi = 1 << 24 if cost == "census" else 256
    return [torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32)).to(device)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", DISPARITIES)
@pytest.mark.parametrize("cost_dtype", [("census", torch.int8), ("sad", torch.int16),
                                        ("census", torch.int32)])
@pytest.mark.parametrize("shape", SGM_SHAPES)
def test_sgm_volume_kernel_matches_plain(cuda_device, shape, cost_dtype, d):
    cost, dtype = cost_dtype
    ref, other = rand_codes(cuda_device, shape, cost, 21)
    before = fused_sgm.sgm_volume.launches
    got = fused_sgm.sgm_volume(ref, other, d, cost, dtype)
    torch.cuda.synchronize()
    assert fused_sgm.sgm_volume.launches == before + 1
    assert got.dtype == dtype and got.shape == (*shape, d)
    assert torch.equal(got, fused_sgm.sgm_volume_reference(ref, other, d, cost, dtype))


# K3 on each route: D around a 16-byte vector (1, 15, 16, 17), D 37 and
# 100 (vectors spanning pixels where the row fills whole vectors), 64 and
# 256 (pixels); widths 1024 (rows of whole vectors), 45 and 1021 (not);
# census codes over all 32 bits.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 15, 16, 17, 37, 64, 100, 256])
@pytest.mark.parametrize("cost_dtype", [("census", torch.int8), ("sad", torch.int16),
                                        ("census", torch.int32)])
@pytest.mark.parametrize("shape", [(2, 3, 1024), (2, 5, 45), (1, 4, 1021)])
def test_sgm_volume_routes_match_plain(cuda_device, shape, cost_dtype, d):
    cost, dtype = cost_dtype
    rng = np.random.default_rng(22)
    if cost == "census":
        ref, other = (torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                       .astype(np.int32)).to(cuda_device) for _ in range(2))
    else:
        ref, other = rand_codes(cuda_device, shape, cost, 22)
    before = fused_sgm.sgm_volume.launches
    got = fused_sgm.sgm_volume(ref, other, d, cost, dtype)
    torch.cuda.synchronize()
    assert fused_sgm.sgm_volume.launches == before + 1
    assert torch.equal(got, fused_sgm.sgm_volume_reference(ref, other, d, cost, dtype))


@pytest.mark.cuda
def test_k3_route_mirror_matches_the_library(cuda_device):
    """``k3_route`` gives the library's own route (``sgm_volume_route``),
    and the library refuses a vector route the shape does not take."""
    lib = fused_sgm._lib("sgm_volume")
    for dtype in (torch.int8, torch.int16, torch.int32):
        esz = torch.empty((), dtype=dtype).element_size()
        for d in (1, 2, 3, 4, 8, 15, 16, 17, 37, 64, 100, 256, 320, 11776, 11777, 11792):
            for w in (1, 4, 16, 45, 1021, 1024, 3840):
                want = fused_sgm.K3_ROUTES.index(fused_sgm.k3_route((1, 1, w, d), dtype))
                assert lib.sgm_volume_route(w, d, esz) == want
    x = torch.zeros((1, 4, 45), dtype=torch.int32, device=cuda_device)
    vol = torch.empty((1, 4, 45, 15), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError):  # 45 x 15 bytes a row: the element route's
        fused_sgm._launch("sgm_volume", cuda_device, x.data_ptr(), x.data_ptr(),
                          vol.data_ptr(), 1, 4, 45, 15, 1, 1, 1)


# K4 also at 2 disparities a lane and more: ND = ceil(D / 32) is 4 at D 100
# and 128, 8 at D 250 and 256.  K4's ring of copies takes a step's runs in
# 16-byte chunks and whole lanes (D 64, 128, 256 at int8; D 100 at int32);
# D 8, 11, 37, 100 and 250 at int8 take its element path, and D 37 and 250
# leave a lane's run partly past D.
K4_DISPARITIES = DISPARITIES + [37, 100, 128, 250, 256]
K4_DTYPES = [(torch.int8, torch.int16), (torch.int16, torch.int16), (torch.int32, torch.int32)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", K4_DISPARITIES)
@pytest.mark.parametrize("vol_agg", K4_DTYPES)
@pytest.mark.parametrize("shape", SGM_SHAPES)
def test_sgm_directional_kernel_matches_plain(cuda_device, shape, vol_agg, d):
    """Each of the four paths alone (written), then the 4-path sum."""
    vol_dtype, agg_dtype = vol_agg
    rng = np.random.default_rng(22)
    vol = torch.from_numpy(rng.integers(0, 25, (*shape, d)).astype(np.int32))
    vol = vol.to(vol_dtype).to(cuda_device)
    p1, p2 = (8, 96) if agg_dtype == torch.int16 else (10, 20000)
    for along_y, reverse in sgm.PATHS:
        agg = torch.full(vol.shape, -1, dtype=agg_dtype, device=cuda_device)
        fused_sgm.sgm_directional(vol, agg, p1, p2, along_y, reverse, accumulate=False)
        ref = fused_sgm.sgm_directional_reference(vol, p1, p2, along_y, reverse)
        assert torch.equal(agg.to(torch.int32), ref), (along_y, reverse)
    before = fused_sgm.sgm_directional.launches
    got = fused_sgm.sgm_aggregate_paths(vol, p1, p2, agg_dtype)
    torch.cuda.synchronize()
    assert fused_sgm.sgm_directional.launches == before + 4
    assert torch.equal(got.to(torch.int32), sgm.sgm_aggregate(vol, p1, p2))


@pytest.mark.cuda
@pytest.mark.parametrize("d", K4_DISPARITIES)
@pytest.mark.parametrize("vol_agg", K4_DTYPES)
@pytest.mark.parametrize("shape", SGM_SHAPES + [(2, 1, 37), (2, 29, 1)])
def test_sgm_diagonal_paths_kernel_match_plain(cuda_device, shape, vol_agg, d):
    """Each of the four diagonal paths alone (written, then added onto a
    filled aggregate), then the 8-path sum."""
    vol_dtype, agg_dtype = vol_agg
    rng = np.random.default_rng(26)
    vol = torch.from_numpy(rng.integers(0, 25, (*shape, d)).astype(np.int32))
    vol = vol.to(vol_dtype).to(cuda_device)
    p1, p2 = (8, 96) if agg_dtype == torch.int16 else (10, 20000)
    for direction, reverse in sgm.DIAG_PATHS:
        ref = fused_sgm.sgm_directional_reference(vol, p1, p2, direction, reverse)
        agg = torch.full(vol.shape, -1, dtype=agg_dtype, device=cuda_device)
        fused_sgm.sgm_directional(vol, agg, p1, p2, direction, reverse, accumulate=False)
        assert torch.equal(agg.to(torch.int32), ref), (direction, reverse)
        agg = torch.full(vol.shape, 5, dtype=agg_dtype, device=cuda_device)
        fused_sgm.sgm_directional(vol, agg, p1, p2, direction, reverse, accumulate=True)
        assert torch.equal(agg.to(torch.int32), ref + 5), (direction, reverse)
    before = fused_sgm.sgm_directional.launches
    got = fused_sgm.sgm_aggregate_paths(vol, p1, p2, agg_dtype, directions=8)
    torch.cuda.synchronize()
    assert fused_sgm.sgm_directional.launches == before + 8
    assert torch.equal(got.to(torch.int32), sgm.sgm_aggregate(vol, p1, p2, directions=8))


# Lines shorter than K4's ring of 8 steps in flight: an image of 1, 2 or
# 3 rows or columns, so rows, columns and diagonals of 1 to 3 steps and
# the ring's tail.
SHORT_SHAPES = [(2, 1, 37), (2, 2, 29), (2, 3, 40), (2, 29, 1), (2, 37, 2), (2, 40, 3),
                (1, 1, 1), (3, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [11, 64, 100])
@pytest.mark.parametrize("vol_agg", K4_DTYPES)
@pytest.mark.parametrize("shape", SHORT_SHAPES)
def test_sgm_directional_short_lines_match_plain(cuda_device, shape, vol_agg, d):
    """All eight paths on lines shorter than the ring, written and added."""
    vol_dtype, agg_dtype = vol_agg
    rng = np.random.default_rng(27)
    vol = torch.from_numpy(rng.integers(0, 25, (*shape, d)).astype(np.int32))
    vol = vol.to(vol_dtype).to(cuda_device)
    for direction, reverse in sgm.PATHS + sgm.DIAG_PATHS:
        ref = fused_sgm.sgm_directional_reference(vol, 8, 96, direction, reverse)
        agg = torch.full(vol.shape, -1, dtype=agg_dtype, device=cuda_device)
        fused_sgm.sgm_directional(vol, agg, 8, 96, direction, reverse, accumulate=False)
        assert torch.equal(agg.to(torch.int32), ref), (direction, reverse)
        agg = torch.full(vol.shape, 5, dtype=agg_dtype, device=cuda_device)
        fused_sgm.sgm_directional(vol, agg, 8, 96, direction, reverse, accumulate=True)
        assert torch.equal(agg.to(torch.int32), ref + 5), (direction, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 256])
@pytest.mark.parametrize("vol_agg", K4_DTYPES)
def test_sgm_directional_unaligned_runs_match_plain(cuda_device, vol_agg, d):
    """Contiguous views one element into their storage: a lane's run is
    then not aligned to one access, and K4 takes its element path."""
    vol_dtype, agg_dtype = vol_agg
    rng = np.random.default_rng(28)
    shape = (2, 19, 23, d)
    vol = torch.from_numpy(rng.integers(0, 25, shape).astype(np.int32)).to(vol_dtype)
    vol_store = torch.zeros(vol.numel() + 1, dtype=vol_dtype, device=cuda_device)
    vol_store[1:] = vol.flatten().to(cuda_device)
    vol_c = vol_store[1:].view(shape)
    agg = torch.zeros(vol.numel() + 1, dtype=agg_dtype, device=cuda_device)[1:].view(shape)
    for direction, reverse in sgm.PATHS + sgm.DIAG_PATHS:
        fused_sgm.sgm_directional(vol_c, agg, 8, 96, direction, reverse, accumulate=False)
        ref = fused_sgm.sgm_directional_reference(vol_c, 8, 96, direction, reverse)
        assert torch.equal(agg.to(torch.int32), ref), (direction, reverse)


# K7's shapes: two below a strip of 32 columns, one ragged at 130, and
# the edges: one row, one column, a width below most D, a height past two
# tiles of rows.
BOX_SHAPES = [(2, 37, 45), (1, 64, 96), (3, 19, 130), (3, 1, 45), (2, 29, 1), (1, 13, 20),
              (1, 150, 40)]


def k7_route(cost, window, d):
    """The kernel K7 runs for the cases below (``csrc/disparity.cu``: SAD
    strips wherever they fit in shared memory, census strips with 4 or
    more warps per SM; else the tiles, staged in 116 KB or read through
    L1)."""
    if cost == "sad":
        return "tiles through L1" if window == 255 and d >= 33 else "strips"
    if window >= 101:
        return "tiles through L1"
    if d == 256 or (window == 31 and d == 100):
        return "tiles staged"
    return "strips"


def assert_k7_matches_plain(ref, other, params, device):
    ref_t, other_t = (torch.from_numpy(x.astype(np.int32)).to(device) for x in (ref, other))
    for reference in ("left", "right"):
        before = fused_modern.disparity.launches
        got = fused_modern.disparity(ref_t, other_t, params, reference)
        torch.cuda.synchronize()
        assert fused_modern.disparity.launches == before + 1
        want = fused_modern.disparity_reference(ref_t, other_t, params, reference)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                      b.view(torch.int32)), reference


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 8, 11, 33, 64, 100, 256])
@pytest.mark.parametrize("window", [1, 9, 31, 101, 255])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_disparity_kernel_matches_plain(cuda_device, cost, window, d):
    """K7 against its plain version, both references, on shapes smaller
    than a strip or a tile and ragged ones; D that do not fill the lanes
    (2, 33, 100) beside 8, 11, 64, 256; each route (``k7_route``)."""
    params = ModernParams(num_disparities=d, window=window, cost=cost)
    assert fused_modern.route(params) == k7_route(cost, window, d)
    rng = np.random.default_rng(27)
    for shape in BOX_SHAPES:
        hi = 1 << 24 if cost == "census" else 256
        ref = rng.integers(0, hi, shape)
        other = np.clip(np.roll(ref, 3, axis=2) + rng.integers(-2, 3, shape), 0, hi - 1)
        assert_k7_matches_plain(ref, other, params, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 33, 64, 256])
@pytest.mark.parametrize("case", ["equal", "last", "plateau", "extremes"])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_disparity_kernel_ties_and_domain_edges(cuda_device, cost, case, d):
    """K7 against its plain version where the argmin is decided by ties
    or sits at an end, and at the edges of its input domain: equal images
    (an all-zero cost at d = 0 for the left view), a texture whose only
    minimum is at D - 1, two-level images (plateaus of equal minima, the
    first must win), and inputs of only 0 and the largest value (255 for
    SAD, a census code with all 24 bits set)."""
    params = ModernParams(num_disparities=d, window=9, cost=cost)
    top = (1 << 24) - 1 if cost == "census" else 255
    rng = np.random.default_rng(31)
    shape = (2, 40, 300)
    if case == "equal":
        ref = rng.integers(0, top + 1, shape)
        other = ref.copy()
    elif case == "last":
        ref = rng.integers(0, top + 1, shape)
        other = np.roll(ref, -(d - 1), axis=2)  # ref(x) = other(x - (D - 1))
    elif case == "plateau":
        ref, other = (rng.integers(0, 2, shape) * top for _ in range(2))
        ref[:, :, ::7] = other[:, :, ::7] = 0
    else:
        ref, other = (rng.choice([0, top], shape) for _ in range(2))
    assert_k7_matches_plain(ref, other, params, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [256, -1])
def test_box_route_refuses_pixels_k7_cannot_match(cuda_device, bad):
    """The box route with SAD raises on an int32 plane holding a value
    outside 0..255 (K7 stages SAD inputs as bytes), before any launch; the
    same plane within range runs K7 and equals the plain route."""
    rng = np.random.default_rng(41)
    left, right = (torch.from_numpy(rng.integers(0, 256, (2, 24, 70), dtype=np.int32))
                   .to(cuda_device) for _ in range(2))
    pipe = modern.ModernPipeline(ModernParams(num_disparities=16))
    bad_left = left.clone()
    bad_left[1, 5, 9] = bad
    before = fused_modern.disparity.launches
    with pytest.raises(ValueError, match="0..255"):
        pipe(bad_left, right)
    assert fused_modern.disparity.launches == before
    got = pipe(left, right)
    assert fused_modern.disparity.launches == before + 2
    want = modern.modern_forward_reference(left, right, pipe.params)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# K5 at 1 to 8 words a lane: D 1-64 at int16 (37 odd, read element by
# element), 100 / 128 at 2 and 4, 256 at 4 (int16) and 8 (int32); W 45
# below D from 64 up.
K5_DISPARITIES = [1, 8, 11, 37, 64, 100, 128, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["segments", "wide"])
@pytest.mark.parametrize("d", K5_DISPARITIES)
@pytest.mark.parametrize("agg_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("shape", SGM_SHAPES)
def test_sgm_tail_kernel_matches_plain(cuda_device, shape, agg_dtype, d, route):
    """Both routes of K5, with and without uniqueness, on costs with ties
    (0..59), one launch each; the aggregate is never written."""
    rng = np.random.default_rng(23)
    agg = torch.from_numpy(rng.integers(0, 60, (*shape, d)).astype(np.int32))
    agg = agg.to(agg_dtype).to(cuda_device)
    copy = agg.clone()
    assert fused_sgm.k5_route(agg.shape, agg.dtype) == "segments"  # small W
    for uniq in (False, True):
        before = fused_sgm.sgm_tail.launches
        got = fused_sgm._tail_on_card(agg, uniq, route)
        torch.cuda.synchronize()
        assert fused_sgm.sgm_tail.launches == before + 1
        ref = fused_sgm.sgm_tail_reference(agg, uniq)
        assert len(got) == len(ref) == 4 + uniq
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(agg, copy)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["segments", "wide"])
@pytest.mark.parametrize("d", [1, 3, 64, 256])
@pytest.mark.parametrize("agg_dtype", [torch.int16, torch.int32])
def test_sgm_tail_kernel_sentinels_and_signs(cuda_device, agg_dtype, d, route):
    """K5 at the edges of its domain: negative int16 costs, int32 costs at
    and past both sentinels (2^28 for the right view and the second best,
    2^30 for the left view), pixels whose every cost is past them."""
    rng = np.random.default_rng(24)
    if agg_dtype == torch.int16:
        vals = rng.integers(-32768, 32768, (2, 9, 70, d))
    else:
        pool = np.array([2**28 - 1, 2**28, 2**28 + 5, 2**30 - 1, 2**30, 2**30 + 3, 2**31 - 1,
                         -(2**31), -5, 7])
        vals = rng.choice(pool, (2, 9, 70, d))
        vals[0, 0] = 2**30 + 9
        vals[0, 1] = 2**28 + 1
    agg = torch.from_numpy(vals.astype(np.int64)).to(agg_dtype).to(cuda_device)
    for uniq in (False, True):
        got = fused_sgm._tail_on_card(agg, uniq, route)
        for a, b in zip(got, fused_sgm.sgm_tail_reference(agg, uniq)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sgm_tail_routes_at_the_bench_shape(cuda_device):
    """``sgm_tail`` takes ``k5_route``'s route: the segments at the bench
    instance (int16, D=64, 1024 columns), the wide kernel for int32 at
    D=256; both equal the plain version."""
    rng = np.random.default_rng(25)
    for dtype, d, want in ((torch.int16, 64, "segments"), (torch.int32, 256, "wide")):
        agg = torch.from_numpy(rng.integers(0, 3000, (1, 2, 1024, d)).astype(np.int32))
        agg = agg.to(dtype).to(cuda_device)
        assert fused_sgm.k5_route(agg.shape, dtype) == want
        got = fused_sgm.sgm_tail(agg, True)
        for a, b in zip(got, fused_sgm.sgm_tail_reference(agg, True)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k5_smem_mirror_matches_the_library(cuda_device):
    """``k5_smem_bytes``, by which ``k5_route`` chooses, gives the
    library's own figure (``sgm_tail_smem_bytes``)."""
    lib = fused_sgm._lib("sgm_tail")
    for esz in (2, 4):
        for d in (1, 2, 37, 64, 100, 128, 255, 256, 257, 512):
            for w in (1, 45, 127, 128, 129, 1024, 3840):
                assert fused_sgm.k5_smem_bytes(esz, d, w) == lib.sgm_tail_smem_bytes(esz, d, w)


# K6 around its launches (16 sweeps a launch: 15, 16, 17, 31, 33) on
# shapes of one row or column and widths and heights that are not a
# multiple of its 64 x 64 tile; random validity 30% (holes that fill) and
# 90%.
@pytest.mark.cuda
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("iterations", [0, 1, 2, 3, 15, 16, 17, 31, 33])
@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 1, 70), (3, 64, 33), (1, 70, 1),
                                   (2, 130, 200), (1, 65, 129), (2, 64, 64)])
def test_fill_invalid_kernel_matches_plain(cuda_device, shape, iterations, special):
    rng = np.random.default_rng(24)
    for density in (0.3, 0.9):
        d = (rng.random(shape) * 64).astype(np.float32)
        v = rng.random(shape) < density
        if special:
            d = special_disparities(d, v, rng)
        d, v = (torch.from_numpy(x).to(cuda_device) for x in (d, v))
        d0, v0 = d.clone(), v.clone()
        before = fused_diffusion.fill_invalid.launches
        got = fused_diffusion.fill_invalid(d, v, iterations)
        torch.cuda.synchronize()
        assert (fused_diffusion.fill_invalid.launches
                == before + fused_diffusion.k6_plan(iterations).launches)
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32)) and torch.equal(v, v0)
        ref = fused_diffusion.fill_invalid_reference(d, v, iterations)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))  # bits, NaNs too


@pytest.mark.cuda
def test_k6_mirrors_match_the_library(cuda_device):
    """``K6_MAX_SWEEPS`` and ``k6_smem_bytes``, by which ``k6_plan``
    counts launches, give the library's own figures."""
    lib = fused_diffusion._lib("fill_invalid")
    assert lib.fill_invalid_max_sweeps() == fused_diffusion.K6_MAX_SWEEPS
    for h in range(fused_diffusion.K6_MAX_SWEEPS + 1):
        assert lib.fill_invalid_smem_bytes(h) == fused_diffusion.k6_smem_bytes(h)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(cost="census", num_disparities=64),
                                dict(cost="sad", num_disparities=11, uniqueness=True,
                                     median_filter=True),
                                dict(cost="census", num_disparities=8, sgm_p2=20000,
                                     fill_mode="background", uniqueness=True),
                                dict(cost="census", num_disparities=64, sgm_directions=8,
                                     median_filter=True, uniqueness=True),
                                dict(cost="sad", num_disparities=11, sgm_directions=8,
                                     sgm_p2=20000, uniqueness=True),
                                dict(aggregation="box", num_disparities=64),
                                dict(aggregation="box", cost="census", window=5,
                                     num_disparities=11, median_filter=True),
                                dict(aggregation="box", num_disparities=8, window=35,
                                     lr_max_diff=0, fill_mode="background")])
def test_modern_forward_kernels_match_plain(cuda_device, kw):
    params = ModernParams(**{"aggregation": "sgm", **kw})
    rng = np.random.default_rng(25)
    left = rng.integers(0, 256, (2, 45, 77)).astype(np.int32)
    right = np.roll(left, -3, axis=2)
    lt, rt = (torch.from_numpy(x).to(cuda_device) for x in (left, right))
    got = modern.modern_forward(lt, rt, params)
    ref = modern.modern_forward_reference(lt, rt, params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
def test_sgm_wrappers_check_inputs(cuda_device):
    x = torch.zeros((2, 16, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fused_sgm.sgm_volume(x.float(), x.float(), 8)
    with pytest.raises(ValueError):
        fused_sgm.sgm_volume(x.transpose(1, 2), x.transpose(1, 2), 8)
    vol = torch.zeros((2, 16, 16, 300), dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError):
        fused_sgm.sgm_directional(vol, vol.clone(), 8, 96, False, False, False)  # D > 256
    with pytest.raises(ValueError):
        fused_diffusion.fill_invalid(x.float(), x, 4)  # validity must be bool
    with pytest.raises(ValueError):
        fused_sgm.sgm_tail(vol.transpose(1, 2))
    with pytest.raises(ValueError):
        fused_sgm.sgm_directional(vol[..., :8], vol[..., :8].clone(), 8, 96, 4, False, False)


@pytest.mark.cuda
def test_disparity_wrapper_checks_inputs(cuda_device):
    x = torch.zeros((2, 16, 16), dtype=torch.int32, device=cuda_device)
    params = ModernParams(num_disparities=8)
    with pytest.raises(ValueError):
        fused_modern.disparity(x.float(), x.float(), params)
    with pytest.raises(ValueError):
        fused_modern.disparity(x.transpose(1, 2), x.transpose(1, 2), params)
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x[:1], params)
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x, params, reference="middle")
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x, ModernParams(num_disparities=8, window=257))
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x, ModernParams(num_disparities=300))
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x, ModernParams(num_disparities=8, scales=2))
    with pytest.raises(ValueError):
        fused_modern.disparity(x, x.cpu(), params)
    assert fused_modern.disparity(x[0], x[0], params).disparity.shape == (16, 16)


def rand_edges(device, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 2, shape).astype(np.int32)).to(device)
            for _ in range(2)]


# (D, square_width, shape): D 1 to 256 (D > W = 45 from 64 up) at windows
# 1 and 21, and the 255 window at D <= 64, on 2 x 37 x 45; then the 255
# window at D 114, 300 and 1000 (right bit rows of 9 to 38 words)
# on widths 1, 33, 129 and 200 (one and two 128-column tiles, D > W) and
# heights around 64 and 128 (the tile heights with and without the
# sub-pixel plane).
K8_CASES = [(1, 1), (1, 21), (30, 1), (30, 21), (64, 21), (256, 1), (256, 21), (30, 255),
            (64, 255)]
K8_CASES = [(d, sw, (2, 37, 45)) for d, sw in K8_CASES] + [
    (114, 255, (2, 64, 129)), (114, 255, (2, 129, 33)), (300, 255, (2, 65, 200)),
    (300, 255, (2, 128, 1)), (1000, 255, (2, 63, 33)), (1000, 255, (2, 127, 129)),
    (300, 21, (2, 130, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("d_sw", K8_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_match_and_score_kernel_matches_plain(cuda_device, mode, d_sw, subpixel):
    d, sw, shape = d_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode)
    el, er = rand_edges(cuda_device, shape, 31)
    before = fused.match_and_score.launches
    got = fused.match_and_score(el, er, params, subpixel)
    torch.cuda.synchronize()
    assert fused.match_and_score.launches == before + 1
    ref = fused.match_and_score(el.cpu(), er.cpu(), params, subpixel)
    assert len(got) == len(ref) == 2 + subpixel
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a.cpu().view(torch.int32),
                                                  b.view(torch.int32))
    single = fused.match_and_score(el[1], er[1], params, subpixel)
    for a, b in zip(single, got):
        assert torch.equal(a, b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_match_and_score_kernel_reads_nonzero_as_edge(cuda_device, mode):
    """Edge values other than 0 and 1 (2 is ghost mode's left sentinel,
    256 wraps to 0 as a byte) are edges on the card as on the CPU."""
    params = StereoParams(num_shifts=30, square_width=5, mode=mode)
    rng = np.random.default_rng(33)
    maps = rng.choice(np.array([0, 0, 0, 1, 2, 3, 256, -1], np.int32), (2, 2, 37, 45))
    el, er = (torch.from_numpy(m).to(cuda_device) for m in maps)
    got = fused.match_and_score(el, er, params, True)
    ref = fused.match_and_score(el.cpu(), er.cpu(), params, True)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_match_and_score_wrapper_checks_inputs(cuda_device):
    el, er = rand_edges(cuda_device, (2, 37, 45), 32)
    with pytest.raises(ValueError, match="shared memory"):
        fused.match_and_score(el, er, StereoParams(num_shifts=1953, square_width=255))
    with pytest.raises(ValueError):
        fused.match_and_score(el, er, StereoParams(num_shifts=8, square_width=257))
    with pytest.raises(ValueError):
        fused.match_and_score(el.float(), er.float(), StereoParams(num_shifts=8))
    with pytest.raises(ValueError):
        fused.match_and_score(el.transpose(1, 2), er.transpose(1, 2), StereoParams(num_shifts=8))
    with pytest.raises(ValueError):
        fused.match_and_score(el, er.cpu(), StereoParams(num_shifts=8))


@pytest.mark.cuda
def test_smem_mirrors_match_the_libraries(cuda_device):
    """The Python mirror the routes are chosen by gives the library's own
    shared-memory figure (``match_loop::smem_bytes``, the one layout of
    K1, K8 and K9) over a grid of (half, D)."""
    k1 = fused._lib("match_score_edges")
    for half in (0, 1, 10, 15, 16, 50, 127, 150):
        for d in (1, 2, 31, 32, 33, 64, 256, 257, 1000, 1952, 1953, 4000):
            assert (fused.match_score_edges_smem_bytes(half, d)
                    == k1.match_score_edges_smem_bytes(half, d)), (half, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_shifts_sw", K1_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_match_score_edges_subpixel_kernel_matches_plain(cuda_device, mode, shape_shifts_sw):
    shape, d, sw = shape_shifts_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
    rng = np.random.default_rng(13)
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32) / 256.0)
                   .to(cuda_device) for _ in range(2))
    got = fused.match_score_edges(left, right, params, subpixel=True)
    torch.cuda.synchronize()
    ref = fused.match_score_edges_reference(left, right, params, subpixel=True)
    assert len(got) == 5 and got[4].dtype == torch.float32
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(fused.match_score_edges(left, right, params), got):
        assert torch.equal(a, b)


def knife_edge_brightness(seed, shape=(3, 40, 56)):
    """u8 / 256 brightness on which the reference rule's decision
    |avg_a - avg_b| > thr * overall is a tie in real arithmetic for thr
    0.2, 0.15 and 0.1: 3-pixel strips of k and k' with k / k' = (2 + thr)
    / (2 - thr) (11:9, 43:37, 21:19), so only the float rounding of each
    op decides; strips run along rows and columns, with random pixels
    between them."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    img = rng.integers(0, 256, shape)
    ratios = [(11, 9), (43, 37), (21, 19)]
    for i in range(b):
        p, q = ratios[i % 3]
        for x in range(0, w - 2, 4):
            m = rng.integers(1, 256 // p + 1)
            img[i, :, x], img[i, :, x + 2] = p * m, q * m
        for y in range(h // 2, h - 2, 5):
            m = rng.integers(1, 256 // p + 1)
            img[i, y, :], img[i, y + 2, :] = q * m, p * m
    return img.astype(np.float32) / np.float32(256.0), [0.2, 0.15, 0.1][: b]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_reference_edges_on_card_equal_cpu_at_knife_edges(cuda_device, mode):
    """The reference rule's float ops (/3, /2 as IEEE divisions by device
    scalars, one product, one clamp) decide every knife-edge pixel as the
    CPU does."""
    from stereomatching_tpu_torch.ops.edges import find_edges

    for seed in range(4):
        img, thresholds = knife_edge_brightness(seed)
        for i, thr in enumerate(thresholds):
            x = torch.from_numpy(img[i])
            got = find_edges(x.to(cuda_device), thr, mode, "reference")
            assert torch.equal(got.cpu(), find_edges(x, thr, mode, "reference")), (seed, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_reference_rule_pipeline_kernels_match_plain(cuda_device, mode, subpixel):
    """The classic pipeline with the reference rule launches K8 (not K1)
    and equals the CPU's plain route on every artifact."""
    from stereomatching_tpu_torch.models import classic

    params = StereoParams(num_shifts=24, square_width=9, times=6, mode=mode)
    img, _ = knife_edge_brightness(7)
    left = torch.from_numpy(img)
    right = torch.from_numpy(np.roll(img, 3, axis=2))
    k1, k8 = fused.match_score_edges.launches, fused.match_and_score.launches
    got = classic.classic_forward_batched(left.to(cuda_device), right.to(cuda_device), params,
                                          subpixel=subpixel)
    torch.cuda.synchronize()
    assert fused.match_score_edges.launches == k1
    assert fused.match_and_score.launches == k8 + 1
    ref = classic.classic_forward_batched(left, right, params, subpixel=subpixel)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k].cpu().view(torch.int32), ref[k].view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_collect_pipeline_finishes_through_k2(cuda_device, mode):
    """The collect pipeline's diffusion runs as K2 on the card, and every
    artifact, the per-shift planes included, equals the CPU's."""
    from stereomatching_tpu_torch.models import classic
    from stereomatching_tpu_torch.ops import fused_diffusion

    params = StereoParams(num_shifts=12, square_width=7, times=5, mode=mode)
    img, _ = knife_edge_brightness(8)
    left, right = torch.from_numpy(img[0]), torch.from_numpy(np.roll(img[0], 2, axis=1))
    pipe = classic.build_classic_collect_pipeline(params)
    before = fused_diffusion.fill_web_holes_range.launches
    got = pipe(left.to(cuda_device), right.to(cuda_device))
    torch.cuda.synchronize()
    assert (fused_diffusion.fill_web_holes_range.launches
            == before + fused_diffusion.k2_plan(params.times, params.num_shifts + 1).launches)
    ref = pipe(left, right)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kw",[dict(aggregation="sgm", cost="census", num_disparities=64),
                                dict(aggregation="sgm", cost="sad", num_disparities=11,
                                     sgm_directions=8, coarse_weight=4, uniqueness=True),
                                dict(aggregation="box", cost="census", window=5,
                                     num_disparities=11)])
def test_scales2_kernels_match_plain(cuda_device, kw):
    params = ModernParams(scales=2, **kw)
    rng = np.random.default_rng(26)
    left = rng.integers(0, 256, (2, 45, 77)).astype(np.int32)
    right = np.roll(left, -3, axis=2)
    lt, rt = (torch.from_numpy(x).to(cuda_device) for x in (left, right))
    got = modern.modern_forward(lt, rt, params)
    ref = modern.modern_forward_reference(lt, rt, params)
    cpu = modern.modern_forward_reference(lt.cpu(), rt.cpu(), params)
    assert sorted(got) == sorted(ref) == sorted(cpu)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k].cpu(), cpu[k]), k


# ------------------------------------------------------------------ K10

# [B, H, W] for K10: one pixel, planes narrower or shorter than the halo,
# tile edges (128 columns, 32 rows: widths 127-129 and 256, heights 31-33),
# widths that are not a multiple of 4 (element stores), batch 1-3.
K10_SHAPES = [(1, 1, 1), (2, 1, 5), (3, 4, 1), (1, 2, 2), (2, 3, 130), (1, 31, 127),
              (2, 32, 128), (3, 33, 129), (1, 65, 256), (2, 37, 45), (1, 70, 3), (3, 5, 261)]


def k10_planes(shape, dtype, seed):
    """Two planes: 8-bit pixels, full-range int32 or int16 (widened to
    int32 first); ties in the second (each value twice along a row)."""
    rng = np.random.default_rng(seed)
    lo, hi = {torch.uint8: (0, 256), torch.int32: (-2**31, 2**31),
              torch.int16: (-2**15, 2**15)}[dtype]
    a = torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)).to(dtype)
    b = torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)).to(dtype)
    b = b.repeat_interleave(2, dim=-1)[..., :shape[-1]].contiguous()
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int16])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("shape", K10_SHAPES)
def test_census_kernel_matches_plain(cuda_device, shape, window, dtype):
    """K10's codes of both views, bitwise the plain version's, in one
    launch."""
    a, b = k10_planes(shape, dtype, seed=shape[1] * 1000 + shape[2])
    before = fused_census.census.launches
    got = fused_census.census(a.to(cuda_device), b.to(cuda_device), window)
    torch.cuda.synchronize()
    assert fused_census.census.launches == before + 1
    for g, x in zip(got, (a, b)):
        assert g.dtype == torch.int32 and g.shape == x.shape and g.is_contiguous()
        assert torch.equal(g.cpu(), costvolume.census_transform(x, window))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [3, 5])
def test_census_kernel_at_the_cells_shape(cuda_device, window):
    """K10 at 1110 x 1390, batch 8, on int32 pixels and on the same as
    uint8, against the plain version on the card; [H, W] and 4-D planes
    take one launch too."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    a, b = (torch.randint(0, 256, (8, 1110, 1390), generator=gen, device=cuda_device,
                          dtype=torch.int32) for _ in range(2))
    want = fused_census.census_reference(a, b, window)
    for x, y in ((a, b), (a.to(torch.uint8), b.to(torch.uint8)), (a[3], b[3]),
                 (a.view(2, 4, 1110, 1390), b.view(2, 4, 1110, 1390))):
        before = fused_census.census.launches
        got = fused_census.census(x, y, window)
        assert fused_census.census.launches == before + 1
        for g, w in zip(got, want):
            assert g.shape == x.shape and torch.equal(g, w[3] if x.ndim == 2 else w.view(x.shape))


@pytest.mark.cuda
def test_census_kernel_empty_and_refused(cuda_device):
    before = fused_census.census.launches
    for shape in ((0, 5, 7), (2, 0, 7), (2, 5, 0)):
        x = torch.zeros(shape, dtype=torch.uint8, device=cuda_device)
        cl, cr = fused_census.census(x, x)
        assert cl.shape == cr.shape == shape and cl.device == x.device
    assert fused_census.census.launches == before
    x = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fused_census.census(x, x.cpu())
    with pytest.raises(ValueError):
        fused_census.census(x, x, 7)
    with pytest.raises(ValueError):
        fused_census.census(x.float(), x.float())


@pytest.mark.cuda
def test_census_kernel_is_counted_as_a_torch_op(cuda_device):
    """K10's device name matches no pattern of ``stereobench/kernels``, so
    the benchmark counts its time in ``torch_ops_ms``, where the census
    stood before it."""
    import json
    import re
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros((2, 40, 60), dtype=torch.int32, device=cuda_device)
    fused_census.census(x, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_census.census(x, x)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "census" in e.name}
    assert names and all("census_kernel" in n for n in names), names
    files = Path(__file__).resolve().parents[1].glob("stereobench/kernels/*.json")
    pats = [re.compile(p) for f in files for p in json.loads(f.read_text())["patterns"]]
    assert pats and not any(p.search(n) for p in pats for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("kw", [dict(aggregation="sgm", num_disparities=64),
                                dict(aggregation="sgm", num_disparities=11, census_window=3,
                                     sgm_directions=8, uniqueness=True),
                                dict(aggregation="box", window=5, num_disparities=11),
                                dict(aggregation="box", window=9, num_disparities=64,
                                     census_window=3),
                                dict(aggregation="sgm", num_disparities=16, scales=2)],
                         ids=str)
def test_census_routes_forward_matches_plain(cuda_device, kw, dtype):
    """The SGM and box routes with census on the card, K10 included, equal
    the plain route (``_PLAIN``, whose census is the plain one) plane by plane; one K10
    launch a forward, two at ``scales=2`` (the coarse level's codes)."""
    params = ModernParams(cost="census", **kw)
    rng = np.random.default_rng(27)
    left = rng.integers(0, 256, (2, 45, 77))
    right = np.roll(left, -3, axis=2)
    lt, rt = (torch.from_numpy(x).to(dtype).to(cuda_device) for x in (left, right))
    before = fused_census.census.launches
    got = modern.modern_forward(lt, rt, params)
    assert fused_census.census.launches == before + params.scales
    ref = modern.modern_forward_reference(lt, rt, params)
    assert fused_census.census.launches == before + params.scales
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
def test_traced_sgm_request_counts_one_k10_launch(cuda_device):
    """A traced SGM request at the benchmark's config counts its launches:
    K10 once (both views), K3 once, K4 once a path, K5 once, K6 once."""
    from stereomatching_tpu_torch.utils import tracing

    params = ModernParams(aggregation="sgm", cost="census", num_disparities=256,
                          lr_max_diff=1, fill_iterations=16, sgm_p1=8, sgm_p2=96)
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    lt, rt = (torch.randint(0, 256, (1, 111, 400), generator=gen, device=cuda_device,
                            dtype=torch.int32) for _ in range(2))
    tracing.enable()
    try:
        modern.modern_forward(lt, rt, params)
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    (req,) = tracing.records()["requests"]
    tracing.clear()
    assert req["counters"] == {"launches.K10": 1, "launches.K3": 1, "launches.K4": 4,
                               "launches.K5": 1, "launches.K6": 1}


@pytest.mark.cuda
def test_matcher_warmup_launches_the_route(cuda_device):
    from stereomatching_tpu_torch.serving import Matcher

    before = fused.match_and_score.launches
    Matcher(StereoParams(num_shifts=8, square_width=5), device=cuda_device).warmup(
        (40, 56), batch=2)
    assert fused.match_and_score.launches == before + 1


# ------------------------------------------------------- the sharded tier


def _halo_blocks(rng, b, hs, w, halo, wr, density=0.3):
    """Random 0/1 edge blocks [b, hs + 2*halo, w] and [.., wr] (int32)."""
    rows = hs + 2 * halo
    l_blk = (rng.random((b, rows, w)) < density).astype(np.int32)
    r_blk = (rng.random((b, rows, wr)) < density).astype(np.int32)
    return torch.from_numpy(l_blk), torch.from_numpy(r_blk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (mode, pre_extended, b, hs, w, D, sw, halo)
    (BoundaryMode.WRAP, False, 4, 24, 70, 16, 9, 4),
    (BoundaryMode.WRAP, False, 2, 33, 45, 80, 5, 3),
    (BoundaryMode.GHOST, False, 4, 24, 70, 16, 9, 4),
    (BoundaryMode.GHOST, False, 3, 40, 64, 12, 21, 12),
    (BoundaryMode.GHOST, True, 4, 24, 36, 12, 9, 4),
    (BoundaryMode.WRAP, True, 4, 24, 36, 12, 9, 4),
    # Shards taller than one 128-row tile, one of 3 rows, and sw 255 with
    # D 300 (halos of 127 rows).
    (BoundaryMode.GHOST, False, 2, 150, 70, 16, 9, 4),
    (BoundaryMode.WRAP, False, 2, 140, 45, 20, 21, 10),
    (BoundaryMode.GHOST, False, 3, 3, 50, 12, 5, 2),
    (BoundaryMode.GHOST, True, 2, 20, 36, 300, 255, 127),
    (BoundaryMode.WRAP, False, 2, 20, 40, 300, 255, 127),
])
def test_match_and_score_prehalo_kernel_matches_plain(cuda_device, case):
    mode, pre, b, hs, w, d, sw, halo = case
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode)
    rng = np.random.default_rng(31)
    l_blk, r_blk = _halo_blocks(rng, b, hs, w, halo, w + d)
    h_global = 2 * hs
    # Shards at the top, the bottom and the middle of a taller image.
    row0 = torch.tensor([(i % 3 - 1) * hs - halo for i in range(b)], dtype=torch.int32)
    col0 = torch.tensor([(i % 2) * 20 - params.half for i in range(b)], dtype=torch.int32)
    extra = dict(col0=col0, w_global=w + 10) if pre else {}
    before = fused.match_and_score_prehalo.launches
    got = fused.match_and_score_prehalo(l_blk.to(cuda_device), r_blk.to(cuda_device), params,
                                        halo, row0.to(cuda_device), h_global,
                                        pre_extended=pre, **extra)
    torch.cuda.synchronize()
    assert fused.match_and_score_prehalo.launches == before + 1
    ref = fused.match_and_score_prehalo_reference(l_blk, r_blk, params, halo, row0, h_global,
                                                  pre_extended=pre, **extra)
    for a, b_ in zip(got, ref):
        assert torch.equal(a.cpu(), b_)


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", [
    [0, 7, 8, 19, 30],  # 4 row shards, one of a single row
    [0, 2, 3, 5, 30],  # shards of 2, 1 and 2 rows, shorter than K4's ring
])
# D 40 takes K4's element path at int8 and int16 (runs of 40 and 80 bytes)
# and its ring at int32; D 64 its ring at every type.
@pytest.mark.parametrize("d", [40, 64])
@pytest.mark.parametrize("dtypes", [(torch.int8, torch.int16), (torch.int16, torch.int16),
                                    (torch.int32, torch.int32)])
@pytest.mark.parametrize("direction", [sgm.Y, sgm.DIAG_PLUS, sgm.DIAG_MINUS])
def test_sgm_directional_seeded_chain_matches_plain_and_unsharded(cuda_device, direction, dtypes,
                                                                 d, bounds):
    vdt, adt = dtypes
    rng = np.random.default_rng(32)
    vol = torch.from_numpy(rng.integers(0, 60, (3, 30, 37, d)).astype(np.int32)).to(vdt)
    vol_c = vol.to(cuda_device)
    n = len(bounds) - 1
    for reverse in (False, True):
        full = torch.zeros(vol.shape, dtype=adt, device=cuda_device)
        fused_sgm.sgm_directional(vol_c, full, 8, 96, direction, reverse, accumulate=False)
        agg = torch.zeros(vol.shape, dtype=adt, device=cuda_device)
        seed = seed_ref = None
        order = range(n) if not reverse else reversed(range(n))
        for j in order:
            part = slice(bounds[j], bounds[j + 1])
            a = agg[:, part].contiguous()
            before = fused_sgm.sgm_directional.launches
            a, seed = fused_sgm.sgm_directional(vol_c[:, part].contiguous(), a, 8, 96, direction,
                                                reverse, True, seed=seed, with_carry=True)
            assert fused_sgm.sgm_directional.launches == before + 1
            agg[:, part] = a
            ref, seed_ref = fused_sgm.sgm_directional_reference(
                vol[:, part].contiguous(), 8, 96, direction, reverse, seed=seed_ref,
                with_carry=True)
            torch.cuda.synchronize()
            assert torch.equal(a.cpu().to(torch.int32), ref)
            assert torch.equal(seed.cpu(), seed_ref)
        assert torch.equal(agg, full)


@pytest.mark.cuda
@pytest.mark.parametrize("x_off", [0, 1])
def test_diffusion_step_kernels_match_plain(cuda_device, x_off):
    rng = np.random.default_rng(33)
    b, hs, ws = 3, 21, 37
    we = ws + 2 * x_off
    web = rng.integers(1, 65, (b, hs + 2, we)).astype(np.int32)
    web[rng.random(web.shape) < 0.4] = 0
    prev = torch.from_numpy(rng.integers(0, 65, (b, hs, ws)).astype(np.int32))
    web = torch.from_numpy(web)
    before = fused_diffusion.fill_web_holes_step.launches
    got = fused_diffusion.fill_web_holes_step(prev.to(cuda_device), web.to(cuda_device), x_off)
    torch.cuda.synchronize()
    assert fused_diffusion.fill_web_holes_step.launches == before + 1
    assert torch.equal(got.cpu(), fused_diffusion.fill_web_holes_step_reference(prev, web, x_off))
    d = torch.from_numpy(rng.random((b, hs + 2, we)).astype(np.float32) * 64)
    v = torch.from_numpy((rng.random((b, hs + 2, we)) < 0.5).astype(np.uint8))
    got = fused_diffusion.fill_invalid_step(d.to(cuda_device), v.to(cuda_device), x_off)
    ref = fused_diffusion.fill_invalid_step_reference(d, v, x_off)
    torch.cuda.synchronize()
    for a, b_ in zip(got, ref):
        assert a.dtype == b_.dtype and torch.equal(a.cpu(), b_)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_shape", [(2, 4, None), (1, 2, 2), (2, 2, 2)])
def test_sharded_classic_on_one_card_matches_single_device(cuda_device, mode, mesh_shape):
    from stereomatching_tpu_torch.models.classic import classic_forward_batched
    from stereomatching_tpu_torch.parallel import build_sharded_pipeline, make_mesh, outputs_to_global

    data, rows, cols = mesh_shape
    params = StereoParams(num_shifts=12, square_width=9, times=6, lines=4, mode=mode,
                          edge_rule="exact")
    mesh = make_mesh(data=data, rows=rows, cols=cols,
                     devices=[cuda_device] * (data * rows * (cols or 1)))
    rng = np.random.default_rng(34)
    shape = (data, 48, 40 * (cols or 1))
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32) / 256.0)
                   .to(cuda_device) for _ in range(2))
    before = fused.match_and_score_prehalo.launches
    got = outputs_to_global(build_sharded_pipeline(params, mesh)(left, right))
    assert fused.match_and_score_prehalo.launches == before + 1
    want = classic_forward_batched(left, right, params)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mesh_shape", [
    (dict(aggregation="sgm", cost="census", sgm_directions=8, median_filter=True,
          uniqueness=True), (1, 4, None)),
    (dict(aggregation="sgm", cost="sad"), (2, 2, None)),
    (dict(cost="census", window=5, median_filter=True), (2, 4, None)),
    (dict(cost="sad", window=5, median_filter=True), (1, 2, 2)),
])
def test_sharded_modern_on_one_card_matches_single_device(cuda_device, kw, mesh_shape):
    from stereomatching_tpu_torch.parallel import build_sharded_modern_pipeline, make_mesh, outputs_to_global

    data, rows, cols = mesh_shape
    params = ModernParams(num_disparities=16, **kw)
    mesh = make_mesh(data=data, rows=rows, cols=cols,
                     devices=[cuda_device] * (data * rows * (cols or 1)))
    rng = np.random.default_rng(35)
    shape = (data, 48, 40 * (cols or 1))
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.int32)).to(cuda_device)
                   for _ in range(2))
    got = outputs_to_global(build_sharded_modern_pipeline(params, mesh)(left, right))
    want = modern.modern_forward(left, right, params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.cuda
def test_sharded_over_every_visible_gpu_in_one_process(cuda_device):
    """One process, one block of shards per GPU (``make_mesh``'s default
    devices, as the CLI's ``--tier sharded`` uses them): the blocks run
    in threads and their halos and SGM carries cross devices."""
    from stereomatching_tpu_torch.models.classic import classic_forward_batched
    from stereomatching_tpu_torch.parallel import (
        build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh, outputs_to_global)

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more GPUs")
    mesh = make_mesh(data=1, rows=n)
    assert len(mesh.blocks[2]) == n
    rng = np.random.default_rng(36)
    shape = (2, 12 * n, 48)
    left, right = (rng.integers(0, 256, shape) for _ in range(2))
    cparams = StereoParams(num_shifts=12, square_width=9, times=6, lines=4,
                           mode=BoundaryMode.GHOST, edge_rule="exact")
    lf, rf = (torch.from_numpy(x.astype(np.float32) / 256.0).to(cuda_device) for x in (left, right))
    got = outputs_to_global(build_sharded_pipeline(cparams, mesh)(lf, rf))
    for k, v in classic_forward_batched(lf, rf, cparams).items():
        assert torch.equal(got[k].to(cuda_device), v), k
    mparams = ModernParams(num_disparities=16, aggregation="sgm", cost="census", sgm_directions=8)
    lp, rp = (torch.from_numpy(x.astype(np.int32)).to(cuda_device) for x in (left, right))
    got = outputs_to_global(build_sharded_modern_pipeline(mparams, mesh)(lp, rp))
    for k, v in modern.modern_forward(lp, rp, mparams).items():
        assert torch.equal(got[k].to(cuda_device), v), k


def _pair(device, shape, seed, brightness):
    rng = np.random.default_rng(seed)
    pair = [rng.integers(0, 256, shape) for _ in range(2)]
    if brightness:
        return [torch.from_numpy(x.astype(np.float32) / 256.0).to(device) for x in pair]
    return [torch.from_numpy(x.astype(np.int32)).to(device) for x in pair]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["reference", "exact"])
def test_classic_square_width_301_route_equals_cpu(cuda_device, rule):
    """sw 301 is past K1's and K8's 255: the matching stage runs its plain
    version on the card (no K1 / K8 launch), K2 still runs, and every
    artifact equals the CPU route's."""
    from stereomatching_tpu_torch.models.classic import ClassicPipeline

    params = StereoParams(num_shifts=8, square_width=301, edge_rule=rule, times=4)
    left, right = _pair(cuda_device, (320, 320), 41, True)
    counts = (fused.match_score_edges.launches, fused.match_and_score.launches,
              fused_diffusion.fill_web_holes_range.launches)
    got = ClassicPipeline(params)(left, right)
    assert (fused.match_score_edges.launches, fused.match_and_score.launches) == counts[:2]
    assert fused_diffusion.fill_web_holes_range.launches > counts[2]
    want = ClassicPipeline(params)(left.cpu(), right.cpu())
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("aggregation", ["box", "sgm"])
def test_modern_320_disparities_route_equals_cpu(cuda_device, aggregation):
    """D 320 is past K7's and K4's 256: ModernMatcher runs those stages'
    plain versions on the card, the other kernels as usual, and returns the
    CPU route's planes bit for bit."""
    from stereomatching_tpu_torch.serving import ModernMatcher

    params = ModernParams(num_disparities=320, aggregation=aggregation, cost="census")
    rng = np.random.default_rng(42)
    left, right = (rng.integers(0, 256, (2, 40, 352), dtype=np.uint8) for _ in range(2))
    gpu = ModernMatcher(params, device="cuda")
    stage = "disparity" if aggregation == "box" else "aggregate"
    assert list(gpu.plain_stages) == [stage]
    before = (fused_modern.disparity.launches, fused_sgm.sgm_directional.launches,
              fused_diffusion.fill_invalid.launches)
    got = gpu(left, right)
    assert (fused_modern.disparity.launches, fused_sgm.sgm_directional.launches) == before[:2]
    assert fused_diffusion.fill_invalid.launches > before[2]
    want = ModernMatcher(params, device="cpu")(left, right)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k].view(np.uint8),
                                                          v.view(np.uint8)), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["box-d320", "classic-sw255-d2000"])
def test_sharded_plain_stage_route_equals_single_device(cuda_device, case):
    """A config the predicate sends to plain on the sharded tier (rows 2 on
    one card): K7 past D 256, K9 past its shared memory (1952 shifts at sw
    255); equal to the single-device route."""
    from stereomatching_tpu_torch.models.classic import classic_forward_batched
    from stereomatching_tpu_torch.parallel import (
        build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh, outputs_to_global)

    mesh = make_mesh(data=1, rows=2, devices=[cuda_device] * 2)
    if case == "box-d320":
        params = ModernParams(num_disparities=320)
        left, right = _pair(cuda_device, (1, 40, 352), 43, False)
        got = outputs_to_global(build_sharded_modern_pipeline(params, mesh)(left, right))
        want = modern.modern_forward(left, right, params)
    else:
        params = StereoParams(num_shifts=2000, square_width=255, times=4, lines=4)
        left, right = _pair(cuda_device, (1, 320, 320), 44, True)
        before = fused.match_and_score_prehalo.launches
        got = outputs_to_global(build_sharded_pipeline(params, mesh)(left, right))
        assert fused.match_and_score_prehalo.launches == before
        want = classic_forward_batched(left, right, params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].to(cuda_device), v), k


@pytest.mark.cuda
def test_cli_square_width_301_cuda_equals_cpu(cuda_device, tmp_path, capsys):
    """The CLI at sw 301: --tier cuda writes --tier cpu's PPMs and prints
    one note line naming the plain stage."""
    import os

    from stereomatching_tpu_torch import cli
    from stereomatching_tpu_torch.utils.imageio import write_png_gray

    rng = np.random.default_rng(45)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    for path in (a, b):
        write_png_gray(path, rng.integers(0, 256, (320, 320), dtype=np.uint8))
    outs = {}
    for tier in ("cuda", "cpu"):
        outs[tier] = str(tmp_path / tier)
        assert cli.main([a, b, "0.15", "301", "--shifts", "8", "--tier", tier,
                         "--outdir", outs[tier]]) == 0
        err = capsys.readouterr().err
        notes = [line for line in err.splitlines() if line.startswith("note:")]
        assert notes == (["note: plain torch on the GPU for match_and_score: "
                          "square_width 301 > 255"] if tier == "cuda" else []), err
    files = sorted(os.listdir(outs["cpu"]))
    assert len(files) == 6 and sorted(os.listdir(outs["cuda"])) == files
    for f in files:
        with open(os.path.join(outs["cuda"], f), "rb") as x, \
                open(os.path.join(outs["cpu"], f), "rb") as y:
            assert x.read() == y.read(), f


def _png_dataset(root, n, shape, seed):
    from stereomatching_tpu_torch.data import StereoPairDataset
    from stereomatching_tpu_torch.utils.imageio import write_png_gray

    rng = np.random.default_rng(seed)
    for i in range(n):
        for side in ("left", "right"):
            write_png_gray(str(root / f"p{i:02d}_{side}.png"),
                           rng.integers(0, 256, shape, dtype=np.uint8))
    return StereoPairDataset.from_root(str(root))


def _assert_batches_equal(got, host):
    assert len(got) == len(host)
    for (lb, rb, kept), (hl, hr, hk) in zip(got, host):
        assert kept == hk
        for a, b in ((lb, hl), (rb, hr)):
            assert a.device.type == "cuda" and a.dtype == torch.float32
            assert torch.equal(a.cpu().view(torch.int32), torch.from_numpy(b).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=3, prefetch=1, num_threads=1),
    dict(batch_size=4, pad_to=(40, 70), drop_last=True),
])
def test_batch_loader_pinned_copies_equal_host_batches(cuda_device, tmp_path, kw):
    """The loader's batches on the card (uint8 staged in page-locked
    memory, copied without blocking on its own stream, divided by 256
    there) equal the numpy batches of ``device_put=False`` bit for bit."""
    from stereomatching_tpu_torch.data import BatchLoader

    ds = _png_dataset(tmp_path, 9, (33, 65), 50)
    host = list(BatchLoader(ds, device_put=False, **kw))
    loader = BatchLoader(ds, device=cuda_device, **kw)
    got = list(loader)
    _assert_batches_equal(got, host)
    assert 1 <= loader._pool.allocated <= len(got)
    assert all(buf.is_pinned() for free in loader._pool._free.values() for buf, _ in free)


@pytest.mark.cuda
def test_batch_loader_on_a_card_mesh_stages_each_block(cuda_device, tmp_path):
    """With a mesh the loader yields sharded planes: each block staged in a
    page-locked buffer of its own and copied on its device's copy stream,
    on its own device (every visible GPU where there are several), its
    shards equal to the numpy batch's slices, and the batch fed to the
    sharded matcher as it is."""
    from stereomatching_tpu_torch.data import BatchLoader
    from stereomatching_tpu_torch.parallel import Sharded, make_mesh
    from stereomatching_tpu_torch.serving import Matcher

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n)] if n > 1 else [cuda_device] * 4
    mesh = make_mesh(data=1, rows=len(devices), devices=devices)
    ds = _png_dataset(tmp_path, 6, (8 * len(devices), 64), 52)
    host = list(BatchLoader(ds, 3, device_put=False))
    loader = BatchLoader(ds, 3, mesh=mesh)
    got = list(loader)
    assert [k for *_, k in got] == [k for *_, k in host]
    assert loader._pool.allocated >= len(mesh.blocks[2])
    params = StereoParams(square_width=5, times=3, num_shifts=6, edge_rule="exact")
    for (lb, rb, _), (hl, hr, _) in zip(got, host):
        for x, h in ((lb, hl), (rb, hr)):
            assert isinstance(x, Sharded) and x.dtype == torch.float32
            assert [b.device for b in x.blocks] == [
                torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
                for d, _ in mesh.blocks[2]]
            for index, t in x.addressable_shards:
                assert torch.equal(t.cpu(), torch.from_numpy(h[index])), index
        want = Matcher(params, device=cuda_device)(hl, hr)
        arts = Matcher(params, mesh=mesh)(lb, rb)
        assert all(np.array_equal(arts[k], want[k]) for k in want)


@pytest.mark.cuda
def test_batch_loader_reuses_a_host_buffer_only_after_its_copy(cuda_device, tmp_path):
    """With each copy queued behind a long sleep on the copy stream, one
    worker must wait for a buffer's copy before writing the next batch
    into it, and the consumer's stream must wait for the copy: every batch
    still equals its numpy batch, through one page-locked buffer."""
    from stereomatching_tpu_torch.data import BatchLoader

    class SlowCopies(BatchLoader):
        def _upload(self, lefts, rights):
            with torch.cuda.stream(self._copy_streams[self.device]):
                torch.cuda._sleep(50_000_000)
            return super()._upload(lefts, rights)

    ds = _png_dataset(tmp_path, 10, (64, 96), 51)
    host = list(BatchLoader(ds, 2, device_put=False))
    loader = SlowCopies(ds, 2, device=cuda_device, num_threads=1, prefetch=1)
    got = [(lb.clone(), rb.clone(), kept) for lb, rb, kept in loader]
    _assert_batches_equal(got, host)
    assert loader._pool.allocated == 1 and len(got) == 5
