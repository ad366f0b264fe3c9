"""The PyTorch port's SGM ops and the plain versions of its four SGM
kernels (K3 ``sgm_volume``, K4 ``sgm_directional`` with its diagonal
paths, K5 ``sgm_tail``, K6 ``fill_invalid``), held bitwise against the JAX
package's XLA tier on the same inputs.  Tolerance 0 on every plane, the
float ones (sub-pixel, filled) included: both sides run the same op order
with IEEE division.  K3's volume is also held against the scan-major
volume kernel (Pallas, interpret mode) at one tiny shape.

Inputs are made with numpy from a seed, at small odd shapes (16-48 rows,
24-96 columns, D in {8, 11, 32}).  The port's ops take leading batch
dims; they are checked against the JAX op image by image.  On CPU
tensors every wrapper runs its plain version and launches no kernel;
the kernels themselves are held against these plain versions on the
card in ``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu.ops import costvolume as j_cv
from stereomatching_tpu.ops import sgm as j_sgm
from stereomatching_tpu.ops.fused_sgm import sgm_volume_vmajor_pallas
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.ops import costvolume, fused_diffusion, fused_sgm, sgm
from tests.test_torch_fill import special_disparities
from tests.util import synthetic_pair


def pixels(n=2, h=17, w=29):
    """-> (left, right) int32 [n, h, w] pixel planes of synthetic pairs."""
    pairs = [synthetic_pair(h, w, seed=s) for s in range(n)]
    return (np.stack([a for a, _ in pairs]).astype(np.int32),
            np.stack([b for _, b in pairs]).astype(np.int32))


def cost_volume(shape, d, hi=30, seed=0):
    """Random int32 cost volume [*shape, d] in [0, hi): small range, so
    argmin ties and flat parabolas occur."""
    return np.random.default_rng(seed).integers(0, hi, (*shape, d)).astype(np.int32)


def assert_same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(got, ref)


def per_image(jfn, *arrays):
    """Stack ``jfn`` over the leading axis of numpy ``arrays``."""
    return np.stack([np.asarray(jfn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(arrays[0].shape[0])])


def batched(jfn, *arrays):
    """``jfn`` jitted and mapped over the leading axis of numpy ``arrays``
    (one compile for the batch: the scans of the 8-path sum are slow to
    trace image by image)."""
    return np.asarray(jax.jit(jax.vmap(jfn))(*(jnp.asarray(a) for a in arrays)))


# ------------------------------------------------------ ops/costvolume.py


@pytest.mark.parametrize("window", [3, 5])
def test_census_transform(window):
    left, _ = pixels()
    assert_same(costvolume.census_transform(torch.from_numpy(left), window),
                per_image(lambda x: j_cv.census_transform(x, window), left))
    with pytest.raises(ValueError):
        costvolume.census_transform(torch.from_numpy(left), 7)


def test_popcount32_and_extend_left():
    v = np.random.default_rng(1).integers(-2**31, 2**31, (5, 37), dtype=np.int64).astype(np.int32)
    v[0, :4] = [0, -1, 2**31 - 1, -2**31]
    assert_same(costvolume.popcount32(torch.from_numpy(v)),
                np.asarray(j_cv.popcount32(jnp.asarray(v))))
    left, _ = pixels()
    assert_same(costvolume._extend_left(torch.from_numpy(left), 11),
                per_image(lambda x: j_cv._extend_left(x, 11), left))


@pytest.mark.parametrize("num_disparities", [None, 11])
def test_lr_consistency(num_disparities):
    rng = np.random.default_rng(2)
    dl = rng.integers(0, 11, (2, 17, 29)).astype(np.int32)
    dr = rng.integers(0, 11, (2, 17, 29)).astype(np.int32)
    dr[:, :, ::3] = dl[:, :, ::3]
    got = costvolume.lr_consistency(torch.from_numpy(dl), torch.from_numpy(dr), 1,
                                    num_disparities)
    ref = per_image(lambda a, b: j_cv.lr_consistency(a, b, 1, num_disparities), dl, dr)
    assert_same(got, ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_median3x3(dtype):
    x = np.random.default_rng(3).integers(0, 40, (2, 17, 29)).astype(dtype)
    if dtype == np.float32:
        x += np.random.default_rng(4).random(x.shape).astype(np.float32)
    assert_same(costvolume.median3x3(torch.from_numpy(x)), per_image(j_cv.median3x3, x))


def test_fill_background():
    rng = np.random.default_rng(5)
    d = (rng.random((2, 17, 29)) * 20).astype(np.float32)
    v = rng.random((2, 17, 29)) < 0.4
    v[0, 3] = False  # a row with no valid pixel stays 0
    v[1, 4, :-1] = False  # valid only at the last column
    got = costvolume.fill_background(torch.from_numpy(d), torch.from_numpy(v))
    assert_same(got, per_image(j_cv.fill_background, d, v))
    assert not got[0, 3].any()


def assert_same_bits(port: torch.Tensor, ref) -> None:
    """float32 planes equal as int32 bits, and NaN at the same cells.  A
    NaN's sign is not compared: where two NaNs meet in a sum, x86 keeps
    the first operand's, and the XLA and torch programs order the
    operands of the neighbour sum differently."""
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got.view(np.int32)[~nan], ref.view(np.int32)[~nan])


@pytest.mark.parametrize("iterations", [0, 1, 3, 16])
def test_fill_invalid_plain_matches_jax(iterations):
    """K6's plain version (the wrapper on CPU tensors) and the costvolume
    op both equal the JAX XLA fill, float bits included; with negative,
    -0.0, +-inf and NaN disparities too (``special_disparities``),
    compared as int32 bits (``assert_same_bits``)."""
    rng = np.random.default_rng(6)
    d = (rng.random((2, 17, 29)) * 30).astype(np.float32)
    v = rng.random((2, 17, 29)) < 0.3
    ref = per_image(lambda a, b: j_cv.fill_invalid(a, b, iterations), d, v)
    before = fused_diffusion.fill_invalid.launches
    got = fused_diffusion.fill_invalid(torch.from_numpy(d), torch.from_numpy(v), iterations)
    assert fused_diffusion.fill_invalid.launches == before  # CPU: no launch
    assert_same(got, ref)
    assert_same(costvolume.fill_invalid(torch.from_numpy(d), torch.from_numpy(v), iterations), ref)
    single = fused_diffusion.fill_invalid(torch.from_numpy(d[1]), torch.from_numpy(v[1]), iterations)
    assert torch.equal(single, got[1])

    ds = special_disparities(d, v, rng)
    ref = per_image(lambda a, b: j_cv.fill_invalid(a, b, iterations), ds, v)
    if iterations:  # filled cells reach both hazards
        filled = ~v & (ref.view(np.int32) != ds.view(np.int32))
        assert (np.isnan(ref) & filled).any() and (np.signbit(ref) & (ref == 0) & filled).any()
    for port in (fused_diffusion.fill_invalid, costvolume.fill_invalid):
        assert_same_bits(port(torch.from_numpy(ds), torch.from_numpy(v), iterations), ref)


# ------------------------------------------------------ ops/sgm.py


def test_directional_and_argmin_tail():
    vol = cost_volume((2, 9, 13), 11)
    p1, p2 = 3, 20
    assert_same(sgm._directional(torch.from_numpy(vol), p1, p2),
                per_image(lambda v: j_sgm._directional(v, p1, p2), vol))
    t = torch.from_numpy(vol)
    disp, sub, cost = sgm.volume_argmin_subpixel(t)
    ref = [per_image(lambda v, k=k: j_sgm.volume_argmin_subpixel(v)[k], vol) for k in range(3)]
    for port, r in zip((disp, sub, cost), ref):
        assert_same(port, r)
    assert_same(sgm.right_disparity_from_left_volume(t),
                per_image(j_sgm.right_disparity_from_left_volume, vol))
    assert_same(sgm.second_best_outside_neighborhood(t, disp),
                per_image(j_sgm.second_best_outside_neighborhood, vol, ref[0]))


def test_second_best_all_excluded_keeps_sentinel():
    vol = cost_volume((1, 5, 6), 3)
    disp = np.ones((1, 5, 6), np.int32)
    got = sgm.second_best_outside_neighborhood(torch.from_numpy(vol), torch.from_numpy(disp))
    assert_same(got, per_image(j_sgm.second_best_outside_neighborhood, vol, disp))
    assert (got == 2**28).all()


@pytest.mark.parametrize("p1_p2", [(8, 96), (3, 20)])
def test_sgm_aggregate_four_paths(p1_p2):
    vol = cost_volume((2, 10, 13), 8, hi=25)
    got = sgm.sgm_aggregate(torch.from_numpy(vol), *p1_p2)
    assert_same(got, per_image(lambda v: j_sgm.sgm_aggregate(v, *p1_p2), vol))
    # 8 directions add the diagonal paths (once a later slice; now equal).
    assert_same(sgm.sgm_aggregate(torch.from_numpy(vol), *p1_p2, directions=8),
                batched(lambda v: j_sgm.sgm_aggregate(v, *p1_p2, directions=8), vol))
    with pytest.raises(ValueError):
        sgm.sgm_aggregate(torch.from_numpy(vol), 5, 4)
    with pytest.raises(ValueError):
        sgm.sgm_aggregate(torch.from_numpy(vol), *p1_p2, directions=6)


# Odd shapes for the diagonal line bookkeeping: H > W, H < W, W = 1, H = 1.
DIAG_SHAPES = [(2, 11, 5), (2, 6, 13), (1, 9, 1), (1, 1, 9), (1, 1, 1)]


@pytest.mark.parametrize("d", [8, 11])
@pytest.mark.parametrize("shape", DIAG_SHAPES)
def test_directional_diag_matches_jax(shape, d):
    vol = cost_volume(shape, d, seed=9)
    p1, p2 = 8, 96
    for dx in (1, -1):
        assert_same(sgm._directional_diag(torch.from_numpy(vol), p1, p2, dx),
                    batched(lambda v: j_sgm._directional_diag(v, p1, p2, dx), vol))


@pytest.mark.parametrize("shape_d", [((2, 11, 5), 11), ((1, 6, 13), 8), ((1, 9, 1), 8)])
def test_sgm_aggregate_eight_paths(shape_d):
    shape, d = shape_d
    vol = cost_volume(shape, d, hi=25, seed=10)
    assert_same(sgm.sgm_aggregate(torch.from_numpy(vol), 3, 20, directions=8),
                batched(lambda v: j_sgm.sgm_aggregate(v, 3, 20, directions=8), vol))


# ------------------------------------------------------ kernel wrappers on CPU


@pytest.mark.parametrize("cost_d_dtype", [("census", 32, torch.int8), ("sad", 11, torch.int16),
                                          ("census", 8, torch.int32), ("sad", 8, torch.int32)])
def test_sgm_volume_plain_matches_jax(cost_d_dtype):
    """K3's plain version against the JAX volume builder (_sgm_volume,
    hwd layout), every storage dtype the route picks."""
    cost, d, dtype = cost_d_dtype
    jp = JModernParams(num_disparities=d, aggregation="sgm", cost=cost)
    left, right = pixels()
    codes = [torch.from_numpy(x) for x in (left, right)]
    if cost == "census":
        codes = [costvolume.census_transform(c) for c in codes]
    before = fused_sgm.sgm_volume.launches
    got = fused_sgm.sgm_volume(*codes, d, cost, dtype)
    assert fused_sgm.sgm_volume.launches == before
    ref = per_image(lambda a, b: j_modern._sgm_volume(a, b, jp), left, right)
    assert got.dtype == dtype
    assert_same(got.to(torch.int32), ref)
    assert torch.equal(fused_sgm.sgm_volume(codes[0][0], codes[1][0], d, cost, dtype), got[0])
    with pytest.raises(ValueError):
        fused_sgm.sgm_volume(*codes, d, cost, torch.float32)


@pytest.mark.parametrize("out_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("vol_dtype", [torch.int8, torch.int16, torch.int32])
def test_sgm_directional_plain_matches_jax(vol_dtype, out_dtype):
    """K4's plain version: each path against the JAX package's flipped /
    transposed _directional, and the 4-launch sum against sgm_aggregate."""
    vol = cost_volume((2, 9, 14), 11, hi=25, seed=7)
    p1, p2 = 8, 96
    t = torch.from_numpy(vol).to(vol_dtype)
    agg = torch.full(t.shape, 7, dtype=out_dtype)
    jvol = jnp.asarray(vol)

    def jax_path(along_y, reverse):
        out = []
        for v in jvol:
            if along_y:
                v = jnp.swapaxes(v, 0, 1)
            if reverse:
                v = jnp.flip(v, axis=1)
            p = j_sgm._directional(v, p1, p2)
            if reverse:
                p = jnp.flip(p, axis=1)
            out.append(np.asarray(jnp.swapaxes(p, 0, 1) if along_y else p))
        return np.stack(out)

    before = fused_sgm.sgm_directional.launches
    total = np.zeros(vol.shape, np.int32)
    for i, (along_y, reverse) in enumerate(sgm.PATHS):
        ref = jax_path(along_y, reverse)
        total += ref
        got = fused_sgm.sgm_directional(t, agg, p1, p2, along_y, reverse, accumulate=i > 0)
        assert got is agg and agg.dtype == out_dtype
        assert_same(agg.to(torch.int32), total)
        assert_same(fused_sgm.sgm_directional_reference(t, p1, p2, along_y, reverse), ref)
    assert fused_sgm.sgm_directional.launches == before
    summed = fused_sgm.sgm_aggregate_paths(t, p1, p2, out_dtype)
    assert summed.dtype == out_dtype
    assert_same(summed.to(torch.int32), per_image(lambda v: j_sgm.sgm_aggregate(v, p1, p2), vol))


@functools.cache
def diagonal_refs():
    """A volume, the JAX package's four diagonal passes over it (keyed by
    the port's (direction, reverse); the bottom-to-top ones on the
    y-flipped volume, dx swapped) and its 8-path sum."""
    vol = cost_volume((2, 9, 14), 11, hi=25, seed=11)
    flip = functools.partial(jnp.flip, axis=0)
    jax_pass = {(sgm.DIAG_PLUS, False): lambda v: j_sgm._directional_diag(v, 8, 96, 1),
                (sgm.DIAG_MINUS, False): lambda v: j_sgm._directional_diag(v, 8, 96, -1),
                (sgm.DIAG_PLUS, True): lambda v: flip(j_sgm._directional_diag(flip(v), 8, 96, -1)),
                (sgm.DIAG_MINUS, True): lambda v: flip(j_sgm._directional_diag(flip(v), 8, 96, 1))}
    paths = {k: batched(fn, vol) for k, fn in jax_pass.items()}
    return vol, paths, batched(lambda v: j_sgm.sgm_aggregate(v, 8, 96, directions=8), vol)


@pytest.mark.parametrize("out_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("vol_dtype", [torch.int8, torch.int16, torch.int32])
def test_sgm_diagonal_paths_plain_match_jax(vol_dtype, out_dtype):
    """K4's plain version on the diagonals: each path against the JAX
    package's (y-flipped) _directional_diag, added into the aggregate,
    and the 8-launch sum against sgm_aggregate(directions=8)."""
    vol, jax_paths, jax_sum = diagonal_refs()
    p1, p2 = 8, 96
    t = torch.from_numpy(vol).to(vol_dtype)
    agg = torch.full(t.shape, 3, dtype=out_dtype)
    total = np.full(vol.shape, 3, np.int32)
    before = fused_sgm.sgm_directional.launches
    for direction, reverse in sgm.DIAG_PATHS:
        ref = jax_paths[direction, reverse]
        total += ref
        fused_sgm.sgm_directional(t, agg, p1, p2, direction, reverse, accumulate=True)
        assert_same(agg.to(torch.int32), total)
        assert_same(fused_sgm.sgm_directional_reference(t, p1, p2, direction, reverse), ref)
    assert fused_sgm.sgm_directional.launches == before
    summed = fused_sgm.sgm_aggregate_paths(t, p1, p2, out_dtype, directions=8)
    assert summed.dtype == out_dtype
    assert_same(summed.to(torch.int32), jax_sum)
    with pytest.raises(ValueError):
        fused_sgm.sgm_aggregate_paths(t, p1, p2, out_dtype, directions=6)
    with pytest.raises(ValueError):
        fused_sgm.sgm_directional(t, agg, p1, p2, 4, False, False)


@pytest.mark.parametrize("cost_dtype", [("census", torch.int8), ("sad", torch.int16)])
def test_sgm_volume_matches_scan_major_volume(cost_dtype):
    """The counterpart of the scan-major kernel (sgm_volume_vmajor_pallas,
    the 8-direction route's volume on the TPU): K3's volume [B, H, W, D],
    permuted to [H, D, B*W], holds the same values."""
    cost, dtype = cost_dtype
    rng = np.random.default_rng(12)
    codes = [torch.from_numpy(rng.integers(0, 256, (2, 5, 128)).astype(np.int32))
             for _ in range(2)]
    if cost == "census":
        codes = [costvolume.census_transform(c) for c in codes]
    got = fused_sgm.sgm_volume_reference(*codes, 8, cost, dtype)
    b, h, w, d = got.shape
    got = got.permute(1, 3, 0, 2).reshape(h, d, b * w)
    ref = sgm_volume_vmajor_pallas(*(jnp.asarray(c.numpy()) for c in codes), 8, cost=cost,
                                   dtype=jnp.int8 if dtype == torch.int8 else jnp.int16,
                                   interpret=True)
    assert_same(got, ref)


@pytest.mark.parametrize("with_uniqueness", [False, True])
@pytest.mark.parametrize("agg_dtype", [torch.int16, torch.int32])
def test_sgm_tail_plain_matches_jax(agg_dtype, with_uniqueness):
    """K5's plain version against the JAX tail functions (argmin +
    sub-pixel + cost, right view, second best), float bits included."""
    vol = cost_volume((2, 11, 23), 11, hi=40, seed=8)
    t = torch.from_numpy(vol).to(agg_dtype)
    before = fused_sgm.sgm_tail.launches
    outs = fused_sgm.sgm_tail(t, with_uniqueness)
    assert fused_sgm.sgm_tail.launches == before
    assert len(outs) == 4 + with_uniqueness
    j_disp = per_image(lambda v: j_sgm.volume_argmin_subpixel(v)[0], vol)
    refs = [
        j_disp,
        per_image(lambda v: j_sgm.volume_argmin_subpixel(v)[1], vol),
        per_image(lambda v: j_sgm.volume_argmin_subpixel(v)[2], vol),
        per_image(j_sgm.right_disparity_from_left_volume, vol),
        per_image(j_sgm.second_best_outside_neighborhood, vol, j_disp),
    ]
    for port, ref in zip(outs, refs):
        assert_same(port, ref)
    assert (outs[1] != outs[0].float()).any()  # some sub-pixel offsets
    single = fused_sgm.sgm_tail(t[1], with_uniqueness)
    for a, b in zip(single, outs):
        assert torch.equal(a, b[1])


@pytest.mark.parametrize("dtype, w, d, want", [
    (torch.int16, 1024, 64, "segments"), (torch.int16, 1024, 256, "segments"),
    (torch.int16, 1024, 257, "segments"), (torch.int16, 1024, 512, "wide"),
    (torch.int16, 100, 512, "segments"), (torch.int16, 1, 513, "wide"),
    (torch.int32, 1024, 64, "segments"), (torch.int32, 1024, 256, "wide"),
    (torch.int32, 226, 256, "segments"), (torch.int32, 227, 256, "wide"),
    (torch.int32, 1, 257, "wide"), (torch.int16, 1, 1, "segments"),
])
def test_k5_route_at_its_edges(dtype, w, d, want):
    """K5's route from (dtype, D, W) alone: the segments while a lane holds
    a pixel's run in at most 8 words (D 512 at int16, 256 at int32) and a
    segment fits a block's 232448 bytes (int32, D=256: W up to 226)."""
    assert fused_sgm.k5_route((2, 3, w, d), dtype) == want
    assert fused_sgm.k5_route((3, w, d), dtype) == want  # batch dims do not count


def test_k5_mirrors_at_known_shapes():
    """K5's lane words and shared memory at the shapes the route rule is
    read from (my arithmetic: the segment's pixels x D x bytes, whole
    16-byte chunks, one chunk of slack)."""
    assert [fused_sgm.k5_lane_words(2, d) for d in (1, 64, 65, 128, 129, 256, 512, 513)] == [
        1, 1, 2, 2, 4, 4, 8, 16]
    assert fused_sgm.k5_smem_bytes(2, 64, 1024) == 191 * 128 + 16
    assert fused_sgm.k5_smem_bytes(2, 37, 45) == -(-45 * 74 // 16) * 16 + 16


def test_wrappers_refuse_other_devices_and_bad_inputs():
    meta = torch.empty((1, 8, 8, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        fused_sgm.sgm_tail(meta)
    with pytest.raises(ValueError):
        fused_sgm.sgm_directional(meta, meta, 8, 96, False, False, False)
    with pytest.raises(ValueError):
        fused_sgm.sgm_volume(meta[..., 0].int(), meta[..., 0].int(), 4)
    with pytest.raises(ValueError):
        fused_diffusion.fill_invalid(meta[..., 0].float(), meta[..., 0].bool(), 2)
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int16)
    with pytest.raises(ValueError):
        fused_sgm.sgm_tail(x.to(torch.int8))  # the aggregate is int16 or int32
    with pytest.raises(ValueError):
        fused_sgm.sgm_directional(x, x[..., :3], 8, 96, False, False, False)


def test_storage_gates_match_jax():
    """The dtype gates pick the JAX package's storage for each route."""
    for kw in (dict(cost="census"), dict(cost="sad"), dict(cost="census", sgm_p2=16384),
               dict(cost="census", num_disparities=48), dict(cost="sad", sgm_p2=9000)):
        jp = JModernParams(aggregation="sgm", **kw)
        p = params_from_jax(jp)
        assert modern._sgm_cost_bound(p) == j_modern._sgm_cost_bound(jp)
        assert str(modern._sgm_storage_dtype(p)).split(".")[-1] == \
            jnp.dtype(j_modern._sgm_storage_dtype(jp)).name
        assert str(modern._sgm_out_dtype(p)).split(".")[-1] == \
            jnp.dtype(j_modern._sgm_out_dtype(jp)).name
