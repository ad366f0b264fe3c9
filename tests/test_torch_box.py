"""The PyTorch port's box route (``aggregation="box"``, the modern
pipeline's default) held bitwise against the JAX package's XLA tier on
the same inputs: the windowed-disparity helpers of ``ops/costvolume.py``,
the plain version of K7 (``fused_modern.disparity_reference``, and the
wrapper on CPU tensors), ``disparity_one_view``, ``modern_forward`` /
``modern_forward_reference`` and ``ModernMatcher`` with its default
params.  Tolerance 0 on every plane, the float sub-pixel and filled
planes included.

Inputs are made with numpy from a seed at small shapes (about 24x40,
D <= 16, and D = 64 for the default params); params are built in the JAX
package and carried across with ``interop.params_from_jax``.  K7 itself
is held against its plain version on the card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu.ops import costvolume as j_cv
from stereomatching_tpu.serving import ModernMatcher as JModernMatcher
from stereomatching_tpu_torch.config import ModernParams
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.ops import costvolume, fused_diffusion, fused_modern
from stereomatching_tpu_torch.parallel import make_mesh, sharded_modern_forward
from stereomatching_tpu_torch.serving import ModernMatcher
from tests.util import synthetic_pair


def pixel_batch(n, h, w, seed=0):
    """-> (left, right) uint8 [n, h, w] synthetic pairs."""
    pairs = [synthetic_pair(h, w, seed=seed + s, max_shift=6) for s in range(n)]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def assert_same(port, ref) -> None:
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(got, ref)


def assert_result_same(port, ref) -> None:
    for a, b in zip(port, ref):
        assert_same(a, b)


def assert_outputs_equal(port, ref) -> None:
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert_same(port[k], ref[k])


def jax_forward(jp, left, right):
    """The JAX XLA tier, jitted (batched via vmap for [B, H, W])."""
    fn = j_modern.build_modern_pipeline(jp, batched=left.ndim == 3)
    return jax.device_get(fn(jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32)))


def test_extend_right_and_zero_padded_aggregate():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (17, 29)).astype(np.int32)
    assert_same(costvolume._extend_right(torch.from_numpy(x), 7),
                j_cv._extend_right(jnp.asarray(x), 7))
    for half in (0, 1, 4, 9):
        assert_same(costvolume._aggregate(torch.from_numpy(x), half),
                    j_cv._aggregate(jnp.asarray(x), half))


def direct_reading(costs):
    """The argmin that K7's strips read off their keys, from a cost stack
    [D, ...]: the first d of minimum cost, the costs at d - 1 and d + 1
    (2^30 past either end), then the parabola in argmin_subpixel_scan's
    float32 op order -> (disparity, subpixel, cost)."""
    big = np.int32(1 << 30)
    d = costs.shape[0]
    best_d = np.argmin(costs, axis=0)  # numpy's argmin takes the first minimum
    take = lambda i: np.take_along_axis(costs, i[None], axis=0)[0]  # noqa: E731
    best = take(best_d)
    c_left = np.where(best_d > 0, take(np.maximum(best_d - 1, 0)), big)
    c_right = np.where(best_d < d - 1, take(np.minimum(best_d + 1, d - 1)), big)
    cl, cm, cr = (torch.from_numpy(x.astype(np.float32)) for x in (c_left, best, c_right))
    denom = cl - 2.0 * cm + cr
    valid = torch.from_numpy((c_left < big) & (c_right < big)) & (denom > 0)
    offset = torch.where(valid, (cl - cr) / torch.where(valid, 2.0 * denom, 1.0), 0.0)
    offset = offset.clamp(-0.5, 0.5)
    bd = torch.from_numpy(best_d.astype(np.int32))
    return bd, bd.to(torch.float32) + offset, torch.from_numpy(best.astype(np.int32))


@pytest.mark.parametrize("d", [1, 2, 5, 33, 64])
def test_argmin_scan_equals_the_direct_reading(d):
    """argmin_subpixel_scan's carries end as the first minimum d*, C[d* - 1]
    and C[d* + 1] (2^30 at the ends), which K7's strips read directly off
    their per-pixel keys: the port's and the JAX scan's three planes equal
    that reading's, bit for bit, on random stacks and tie-heavy ones (costs
    0..3, plateaus, an all-equal pixel, a minimum only at D - 1, one only at
    0)."""
    rng = np.random.default_rng(d)
    random = rng.integers(0, 1 << 20, (d, 3, 5))
    ties = rng.integers(0, 4, (d, 3, 5))
    ties[:, 0, 0] = 7  # all equal: d* = 0
    ties[:, 0, 1] = np.arange(d, 0, -1)  # falling: the minimum only at D - 1
    ties[:, 0, 2] = np.arange(d)  # rising: the minimum only at 0
    ties[:, 0, 3] = 5
    ties[d // 2:, 0, 3] = 2  # a plateau from D / 2 to the end
    for costs in (random.astype(np.int32), ties.astype(np.int32)):
        want = direct_reading(costs)
        got = costvolume.argmin_subpixel_scan(lambda i: torch.from_numpy(costs[i]), d)
        jcosts = jnp.asarray(costs)
        jgot = jax.device_get(j_cv.argmin_subpixel_scan(lambda i: jcosts[i], d, (3, 5)))
        for ours, theirs, ref in zip(got, jgot, want):
            assert_same(ours, ref.numpy())
            assert_same(theirs, ref.numpy())


@pytest.mark.parametrize("window", [1, 9, 15])
@pytest.mark.parametrize("reference", ["left", "right"])
def test_sad_disparity_matches_jax(reference, window):
    left, right = pixel_batch(2, 24, 40)
    d = 11
    got = costvolume.sad_disparity(torch.from_numpy(left), torch.from_numpy(right), d,
                                   window, reference)
    for i in range(2):
        ref = j_cv.sad_disparity(jnp.asarray(left[i]), jnp.asarray(right[i]), d, window,
                                 reference)
        assert_result_same([g[i] for g in got], ref)
    with pytest.raises(ValueError):
        costvolume.sad_disparity(torch.from_numpy(left), torch.from_numpy(right), d,
                                 window, "middle")


@pytest.mark.parametrize("window", [1, 9, 15])
@pytest.mark.parametrize("cost", ["sad", "census"])
def test_disparity_plain_matches_jax_one_view(cost, window):
    """K7's plain version, the CPU wrapper and the port's
    disparity_one_view against the JAX disparity_one_view (XLA) for
    both reference views; the SAD case also against sad_disparity."""
    jp = JModernParams(num_disparities=13, window=window, cost=cost)
    params = params_from_jax(jp)
    left, right = pixel_batch(1, 24, 40, seed=3)
    lt, rt = (torch.from_numpy(x[0]) for x in (left, right))
    codes = [x.to(torch.int32) for x in (lt, rt)]
    if cost == "census":
        codes = [costvolume.census_transform(x) for x in codes]
    for reference in ("left", "right"):
        ref = jax.device_get(j_modern.disparity_one_view(
            jnp.asarray(left[0]), jnp.asarray(right[0]), jp, reference))
        ref_codes, other_codes = codes if reference == "left" else codes[::-1]
        before = fused_modern.disparity.launches
        assert_result_same(fused_modern.disparity(ref_codes, other_codes, params, reference), ref)
        assert fused_modern.disparity.launches == before  # CPU: no launch
        assert_result_same(fused_modern.disparity_reference(ref_codes, other_codes, params,
                                                            reference), ref)
        assert_result_same(modern.disparity_one_view(lt, rt, params, reference), ref)
        if cost == "sad":
            assert_result_same(costvolume.sad_disparity(lt, rt, 13, window, reference), ref)


# (name, ModernParams fields, batch shape)
CASES = [
    ("sad", dict(num_disparities=16), (2, 24, 40)),
    ("census-median", dict(num_disparities=11, cost="census", window=5, median_filter=True),
     (2, 24, 40)),
    ("sad-background-exact-lr", dict(num_disparities=8, window=7, fill_mode="background",
                                     lr_max_diff=0), (2, 17, 29)),
    ("census3-fill4", dict(num_disparities=12, cost="census", census_window=3, window=3,
                           fill_iterations=4), (1, 31, 47)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_box_forward_batched_matches_jax(case):
    _, kw, shape = case
    jp = JModernParams(**kw)
    params = params_from_jax(jp)
    lu, ru = pixel_batch(*shape)
    ref = jax_forward(jp, lu, ru)
    before = (fused_modern.disparity.launches, fused_diffusion.fill_invalid.launches)
    assert_outputs_equal(modern.modern_forward(torch.from_numpy(lu), torch.from_numpy(ru),
                                               params), ref)
    assert before == (fused_modern.disparity.launches, fused_diffusion.fill_invalid.launches)
    assert_outputs_equal(modern.modern_forward_reference(torch.from_numpy(lu),
                                                         torch.from_numpy(ru), params), ref)
    assert "uniqueness" not in ref
    assert 0.2 < ref["valid"].mean() <= 1.0


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=[CASES[0][0], CASES[1][0]])
def test_box_forward_single_pair_matches_jax(case):
    _, kw, shape = case
    jp = JModernParams(**kw)
    lu, ru = pixel_batch(1, *shape[1:], seed=5)
    ref = jax_forward(jp, lu[0], ru[0])
    for fn in (modern.modern_forward, modern.modern_forward_reference):
        assert_outputs_equal(fn(torch.from_numpy(lu[0]), torch.from_numpy(ru[0]),
                                params_from_jax(jp)), ref)


def test_modern_matcher_default_is_the_box_route():
    """ModernMatcher() with no params runs ModernParams() (SAD, window 9,
    D=64), as the JAX ModernMatcher does, and gives its XLA tier's
    planes."""
    m = ModernMatcher(device="cpu")
    assert m.params == ModernParams() == params_from_jax(JModernParams())
    assert m.params.aggregation == "box" and m.params.num_disparities == 64
    lu, ru = pixel_batch(2, 24, 40, seed=7)
    out = m(lu, ru)
    assert_outputs_equal(out, JModernMatcher(tier="xla")(lu, ru))
    single = m(lu[1], ru[1])
    for k, v in out.items():
        assert np.array_equal(single[k], v[1]), k


@pytest.mark.parametrize("bad", [256, -1])
@pytest.mark.parametrize("entry", ["forward", "one_view", "matcher", "sharded"])
def test_box_sad_refuses_pixels_outside_0_255(entry, bad):
    """K7 matches SAD intensities as bytes, so the box route with SAD at
    scales=1 refuses wider integer planes holding a value outside 0..255,
    on every device alike; in-range int16 planes give the uint8 planes'
    results, and census or the SGM route take such planes as before."""
    lu, ru = pixel_batch(1, 12, 20, seed=5)
    params = ModernParams(num_disparities=8)
    wide = lu.astype(np.int16)
    wide[0, 3, 4] = bad

    def run(p, left):
        if entry == "matcher":
            return ModernMatcher(p, device="cpu")(left, ru)
        lt, rt = torch.from_numpy(left), torch.from_numpy(ru)
        if entry == "one_view":
            return modern.disparity_one_view(lt, rt, p)._asdict()
        if entry == "sharded":
            mesh = make_mesh(data=1, rows=1, devices=["cpu"])
            return sharded_modern_forward(lt, rt, p, mesh)
        return modern.modern_forward(lt, rt, p)

    with pytest.raises(ValueError, match="0..255"):
        run(params, wide)
    want = run(params, lu)
    for k, v in run(params, lu.astype(np.int16)).items():
        assert np.array_equal(np.asarray(v), np.asarray(want[k])), k
    run(ModernParams(num_disparities=8, cost="census"), wide)
    run(ModernParams(num_disparities=8, aggregation="sgm"), wide)
