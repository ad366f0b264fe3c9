"""The PyTorch port's multi-scale cost fusion (``scales=2``) held bitwise
against the JAX package's XLA tier (``build_modern_pipeline``, jitted) on
every output plane, float planes included (tolerance 0): the box route
(SAD and census) and the SGM route (census 4-path, SAD 8-path), and the
SGM storage bound's coarse SAD term (fault F2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.ops import costvolume
from tests.test_torch_modern import assert_outputs_equal, pixel_batch

# (name, JAX ModernParams fields, batch shape)
CASES = [
    ("box-sad", dict(cost="sad", num_disparities=11, window=5), (2, 24, 40)),
    ("box-census-odd", dict(cost="census", num_disparities=8, window=3, coarse_weight=2,
                            median_filter=True), (2, 17, 29)),
    ("sgm-census-4", dict(aggregation="sgm", cost="census", num_disparities=16),
     (2, 24, 40)),
    ("sgm-sad-8", dict(aggregation="sgm", cost="sad", num_disparities=11, sgm_directions=8,
                       uniqueness=True), (1, 19, 33)),
]


def jax_forward(jp, left, right):
    fn = j_modern.build_modern_pipeline(jp, batched=True)
    return jax.device_get(fn(jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32)))


@pytest.mark.parametrize("name,kw,shape", CASES, ids=[c[0] for c in CASES])
def test_scales2_matches_jax(name, kw, shape):
    jp = JModernParams(scales=2, **kw)
    lu, ru = pixel_batch(*shape)
    port = modern.modern_forward(torch.from_numpy(lu), torch.from_numpy(ru),
                                 params_from_jax(jp))
    assert_outputs_equal(port, jax_forward(jp, lu, ru))


def test_scales2_sad_bound_holds_the_coarse_sum():
    """F2: the coarse SAD cost is a difference of 2x2 sums, up to 4·255.
    With coarse_weight 4 and 8 paths a pair whose every cost is at that
    ceiling sums to 8 x (255 + 4·1020) = 34680 per d, above int16; the
    bound must pick an int32 aggregate, or the sum wraps (the plain route
    casts to the same dtypes as the kernels, so only the JAX comparison
    shows it)."""
    jp = JModernParams(aggregation="sgm", cost="sad", scales=2, coarse_weight=4,
                       sgm_directions=8, num_disparities=8)
    p = params_from_jax(jp)
    assert modern._sgm_cost_bound(p) == 255 + 4 * 4 * 255
    assert modern._sgm_storage_dtype(p) == torch.int16
    assert modern._sgm_out_dtype(p) == torch.int32
    census = params_from_jax(JModernParams(aggregation="sgm", cost="census", scales=2,
                                           coarse_weight=4))
    assert modern._sgm_cost_bound(census) == 24 * 5
    h, w = 16, 24
    left = np.full((1, h, w), 255, np.uint8)
    right = np.zeros((1, h, w), np.uint8)
    left[0, :, ::5] = 0  # some structure, so the paths differ
    right[0, 3:9, 2:7] = 200
    port = modern.modern_forward(torch.from_numpy(left), torch.from_numpy(right), p)
    ref = jax_forward(jp, left, right)
    assert int(ref["cost"].max()) > 2**15  # the case reaches past int16
    assert_outputs_equal(port, ref)


def test_downsample_upsample_match_jax():
    rng = np.random.default_rng(3)
    for h, w in ((6, 8), (5, 7), (1, 3)):
        x = rng.integers(0, 256, (h, w)).astype(np.int32)
        got = modern._downsample2(torch.from_numpy(x)).numpy()
        want = np.asarray(j_modern._downsample2(jnp.asarray(x)))
        assert np.array_equal(got, want)
        up = costvolume.upsample2(torch.from_numpy(got), h, w).numpy()
        assert np.array_equal(up, np.asarray(j_modern._upsample2(jnp.asarray(want), h, w)))
    batch = rng.integers(0, 256, (2, 5, 7)).astype(np.int32)
    for i in range(2):
        assert np.array_equal(modern._downsample2(torch.from_numpy(batch))[i].numpy(),
                              np.asarray(j_modern._downsample2(jnp.asarray(batch[i]))))
