"""The PyTorch port's modern pipeline (SGM route, 4 and 8 paths) as a whole:
``modern_forward``, ``ModernPipeline`` and ``ModernMatcher`` held bitwise
against the JAX package's XLA tier (``modern_forward(use_pallas=False)``,
jitted) on every output key, float planes included (tolerance 0).

The matrix covers census and SAD costs, 4 and 8 paths, single pairs and
batches, ``median_filter``, ``uniqueness``, both fill modes, and each
storage route: an int8 volume (census, D=32), int16 (SAD) and int32 (a
large ``sgm_p2``).  The box route has its own file, ``test_torch_box.py``.  Params are built in the JAX package and carried across
with ``interop.params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.ops import fused_diffusion, fused_sgm
from stereomatching_tpu_torch.serving import ModernMatcher
from tests.util import synthetic_pair

# (name, ModernParams fields, batch shape, volume dtype, aggregate dtype)
CASES = [
    ("census-int8", dict(cost="census", num_disparities=32), (2, 24, 40),
     torch.int8, torch.int16),
    ("sad-int16-uniq-median", dict(cost="sad", num_disparities=11, uniqueness=True,
                                   median_filter=True), (2, 17, 29), torch.int16, torch.int16),
    ("census-int32-background", dict(cost="census", num_disparities=8, sgm_p2=20000,
                                     census_window=3, fill_mode="background"),
     (1, 16, 24), torch.int32, torch.int32),
    ("census-uniq-fill4", dict(cost="census", num_disparities=11, uniqueness=True,
                               fill_iterations=4, lr_max_diff=0), (2, 31, 47),
     torch.int16, torch.int16),
    ("sad-median-background", dict(cost="sad", num_disparities=8, median_filter=True,
                                   fill_mode="background", sgm_p1=3, sgm_p2=20),
     (2, 48, 96), torch.int16, torch.int16),
    # The 8-direction quality stack, one per storage route.
    ("8dir-census-int8-uniq-median", dict(cost="census", num_disparities=32, sgm_directions=8,
                                          uniqueness=True, median_filter=True),
     (2, 24, 40), torch.int8, torch.int16),
    ("8dir-sad-int16-uniq", dict(cost="sad", num_disparities=11, sgm_directions=8,
                                 uniqueness=True), (2, 17, 29), torch.int16, torch.int16),
    ("8dir-census-int32-uniq-median", dict(cost="census", num_disparities=8, sgm_p2=20000,
                                           sgm_directions=8, uniqueness=True,
                                           median_filter=True, census_window=3),
     (1, 16, 24), torch.int32, torch.int32),
]


def jax_params(**kw):
    return JModernParams(aggregation="sgm", **kw)


def pixel_batch(n, h, w):
    """-> (left, right) uint8 [n, h, w] synthetic pairs."""
    pairs = [synthetic_pair(h, w, seed=s, max_shift=6) for s in range(n)]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def jax_forward(jp, left, right):
    """The JAX XLA tier, jitted (batched via vmap for [B, H, W])."""
    fn = j_modern.build_modern_pipeline(jp, batched=left.ndim == 3)
    return jax.device_get(fn(jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32)))


def assert_outputs_equal(port, ref):
    port = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in port.items()}
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert port[k].dtype == v.dtype, (k, port[k].dtype, v.dtype)
        assert port[k].shape == v.shape, k
        assert np.array_equal(port[k], v), k


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_modern_forward_batched_matches_jax(case):
    _, kw, shape, vol_dtype, agg_dtype = case
    jp = jax_params(**kw)
    params = params_from_jax(jp)
    assert modern._sgm_storage_dtype(params) == vol_dtype
    assert modern._sgm_out_dtype(params) == agg_dtype
    lu, ru = pixel_batch(*shape)
    launches = (fused_sgm.sgm_volume.launches, fused_sgm.sgm_directional.launches,
                fused_sgm.sgm_tail.launches, fused_diffusion.fill_invalid.launches)
    port = modern.modern_forward(torch.from_numpy(lu), torch.from_numpy(ru), params)
    ref = jax_forward(jp, lu, ru)
    assert_outputs_equal(port, ref)
    # CPU tensors take the kernels' plain versions: no launch, and the
    # same bits as the plain route with the int32 aggregate.
    assert launches == (fused_sgm.sgm_volume.launches, fused_sgm.sgm_directional.launches,
                        fused_sgm.sgm_tail.launches, fused_diffusion.fill_invalid.launches)
    plain = modern.modern_forward_reference(torch.from_numpy(lu), torch.from_numpy(ru), params)
    assert_outputs_equal(plain, ref)
    assert 0.2 < ref["valid"].mean() <= 1.0


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[5]],
                         ids=[CASES[0][0], CASES[1][0], CASES[5][0]])
def test_modern_forward_single_pair_matches_jax(case):
    _, kw, shape, _, _ = case
    jp = jax_params(**kw)
    lu, ru = pixel_batch(1, *shape[1:])
    port = modern.modern_forward(torch.from_numpy(lu[0]), torch.from_numpy(ru[0]),
                                 params_from_jax(jp))
    assert_outputs_equal(port, jax_forward(jp, lu[0], ru[0]))


def test_modern_matcher_cpu_matches_jax():
    jp = jax_params(cost="census", num_disparities=32, uniqueness=True)
    lu, ru = pixel_batch(3, 24, 40)
    m = ModernMatcher(params_from_jax(jp), device="cpu")
    out = m(lu, ru)
    assert_outputs_equal(out, jax_forward(jp, lu, ru))
    # A single pair, and the same pixels as other integer types / as
    # 0..255-scale floats, give the same planes.
    single = m(lu[2], ru[2])
    for k, v in out.items():
        assert np.array_equal(single[k], v[2]), k
    for alt in (lu.astype(np.int64), lu.astype(np.float32)):
        again = m(alt, ru)
        for k, v in out.items():
            assert np.array_equal(again[k], v), k
    with pytest.raises(ValueError, match="brightness"):
        m(lu / 256.0, ru / 256.0)
    with pytest.raises(ValueError):
        m(lu, ru[:, :, :32])
    with pytest.raises(ValueError):
        m(lu.astype(bool), ru.astype(bool))


def test_modern_pipeline_module_and_unported_routes():
    """The module form, and the routes: the box route, 8 paths and
    scales=2 on both routes, unported before, now run."""
    params = params_from_jax(jax_params(cost="sad", num_disparities=8))
    pipe = modern.build_modern_pipeline(params)
    assert isinstance(pipe, torch.nn.Module)
    assert list(pipe.parameters()) == []
    lu, ru = (torch.from_numpy(x) for x in pixel_batch(2, 16, 24))
    batched = pipe(lu, ru)
    single = pipe(lu[1], ru[1])
    for k in batched:
        assert torch.equal(batched[k][1], single[k]), k
    with pytest.raises(ValueError):
        pipe(lu.float(), ru.float())
    with pytest.raises(ValueError):
        pipe(lu, ru[:, :, :20])
    p = params_from_jax(JModernParams(aggregation="sgm", scales=2, num_disparities=8))
    assert torch.equal(modern.modern_forward(lu, ru, p)["disparity"],
                       modern.ModernPipeline(p)(lu, ru)["disparity"])
    for kw in (dict(aggregation="box", num_disparities=8),
               dict(aggregation="sgm", sgm_directions=8, num_disparities=8),
               dict(aggregation="box", scales=2, num_disparities=8),
               dict(aggregation="sgm", scales=2, num_disparities=8)):
        p = params_from_jax(JModernParams(**kw))
        out = modern.ModernPipeline(p)(lu, ru)
        assert sorted(out) == sorted(batched)
        assert out["disparity"].shape == lu.shape
        assert torch.equal(out["filled"][out["valid"]], out["subpixel"][out["valid"]])
