"""Data and counts of K6, the validity-aware fill, on the CPU: the
special disparities that the CPU and CUDA tests of the fill share, and
``utils/bench.k6_filled`` (the cells a call fills, which its bound is
charged for) against the plain version.  The file imports no jax, so
``tests/test_torch_cuda.py`` can import it on a GPU host."""

import numpy as np
import pytest
import torch

from stereomatching_tpu_torch.ops import fused_diffusion
from stereomatching_tpu_torch.utils.bench import (
    FP32_UNFUSED_OPS_PER_S, HBM_BYTES_PER_S, K6_FILL_OPS, k6_bound_ms, k6_filled)


def special_disparities(d, v, rng):
    """``d`` negated at its invalid cells, a tenth of them set to -0.0,
    +0.0, +-inf or NaN, and -0.0 at a third of its valid cells: an
    invalid in-image neighbour still adds d * 0 (-0.0 or NaN), and -0.0
    reaches the result where every term is -0.0."""
    d = np.where(v, d, -d)
    specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], np.float32)
    inv, val = np.argwhere(~v), np.argwhere(v)
    for k in rng.choice(len(inv), len(inv) // 10, replace=False):
        d[tuple(inv[k])] = specials[rng.integers(len(specials))]
    for k in rng.choice(len(val), len(val) // 3, replace=False):
        d[tuple(val[k])] = -0.0
    return d


@pytest.mark.parametrize("iterations", [0, 1, 2, 5, 16])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_k6_filled_counts_the_plain_versions_fills(iterations, density):
    """With d = 1 at valid cells and 0 elsewhere, every cell the plain
    version fills takes the mean 1 and every other invalid cell keeps 0,
    so its fills are its ones less the valid cells."""
    rng = np.random.default_rng(12)
    v = torch.from_numpy(rng.random((2, 23, 37)) < density)
    out = fused_diffusion.fill_invalid_reference(v.float(), v, iterations)
    want = int((out == 1).sum()) - int(v.sum())
    assert k6_filled(v, iterations) == want
    assert k6_filled(v[0], iterations) + k6_filled(v[1], iterations) == want


def test_k6_bound_charges_each_fill_once():
    """Operations per filled cell, none per sweep: at the bench instance
    (8 x 1024 x 1024) the bytes bound it even if every cell fills."""
    npix = 8 * 1024 * 1024
    ms, by = k6_bound_ms(npix, npix)
    assert by == "bytes" and ms == pytest.approx(9 * npix / HBM_BYTES_PER_S * 1e3)
    assert k6_bound_ms(npix, 0) == (ms, by)
    ms, by = k6_bound_ms(1, 10**9)
    assert by == "operations"
    assert ms == pytest.approx(K6_FILL_OPS * 10**9 / FP32_UNFUSED_OPS_PER_S * 1e3)
