"""The PyTorch port's route of the ``"reference"`` edge rule (K8's plain
version, ``ops.fused.match_and_score``), the sub-pixel planes of K1 and
K8, and the collect pipeline, held bitwise against the JAX package's XLA
tier on the CPU (tolerance 0; float planes compared bit for bit).

On CPU tensors the wrappers run their plain versions; the CUDA kernels
are held against those on the card in ``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import StereoParams
from stereomatching_tpu.models import classic as j_classic
from stereomatching_tpu.ops import argmax as j_argmax
from stereomatching_tpu.ops.edges import find_edges as j_find_edges
from stereomatching_tpu_torch import interop
from stereomatching_tpu_torch.models import classic
from stereomatching_tpu_torch.ops import fused
from tests.test_torch_ops import MODES, brightness_batch
from tests.test_torch_pipeline import assert_artifacts_equal, to_f32, u8_batch


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


@functools.cache
def _jax_scorer(params: StereoParams, subpixel: bool):
    fn = j_argmax.match_and_score_subpixel if subpixel else j_argmax.match_and_score
    return jax.jit(functools.partial(fn, params=params))


def jax_edges(brightness, params, rule):
    return np.stack([np.asarray(j_find_edges(jnp.asarray(b), params.threshold,
                                             params.mode, rule)) for b in brightness])


# (H, W, D, square_width): the synthetic shape, an odd one, and D > W.
SHAPES = [(48, 64, 16, 9), (37, 45, 12, 5), (20, 14, 16, 3)]


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["48x64", "odd", "d-over-w"])
@pytest.mark.parametrize("mode", MODES)
def test_match_and_score_cpu_matches_jax(mode, shape, subpixel):
    h, w, d, sw = shape
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode)
    left, right = brightness_batch(2, h, w)
    el, er = jax_edges(left, params, "reference"), jax_edges(right, params, "reference")
    before = fused.match_and_score.launches
    got = fused.match_and_score(torch.from_numpy(el), torch.from_numpy(er),
                                interop.params_from_jax(params), subpixel)
    assert fused.match_and_score.launches == before  # CPU: no kernel launch
    assert len(got) == (3 if subpixel else 2)
    for i in range(2):
        ref = _jax_scorer(params, subpixel)(jnp.asarray(el[i]), jnp.asarray(er[i]))
        for port, want in zip(got, ref):
            assert bits_equal(port[i].numpy(), want)
    single = fused.match_and_score(torch.from_numpy(el[1]), torch.from_numpy(er[1]),
                                   interop.params_from_jax(params), subpixel)
    for a, b in zip(single, got):
        assert torch.equal(a, b[1])


@pytest.mark.parametrize("mode", MODES)
def test_match_and_score_reads_nonzero_as_edge(mode):
    """Any non-zero edge value is an edge, as K8 stages it on the card:
    maps holding 2, 3, 256 and -1 score as their 0/1 forms."""
    params = interop.params_from_jax(StereoParams(num_shifts=12, square_width=5, mode=mode))
    rng = np.random.default_rng(7)
    maps = rng.choice(np.array([0, 0, 0, 1, 2, 3, 256, -1], np.int32), (2, 2, 37, 45))
    got = fused.match_and_score(*map(torch.from_numpy, maps), params, True)
    want = fused.match_and_score(*(torch.from_numpy((m != 0).astype(np.int32))
                                   for m in maps), params, True)
    for a, b in zip(got, want):
        assert bits_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_match_score_edges_subpixel_cpu_matches_jax(mode):
    params = StereoParams(num_shifts=12, square_width=7, mode=mode, edge_rule="exact")
    left, right = brightness_batch(2)
    got = fused.match_score_edges(torch.from_numpy(left), torch.from_numpy(right),
                                  interop.params_from_jax(params), subpixel=True)
    assert len(got) == 5 and got[4].dtype == torch.float32
    el, er = jax_edges(left, params, "exact"), jax_edges(right, params, "exact")
    for i in range(2):
        best, winner, sub = _jax_scorer(params, True)(jnp.asarray(el[i]), jnp.asarray(er[i]))
        for port, want in zip(got, (best, winner, el[i], er[i], sub)):
            assert bits_equal(port[i].numpy(), want)
    # The sub-pixel plane is an extra: the other four are unchanged.
    plain = fused.match_score_edges(torch.from_numpy(left), torch.from_numpy(right),
                                    interop.params_from_jax(params))
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", ["reference", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_classic_subpixel_matches_jax(mode, rule):
    params = StereoParams(num_shifts=12, square_width=9, times=4, mode=mode, edge_rule=rule)
    lu, ru = u8_batch(2)
    left, right = to_f32(lu), to_f32(ru)
    pp = interop.params_from_jax(params)
    port = classic.classic_forward_batched(torch.from_numpy(left), torch.from_numpy(right),
                                           pp, subpixel=True)
    fn = jax.jit(functools.partial(j_classic.classic_forward, params=params,
                                   use_pallas=False, subpixel=True))
    for i in range(2):
        ref = jax.device_get(fn(jnp.asarray(left[i]), jnp.asarray(right[i])))
        assert sorted(port) == sorted(ref)
        for k, v in ref.items():
            assert bits_equal(port[k][i].numpy(), v), k
    single = classic.classic_forward(torch.from_numpy(left[0]), torch.from_numpy(right[0]),
                                     pp, subpixel=True)
    pipe = classic.build_classic_pipeline(pp, subpixel=True)
    for k, v in pipe(torch.from_numpy(left), torch.from_numpy(right)).items():
        assert torch.equal(v, port[k]), k
        assert torch.equal(single[k], port[k][0]), k
    assert "subpixel" not in classic.build_classic_pipeline(pp)(
        torch.from_numpy(left), torch.from_numpy(right))


@pytest.mark.parametrize("rule", ["reference", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_collect_pipeline_matches_jax(mode, rule):
    params = StereoParams(num_shifts=8, square_width=7, times=4, mode=mode, edge_rule=rule)
    lu, ru = u8_batch(1)
    left, right = to_f32(lu[0]), to_f32(ru[0])
    port = classic.build_classic_collect_pipeline(interop.params_from_jax(params))(
        torch.from_numpy(left), torch.from_numpy(right))
    ref = jax.device_get(j_classic.build_classic_collect_pipeline(params)(
        jnp.asarray(left), jnp.asarray(right)))
    assert port["matches"].shape == (8, 48, 64)
    assert_artifacts_equal(port, ref)
    # The finish pipeline on the collected winner gives the same tail.
    fin = classic.build_classic_finish_pipeline(interop.params_from_jax(params))(port["web-1"])
    assert_artifacts_equal(fin, {k: ref[k] for k in fin})


def test_matchers_warmup_run_a_zero_batch():
    """``warmup`` runs one zero batch through the route (on the CPU: the
    plain versions, no kernel launch) and leaves the matcher serving."""
    from stereomatching_tpu_torch.config import ModernParams as PortModernParams
    from stereomatching_tpu_torch.config import StereoParams as PortStereoParams
    from stereomatching_tpu_torch.serving import Matcher, ModernMatcher

    before = fused.match_and_score.launches
    m = Matcher(PortStereoParams(num_shifts=8, square_width=5), device="cpu")
    m.warmup((16, 24), batch=2)
    m.warmup((16, 24))
    assert fused.match_and_score.launches == before
    lu, ru = u8_batch(1, 16, 24)
    assert m(lu, ru)["web-1"].shape == (1, 16, 24)
    mm = ModernMatcher(PortModernParams(num_disparities=8, aggregation="sgm", scales=2),
                       device="cpu")
    mm.warmup((16, 24), batch=2)
    assert mm(lu[0], ru[0])["disparity"].shape == (16, 24)
