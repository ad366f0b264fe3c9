"""The PyTorch port's plain ops held bitwise against the JAX package's XLA
tier on the same inputs (tolerance 0: every plane is an integer).

Inputs are built with numpy from a seed and passed to both as float32
(conftest turns on x64, so the dtype is explicit).  Leading batch dims
of the port's ops are checked against the JAX op image by image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import BoundaryMode, StereoParams
from stereomatching_tpu.ops import aggregate as j_aggregate
from stereomatching_tpu.ops import argmax as j_argmax
from stereomatching_tpu.ops import contour as j_contour
from stereomatching_tpu.ops import diffusion as j_diffusion
from stereomatching_tpu.ops import edges as j_edges
from stereomatching_tpu.ops import matching as j_matching
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.ops import aggregate, argmax, contour, diffusion, edges, matching
from tests.util import synthetic_pair

MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


def brightness_batch(n=3, h=48, w=64):
    """-> (left, right) float32 [n, h, w], u8 / 256 of synthetic pairs."""
    pairs = [synthetic_pair(h, w, seed=s) for s in range(n)]
    left = np.stack([a for a, _ in pairs]).astype(np.float32) / np.float32(256.0)
    right = np.stack([b for _, b in pairs]).astype(np.float32) / np.float32(256.0)
    return left, right


def edge_batch(mode, n=3):
    """Exact-rule edge maps of the synthetic batch (int32 numpy)."""
    left, right = brightness_batch(n)
    el = edges.find_edges(torch.from_numpy(left), 0.15, mode, "exact").numpy()
    er = edges.find_edges(torch.from_numpy(right), 0.15, mode, "exact").numpy()
    return el, er


def assert_same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode", MODES)
def test_pad_brightness(mode):
    left, _ = brightness_batch(1)
    assert_same(edges.pad_brightness(torch.from_numpy(left[0]), mode),
                j_edges.pad_brightness(jnp.asarray(left[0]), mode))


@pytest.mark.parametrize("rule", ["exact", "reference"])
@pytest.mark.parametrize("mode", MODES)
def test_find_edges(mode, rule):
    left, right = brightness_batch()
    for img in (left, right):
        port = edges.find_edges(torch.from_numpy(img), 0.15, mode, rule)
        for i in range(img.shape[0]):
            assert_same(port[i], j_edges.find_edges(jnp.asarray(img[i]), 0.15, mode, rule))


def test_exact_edges_round_half_even():
    """Brightness at k + 0.5 exactly: k = round(b * 256) must round half
    to even on both sides, as jnp.round does."""
    rng = np.random.default_rng(7)
    b = ((2 * rng.integers(0, 256, (48, 64)) + 1) / 512.0).astype(np.float32)
    b[::3] = rng.integers(0, 256, (16, 64)) / np.float32(256.0)
    for mode in MODES:
        assert_same(edges.find_edges(torch.from_numpy(b), 0.15, mode, "exact"),
                    j_edges.find_edges(jnp.asarray(b), 0.15, mode, "exact"))


def test_find_edges_padded_reference_float64():
    left, _ = brightness_batch(1)
    p = np.pad(left[0].astype(np.float64), 1, mode="wrap")
    assert_same(edges.find_edges_padded(torch.from_numpy(p), 0.3),
                j_edges.find_edges_padded(jnp.asarray(p), 0.3))


@pytest.mark.parametrize("num_shifts", [8, 80])
@pytest.mark.parametrize("mode", MODES)
def test_extend_right_edges(mode, num_shifts):
    """80 > W = 64 exercises the wrap mode's repeated tiling."""
    _, er = edge_batch(mode, 1)
    assert_same(matching.extend_right_edges(torch.from_numpy(er[0]), num_shifts, mode),
                j_matching.extend_right_edges(jnp.asarray(er[0]), num_shifts, mode))


@pytest.mark.parametrize("mode", MODES)
def test_match_plane(mode):
    el, er = edge_batch(mode, 1)
    ext_t = matching.extend_right_edges(torch.from_numpy(er[0]), 16, mode)
    ext_j = j_matching.extend_right_edges(jnp.asarray(er[0]), 16, mode)
    for s in (0, 5, 15):
        assert_same(matching.match_plane(torch.from_numpy(el[0]), ext_t, s),
                    j_matching.match_plane(jnp.asarray(el[0]), ext_j, jnp.int32(s)))


@pytest.mark.parametrize("square_width", [7, 21])
@pytest.mark.parametrize("mode", MODES)
def test_box_sum(mode, square_width):
    el, er = edge_batch(mode)
    plane = (el == er).astype(np.int32)
    port = aggregate.box_sum(torch.from_numpy(plane), square_width, mode)
    for i in range(plane.shape[0]):
        assert_same(port[i], j_aggregate.box_sum(jnp.asarray(plane[i]), square_width, mode))
    half = square_width // 2
    assert_same(aggregate.pad_plane(torch.from_numpy(plane[0]), half, mode),
                j_aggregate.pad_plane(jnp.asarray(plane[0]), half, mode))


@pytest.mark.parametrize("shifts_sw", [(8, 7), (16, 21), (80, 7)])
@pytest.mark.parametrize("mode", MODES)
def test_match_and_score(mode, shifts_sw):
    """(80, 7): more shifts than the 64-px width."""
    d, sw = shifts_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
    el, er = edge_batch(mode)
    best, winner = argmax.match_and_score(torch.from_numpy(el), torch.from_numpy(er),
                                          params_from_jax(params))
    for i in range(el.shape[0]):
        jb, jw = j_argmax.match_and_score(jnp.asarray(el[i]), jnp.asarray(er[i]), params)
        assert_same(best[i], jb)
        assert_same(winner[i], jw)


@pytest.mark.parametrize("mode", MODES)
def test_match_and_score_all_equal_scores_pick_last_shift(mode):
    """Edge-free images match everywhere at every shift, so each pixel's
    score is the same for all shifts and the last-wins rule gives
    winner = D everywhere."""
    params = StereoParams(num_shifts=8, square_width=7, mode=mode)
    zeros = np.zeros((48, 64), np.int32)
    best, winner = argmax.match_and_score(torch.from_numpy(zeros), torch.from_numpy(zeros),
                                          params_from_jax(params))
    jb, jw = j_argmax.match_and_score(jnp.asarray(zeros), jnp.asarray(zeros), params)
    assert_same(best, jb)
    assert_same(winner, jw)
    assert (winner.numpy() == params.num_shifts).all()
    if mode == BoundaryMode.WRAP:
        assert (best.numpy() == params.square_width ** 2).all()


@pytest.mark.parametrize("times", [0, 1, 2, 8])
def test_fill_web_holes(times):
    rng = np.random.default_rng(3)
    web = rng.integers(0, 9, (3, 48, 64)).astype(np.int32)
    web[rng.random(web.shape) < 0.4] = 0
    port = diffusion.fill_web_holes(torch.from_numpy(web), times)
    for i in range(web.shape[0]):
        assert_same(port[i], j_diffusion.fill_web_holes(jnp.asarray(web[i]), times))


@pytest.mark.parametrize("lines", [1, 3, 10])
def test_draw_contour(lines):
    """lines=10 over a range of 7 exercises the interval >= 1 clamp."""
    rng = np.random.default_rng(4)
    web = rng.integers(2, 10, (3, 48, 64)).astype(np.int32)
    out, mn, mx = contour.draw_contour(torch.from_numpy(web), lines)
    for i in range(web.shape[0]):
        jo, jmn, jmx = j_contour.draw_contour(jnp.asarray(web[i]), lines)
        assert_same(out[i], jo)
        assert_same(mn[i], jmn)
        assert_same(mx[i], jmx)
        assert_same(contour.contour_bands(torch.from_numpy(web[i]), lines, mn[i], mx[i]),
                    j_contour.contour_bands(jnp.asarray(web[i]), lines, jmn, jmx))
