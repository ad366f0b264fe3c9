"""Seeded random-configuration sweeps of the port against the JAX
package (the port's counterpart of ``tests/test_fuzz.py``): each case
draws its config and its pairs from ``np.random.default_rng(seed)``,
runs them through the JAX package's XLA tier (jitted,
``use_pallas=False``) and the port's plain route on the CPU, and holds
every output plane bitwise equal (tolerance 0, float planes included),
naming the config on failure.  Params are built in the JAX package and
carried across with ``interop.params_from_jax``.

- classic: ``test_fuzz.py``'s distribution widened to both edge rules,
  sub-pixel on and off, ``num_shifts`` up to ``w + 10`` and batches of
  1-2, every artifact against ``build_classic_pipeline``, and the port's
  numpy oracle against the JAX oracle on the same draw;
- box: SAD and census, windows 1-15, D 2-40, ``scales`` 1 and 2, LR,
  median, both fill modes, and ``disparity_one_view`` for a drawn
  reference view;
- SGM: 4 and 8 paths, ``scales`` 1 and 2, random P1 and P2 >= P1,
  ``lr_max_diff`` 0-2, ``fill_iterations`` 0-12, median, uniqueness;
- sharded: the port's sharded tier on virtual CPU meshes (classic on
  data x rows with rows 2 or 4, the box route on rows x cols, SGM on
  rows) against the JAX single-device XLA forward.

Refusals: about one draw in six sets one field outside its domain (or
asks for uniqueness on the box route, a square wider than the image, or
``scales`` 2 on the sharded tier).  Where one side raises, the other
must raise the same exception type; ``REFUSED`` records which seeds
refuse and ``test_refusals_are_recorded`` holds the record to the draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import BoundaryMode
from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.config import StereoParams as JStereoParams
from stereomatching_tpu.models import classic as j_classic
from stereomatching_tpu.models import modern as j_modern
from stereomatching_tpu.oracle import pipeline as j_oracle
from stereomatching_tpu.parallel import make_mesh as j_make_mesh
from stereomatching_tpu.parallel.modern import sharded_modern_forward as j_sharded_modern
from stereomatching_tpu_torch import config as p_config
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.models import classic, modern
from stereomatching_tpu_torch.oracle import pipeline as p_oracle
from stereomatching_tpu_torch.parallel import (
    build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh)
from stereomatching_tpu_torch.parallel.modern import _validate as p_sharded_validate
from tests.util import synthetic_pair

CLASSIC_SEEDS = range(16)
BOX_SEEDS = range(8)
SGM_SEEDS = range(4)
SHARDED_CLASSIC_SEEDS = range(4)
SHARDED_MODERN_SEEDS = range(5)
# Seeds whose draw one side refuses (then both must), by kind.
REFUSED = {"classic": [4, 5, 9], "box": [1, 5], "sgm": [], "sharded_classic": [],
           "sharded_modern": [4]}

# A field outside its domain, as (name, value), for the refusal draws.
BAD_STEREO = [("square_width", 4), ("num_shifts", 0), ("threshold", 1.5), ("times", -1),
              ("lines", 0), ("edge_rule", "sobel")]
BAD_MODERN = [("num_disparities", 1), ("window", 4), ("scales", 3), ("census_window", 7),
              ("sgm_p1", -1), ("fill_mode", "nearest"), ("sgm_directions", 6),
              ("lr_max_diff", -1)]


def _raised(fn):
    """-> (None, value) or (the exception's type and message, None)."""
    try:
        return None, fn()
    except (ValueError, TypeError) as e:
        return (type(e), str(e)), None


def _both(jax_fn, port_fn, what):
    """Run both sides -> (jax value, port value), or None where both
    raised the same exception type; fails where only one raised."""
    j_err, j_val = _raised(jax_fn)
    p_err, p_val = _raised(port_fn)
    assert (j_err is None) == (p_err is None), f"{what}: JAX {j_err}, port {p_err}"
    if j_err is not None:
        assert j_err[0] is p_err[0], f"{what}: JAX {j_err}, port {p_err}"
        return None
    return j_val, p_val


def _pairs(rng, n, h, w):
    """-> (left, right) uint8 [n, h, w]: ``tests/util.synthetic_pair``'s
    blobs or uniform noise, drawn per pair."""
    lefts, rights = [], []
    for _ in range(n):
        if rng.random() < 0.6 and h >= 9 and w >= 13:
            a, b = synthetic_pair(h, w, seed=int(rng.integers(1 << 30)),
                                  max_shift=int(rng.integers(2, 12)))
        else:
            a, b = (rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(2))
        lefts.append(a)
        rights.append(b)
    return np.stack(lefts), np.stack(rights)


def _brightness(u8):
    return u8.astype(np.float32) / np.float32(256.0)


def _bytes(x):
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def assert_planes_equal(port, ref, what):
    """Every plane of ``ref`` (JAX) equal to the port's: keys, dtype,
    shape and bits."""
    port = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in port.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert sorted(port) == sorted(ref), f"{what}: keys {sorted(port)} != {sorted(ref)}"
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, (
            f"{k} {port[k].dtype}{port[k].shape} != {v.dtype}{v.shape} {what}")
        assert np.array_equal(_bytes(port[k]), _bytes(v)), f"{k} differs: {what}"


def _with_bad_field(rng, kw, bad):
    """With probability 1/6, one field of ``kw`` set outside its domain."""
    if rng.random() < 1 / 6:
        name, value = bad[int(rng.integers(len(bad)))]
        kw[name] = value
    return kw


def _params(cls, kw):
    """-> (JAX params, port params), or the refusal both constructors
    share (``None`` for both)."""
    got = _both(lambda: cls(**kw), lambda: _port_class(cls)(**_port_fields(kw)), f"{kw}")
    if got is None:
        return None, None
    return got[0], params_from_jax(got[0])


def _port_class(cls):
    return p_config.StereoParams if cls is JStereoParams else p_config.ModernParams


def _port_fields(kw):
    return {k: p_config.BoundaryMode(v.value) if isinstance(v, BoundaryMode) else v
            for k, v in kw.items()}


# ------------------------------------------------------------- classic


def classic_draw(seed):
    rng = np.random.default_rng(1000 + seed)
    h, w = int(rng.integers(9, 64)), int(rng.integers(13, 96))
    sw = min(int(rng.choice([1, 3, 5, 7, 9, 11])), (min(h, w) - 1) | 1)
    if rng.random() < 0.05:
        sw = (max(h, w) + 1) | 1  # a square wider than the image
    kw = dict(threshold=float(rng.uniform(0.05, 0.5)), square_width=sw,
              times=int(rng.integers(0, 12)), lines=int(rng.integers(1, 12)),
              num_shifts=int(rng.integers(1, w + 11)),
              mode=BoundaryMode(str(rng.choice(["wrap", "ghost"]))),
              edge_rule=str(rng.choice(["exact", "reference"])))
    kw = _with_bad_field(rng, kw, BAD_STEREO)
    subpixel = bool(rng.integers(0, 2))
    left, right = _pairs(rng, int(rng.integers(1, 3)), h, w)
    return kw, subpixel, left, right


@pytest.mark.parametrize("seed", CLASSIC_SEEDS)
def test_fuzz_classic_matches_jax_and_oracle(seed):
    kw, subpixel, left, right = classic_draw(seed)
    what = f"seed {seed} {kw} subpixel={subpixel} pairs {left.shape}"
    jp, pp = _params(JStereoParams, kw)
    if jp is None:
        return
    lb, rb = _brightness(left), _brightness(right)
    batched = len(lb) > 1
    l_in, r_in = (lb, rb) if batched else (lb[0], rb[0])

    def jax_side():
        oracle = j_oracle.run_pipeline(lb[0].astype(np.float64), rb[0].astype(np.float64), jp)
        fn = j_classic.build_classic_pipeline(jp, batched=batched, subpixel=subpixel)
        return oracle, jax.device_get(fn(jnp.asarray(l_in), jnp.asarray(r_in)))

    def port_side():
        got = classic.build_classic_pipeline(pp, subpixel)(torch.from_numpy(l_in),
                                                           torch.from_numpy(r_in))
        oracle = p_oracle.run_pipeline(lb[0].astype(np.float64), rb[0].astype(np.float64), pp)
        return oracle, got

    got = _both(jax_side, port_side, what)
    if got is None:
        return
    (j_orc, j_out), (p_orc, p_out) = got
    assert_planes_equal(p_out, j_out, what)
    assert_planes_equal(p_orc, j_orc, f"oracle {what}")


# ------------------------------------------------------------- modern


def modern_draw(seed, aggregation):
    """A box (``test_fuzz.py:130-155`` widened) or SGM (``:158-190``
    widened) config, a batch of 1-2 pairs and a reference view."""
    rng = np.random.default_rng((4000 if aggregation == "box" else 5000) + seed)
    kw = dict(aggregation=aggregation, cost=str(rng.choice(["sad", "census"])),
              census_window=int(rng.choice([3, 5])), scales=int(rng.choice([1, 2])),
              lr_max_diff=int(rng.integers(0, 3)), median_filter=bool(rng.integers(0, 2)),
              fill_mode=str(rng.choice(["diffusion", "background"])),
              fill_iterations=int(rng.integers(0, 13)))
    if aggregation == "box":
        kw.update(num_disparities=int(rng.integers(2, 41)),
                  window=int(rng.choice(range(1, 16, 2))),
                  uniqueness=bool(rng.random() < 0.1))  # refused on the box route
    else:
        p1 = int(rng.integers(0, 12))
        kw.update(num_disparities=int(rng.integers(2, 24)), sgm_p1=p1,
                  sgm_p2=p1 + int(rng.integers(0, 120)),
                  sgm_directions=int(rng.choice([4, 8])), uniqueness=bool(rng.integers(0, 2)))
    kw = _with_bad_field(rng, kw, BAD_MODERN)
    h, w = int(rng.integers(9, 48)), int(rng.integers(13, 72))
    left, right = _pairs(rng, int(rng.integers(1, 3)), h, w)
    return kw, str(rng.choice(["left", "right"])), left, right


def _modern_case(seed, aggregation):
    kw, reference, left, right = modern_draw(seed, aggregation)
    what = f"seed {seed} {kw} pairs {left.shape}"
    jp, pp = _params(JModernParams, kw)
    if jp is None:
        return
    batched = len(left) > 1
    l_in, r_in = (left, right) if batched else (left[0], right[0])
    fn = j_modern.build_modern_pipeline(jp, batched=batched)
    want = jax.device_get(fn(jnp.asarray(l_in, jnp.int32), jnp.asarray(r_in, jnp.int32)))
    got = modern.modern_forward(torch.from_numpy(l_in.astype(np.int32)),
                                torch.from_numpy(r_in.astype(np.int32)), pp)
    assert_planes_equal(got, want, what)
    if aggregation == "box":
        l0, r0 = left[0].astype(np.int32), right[0].astype(np.int32)
        one_view = jax.jit(functools.partial(j_modern.disparity_one_view, params=jp,
                                             reference=reference))
        want = one_view(jnp.asarray(l0), jnp.asarray(r0))
        got = modern.disparity_one_view(torch.from_numpy(l0), torch.from_numpy(r0), pp,
                                        reference)
        assert_planes_equal(got._asdict(), jax.device_get(want)._asdict(),
                            f"disparity_one_view {reference} {what}")


@pytest.mark.parametrize("seed", BOX_SEEDS)
def test_fuzz_box_matches_jax(seed):
    _modern_case(seed, "box")


@pytest.mark.parametrize("seed", SGM_SEEDS)
def test_fuzz_sgm_matches_jax(seed):
    _modern_case(seed, "sgm")


# ------------------------------------------------------------- sharded


def cpu_mesh(data, rows, cols=None):
    return make_mesh(data=data, rows=rows, cols=cols,
                     devices=["cpu"] * (data * rows * (cols or 1)))


def sharded_classic_draw(seed):
    rng = np.random.default_rng(3000 + seed)
    rows, data = int(rng.choice([2, 4])), int(rng.choice([1, 2]))
    sw = int(rng.choice([1, 3, 5, 7, 9]))
    h = rows * int(rng.integers(max(sw // 2, 2), 17))
    w = int(rng.integers(max(sw, 13), 80))
    kw = dict(threshold=float(rng.uniform(0.05, 0.4)), square_width=sw,
              times=int(rng.integers(0, 9)), lines=int(rng.integers(1, 9)),
              num_shifts=int(rng.integers(1, 24)),
              mode=BoundaryMode(str(rng.choice(["wrap", "ghost"]))),
              edge_rule=str(rng.choice(["exact", "reference"])))
    left, right = _pairs(rng, data * int(rng.integers(1, 3)), h, w)
    return (data, rows), kw, left, right


@pytest.mark.parametrize("seed", SHARDED_CLASSIC_SEEDS)
def test_fuzz_sharded_classic_matches_jax(seed):
    shape, kw, left, right = sharded_classic_draw(seed)
    what = f"seed {seed} mesh {shape} {kw} pairs {left.shape}"
    jp, pp = _params(JStereoParams, kw)
    lb, rb = _brightness(left), _brightness(right)
    want = jax.device_get(j_classic.build_classic_pipeline(jp, batched=True)(
        jnp.asarray(lb), jnp.asarray(rb)))
    got = build_sharded_pipeline(pp, cpu_mesh(*shape))(torch.from_numpy(lb),
                                                       torch.from_numpy(rb))
    assert_planes_equal(got, want, what)


def sharded_modern_draw(seed):
    """Even seeds: the box route on a rows x cols mesh; odd: SGM on rows."""
    rng = np.random.default_rng(6000 + seed)
    box = seed % 2 == 0
    kw = dict(aggregation="box" if box else "sgm", cost=str(rng.choice(["sad", "census"])),
              census_window=int(rng.choice([3, 5])), window=int(rng.choice([1, 3, 5])),
              num_disparities=int(rng.integers(2, 17)), lr_max_diff=int(rng.integers(0, 3)),
              median_filter=bool(rng.integers(0, 2)),
              fill_iterations=int(rng.integers(0, 13)),
              scales=2 if rng.random() < 1 / 6 else 1)  # the sharded tier refuses 2
    if box:
        rows, cols = int(rng.choice([1, 2])), 2
        reach = kw["num_disparities"] + kw["window"] // 2 + kw["census_window"] // 2
        w = cols * int(rng.integers(reach, reach + 12))
    else:
        rows, cols = int(rng.choice([2, 4])), None
        p1 = int(rng.integers(0, 12))
        kw.update(sgm_p1=p1, sgm_p2=p1 + int(rng.integers(0, 120)),
                  sgm_directions=int(rng.choice([4, 8])), uniqueness=bool(rng.integers(0, 2)),
                  fill_mode=str(rng.choice(["diffusion", "background"])))
        w = int(rng.integers(13, 64))
    h = rows * int(rng.integers(1, 16))  # shards below the halo reach are refused
    left, right = _pairs(rng, int(rng.integers(1, 3)), h, w)
    return (1, rows, cols), kw, left, right


@pytest.mark.parametrize("seed", SHARDED_MODERN_SEEDS)
def test_fuzz_sharded_modern_matches_jax(seed):
    shape, kw, left, right = sharded_modern_draw(seed)
    what = f"seed {seed} mesh {shape} {kw} pairs {left.shape}"
    jp, pp = _params(JModernParams, kw)
    li, ri = left.astype(np.int32), right.astype(np.int32)
    n = shape[0] * shape[1] * (shape[2] or 1)
    j_mesh = j_make_mesh(shape[0], shape[1], shape[2], devices=jax.devices()[:n])
    # The JAX sharded tier's refusals come before any trace or compile.
    got = _both(lambda: jax.eval_shape(lambda a, b: j_sharded_modern(a, b, jp, j_mesh), li, ri),
                lambda: build_sharded_modern_pipeline(pp, cpu_mesh(*shape))(li, ri),
                what)
    if got is None:
        return
    want = jax.device_get(j_modern.build_modern_pipeline(jp, batched=True)(
        jnp.asarray(li), jnp.asarray(ri)))
    assert_planes_equal(got[1], want, what)


# ------------------------------------------------------------- refusals


def _refuses(kind, seed) -> bool:
    """Whether ``kind``'s draw for ``seed`` is refused, checked on both
    sides without running a forward (params, then the square against the
    image, then the sharded tier's conditions)."""
    if kind == "classic":
        kw, _, left, _ = classic_draw(seed)
        jp, pp = _params(JStereoParams, kw)
        if jp is None:
            return True
        h, w = left.shape[1:]
        return _both(lambda: jp.validate_for_image(w, h), lambda: pp.validate_for_image(w, h),
                     f"classic seed {seed}") is None
    if kind in ("box", "sgm"):
        return _params(JModernParams, modern_draw(seed, kind)[0])[0] is None
    if kind == "sharded_classic":
        return _params(JStereoParams, sharded_classic_draw(seed)[1])[0] is None
    shape, kw, left, _ = sharded_modern_draw(seed)
    pp = _params(JModernParams, kw)[1]
    return (pp is None or _raised(
        lambda: p_sharded_validate(left.shape, pp, cpu_mesh(*shape)))[0] is not None)


@pytest.mark.parametrize("kind, seeds", [
    ("classic", CLASSIC_SEEDS), ("box", BOX_SEEDS), ("sgm", SGM_SEEDS),
    ("sharded_classic", SHARDED_CLASSIC_SEEDS), ("sharded_modern", SHARDED_MODERN_SEEDS)])
def test_refusals_are_recorded(kind, seeds):
    assert [s for s in seeds if _refuses(kind, s)] == REFUSED[kind]
