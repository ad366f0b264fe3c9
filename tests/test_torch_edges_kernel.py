"""The reference rule's edges of both views (``ops/fused_edges.py``, K11's
wrapper): on the CPU its contract (the plain version on CPU tensors,
no launch; its refusals, float16, bfloat16 and mixed dtypes on a card
among them; the classic model's choice of
wrapper by ``plain``; a kernel name that no benchmark pattern counts),
and on a CUDA card K11 bitwise its plain version on every shape,
dtype, mode, threshold and value kind it takes, near-ties included.

The card tests are marked ``cuda`` and skip without a GPU.  The file
imports no jax (the GPU host need not have it); run it there with

    python -m pytest --noconftest tests/test_torch_edges_kernel.py -q
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.models import build_classic_pipeline, classic
from stereomatching_tpu_torch.ops import edges, fused_edges
from stereomatching_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]
THRESHOLDS = [0.0, 0.15, 1.0, 7.5]


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def planes(shape, kind, dtype=torch.float32, seed=0):
    """Two brightness planes of ``shape``: uniform in [0, 1), 8-bit pixels
    over 256, or constant (each plane its own constant)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        xs = [rng.random(shape) for _ in range(2)]
    elif kind == "pixels":
        xs = [rng.integers(0, 256, shape) / 256.0 for _ in range(2)]
    else:
        xs = [np.full(shape, v) for v in (rng.integers(0, 256) / 256.0, 0.5)]
    return [torch.from_numpy(x).to(dtype) for x in xs]


def tie_patch(ka: int, kb: int) -> np.ndarray:
    """A 9 x 9 cell of 8-bit pixels whose centre's left-right operator
    compares 3-pixel sums ka (left column) and kb (right column); the
    rest is their mean (``tests/test_torch_knife_edge.py``'s planted
    ties)."""
    m = (ka + kb) // 6
    cell = np.full((9, 9), m, np.int64)
    cell[3:6, 3] = [ka // 3 + (i < ka % 3) for i in range(3)]
    cell[3:6, 5] = [kb // 3 + (i < kb % 3) for i in range(3)]
    return cell


def near_ties(seed: int, shape=(40, 56)) -> torch.Tensor:
    """Pixel / 256 brightness with planted rational ties of the predicate
    at threshold 0.15 (3-pixel sums 43k and 37k, both ways round, so
    40 |ka - kb| = 3 (ka + kb)), and strips of sums in the ratios 11:9,
    43:37 and 21:19 along rows and columns (ties at 0.2, 0.15 and 0.1),
    on random pixels: only each op's rounding decides there."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.integers(0, 256, shape)
    for i, (y, x) in enumerate((y, x) for y in range(0, h - 8, 10) for x in range(0, w - 8, 10)):
        k = 1 + (i + seed) % 17
        ka, kb = (43 * k, 37 * k) if i % 2 else (37 * k, 43 * k)
        img[y:y + 9, x:x + 9] = tie_patch(ka, kb)
    for j, (p, q) in enumerate(((11, 9), (43, 37), (21, 19))):
        m = rng.integers(1, 256 // p + 1)
        x = 3 + 17 * j
        if x + 2 < w:
            img[:, x], img[:, x + 2] = p * m, q * m
        y = 5 + 11 * j
        if y + 2 < h:
            img[y, :], img[y + 2, :] = q * m, p * m
    return torch.from_numpy(img / 256.0).to(torch.float32)


def reciprocal_edges(x: torch.Tensor, threshold: float, mode: BoundaryMode) -> torch.Tensor:
    """The reference rule with each divide by 3 made a product by the
    rounded 1/3: the fault a kernel must not have."""
    nb = edges._taps(edges.pad_brightness(x, mode))
    third, thr, two = (torch.full((), v, dtype=x.dtype) for v in (1 / 3, threshold, 2.0))
    out = torch.zeros(nb(0, 0).shape, dtype=torch.bool)
    for (a0, a1, a2), (b0, b1, b2) in edges.EDGE_OPERATORS:
        avg_a = (nb(*a0) + nb(*a1) + nb(*a2)) * third
        avg_b = (nb(*b0) + nb(*b1) + nb(*b2)) * third
        out |= (avg_a - avg_b).abs() > torch.clamp(thr * ((avg_a + avg_b) / two), 0.0, 1.0)
    return out.to(torch.int32)


# ---------------------------------------------------------------- CPU

# [H, W], [B, H, W] and a leading dim: one pixel, a row, a column, planes
# under the 3 x 3 window, odd sizes.
CPU_SHAPES = [(1, 1), (1, 9), (7, 1), (2, 2), (3, 5), (3, 6, 7), (2, 3, 4, 5), (1, 17, 29)]


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_cpu_planes_run_the_plain_version(mode, dtype, shape):
    """On CPU tensors ``reference_edges`` is ``find_edges(..., "reference")``
    of each view, at every threshold and value kind, and launches
    nothing."""
    before = fused_edges.reference_edges.launches
    for kind in ("uniform", "pixels", "constant"):
        a, b = planes(shape, kind, dtype, seed=len(shape) * 10 + shape[-1])
        for thr in THRESHOLDS:
            got = fused_edges.reference_edges(a, b, thr, mode)
            for g, x in zip(got, (a, b)):
                assert g.dtype == torch.int32 and g.shape == x.shape
                assert torch.equal(g, edges.find_edges(x, thr, mode, "reference"))
            assert all(torch.equal(g, w) for g, w in zip(
                got, fused_edges.reference_edges_reference(a, b, thr, mode)))
    assert fused_edges.reference_edges.launches == before


@pytest.mark.parametrize("shapes", [((2, 4, 4), (2, 4, 5)), ((4,), (4,)), ((3, 4), (4, 3))])
def test_unequal_or_flat_shapes_are_refused(shapes):
    a, b = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="equal"):
        fused_edges.reference_edges(a, b, 0.15)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int64, torch.bool])
def test_non_float_planes_are_refused(dtype):
    x, f = torch.zeros((1, 4, 4), dtype=dtype), torch.zeros((1, 4, 4))
    for pair in ((x, x), (x, f), (f, x)):
        with pytest.raises(ValueError, match="float brightness planes"):
            fused_edges.reference_edges(*pair, 0.15)


@pytest.mark.parametrize("shape", [(0, 5, 7), (2, 0, 7), (2, 5, 0), (0, 0)])
def test_empty_planes_give_empty_maps(shape):
    x = torch.zeros(shape)
    before = fused_edges.reference_edges.launches
    el, er = fused_edges.reference_edges(x, x, 0.15)
    assert el.shape == er.shape == shape and el.dtype == er.dtype == torch.int32
    assert fused_edges.reference_edges.launches == before


class _Null:
    """Stands in for ``torch.cuda.device(...)`` and the current stream."""

    cuda_stream = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeLib:
    """Stands in for K11's library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def reference_edges(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtypes", [(torch.float16, torch.float16),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float64),
                                    (torch.float32, torch.float32),
                                    (torch.float64, torch.float64)], ids=str)
def test_the_dtype_decides_the_route_on_a_card(monkeypatch, dtypes):
    """With the device route forced to the kernel's, float32 and float64
    pairs launch K11 once (both views; element size, wrap flag and
    threshold as passed) and count ``launches.K11``; float16, bfloat16
    and mixed pairs are refused before any launch and count nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(fused_edges, "_device_route", lambda *t: False)
    monkeypatch.setattr(fused_edges, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Null())
    a, b = planes((2, 5, 9), "pixels", torch.float64, seed=1)
    a, b = a.to(dtypes[0]), b.to(dtypes[1])
    before = fused_edges.reference_edges.launches
    kernel = dtypes[0] == dtypes[1] and dtypes[0] in (torch.float32, torch.float64)
    tracing.enable()
    with tracing.span("forward", a):
        if kernel:
            fused_edges.reference_edges(a, b, 0.15, BoundaryMode.GHOST)
        else:
            with pytest.raises(ValueError, match="float32 or two float64"):
                fused_edges.reference_edges(a, b, 0.15, BoundaryMode.GHOST)
    tracing.disable()
    (req,) = tracing.records()["requests"]
    if kernel:
        assert len(lib.calls) == 1 and fused_edges.reference_edges.launches == before + 1
        assert lib.calls[0][4:10] == (2, 5, 9, a.element_size(), 0, 0.15)
        assert req["counters"] == {"launches.K11": 1}
    else:
        assert not lib.calls and fused_edges.reference_edges.launches == before
        assert req["counters"] == {}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
def test_narrow_dtypes_are_refused_on_a_card_even_when_empty(monkeypatch, dtype):
    """With the device route forced to the kernel's, empty float16 and
    bfloat16 planes are refused as non-empty ones are: the dtype is
    checked before the empty shortcut, and nothing launches."""
    lib = _FakeLib()
    monkeypatch.setattr(fused_edges, "_device_route", lambda *t: False)
    monkeypatch.setattr(fused_edges, "_lib", lambda: lib)
    x = torch.zeros((2, 0, 7), dtype=dtype)
    with pytest.raises(ValueError, match="float32 or two float64"):
        fused_edges.reference_edges(x, x, 0.15)
    assert not lib.calls


@pytest.mark.parametrize("rule", ["reference", "exact"])
@pytest.mark.parametrize("plain", [False, True])
def test_the_classic_edges_stage_picks_the_wrapper_by_plain(monkeypatch, plain, rule):
    """The reference rule's ``_edges`` calls ``reference_edges`` on the
    kernel route and ``reference_edges_reference`` with ``plain``; the
    exact rule calls neither (K1 makes its edges, and the collect
    pipeline's are ``find_edges``)."""
    called = []
    for name in ("reference_edges", "reference_edges_reference"):
        fn = getattr(classic, name)
        monkeypatch.setattr(classic, name,
                            lambda *a, _n=name, _f=fn: called.append(_n) or _f(*a))
    params = StereoParams(num_shifts=6, square_width=3, times=2, edge_rule=rule)
    a, b = planes((2, 12, 20), "pixels", seed=2)
    got = (classic.classic_forward_reference if plain else classic.classic_forward_batched)(
        a, b, params)
    collect = classic.build_classic_collect_pipeline(params)(a, b)
    if rule == "exact":
        assert called == []
    else:
        want = "reference_edges_reference" if plain else "reference_edges"
        assert called == [want, "reference_edges"]
    for k in ("edges-1", "edges-2"):
        assert torch.equal(got[k], collect[k])


def test_k11s_name_matches_no_benchmark_pattern():
    """K11's kernel is ``reference_edges_kernel`` in an anonymous
    namespace: none of ``stereobench/kernels/*.json``'s patterns counts
    it (as the profiler shows it, demangled or not), so its time stays in
    ``torch_ops_ms``, where the torch chain's stood."""
    src = (ROOT / "stereomatching_tpu_torch/csrc/reference_edges.cu").read_text()
    head = src.split("reference_edges_kernel(", 1)[0]
    assert head.count("namespace {") == 1 and "}  // namespace" not in head
    names = ["(anonymous namespace)::reference_edges_kernel<float>(float const*, float const*, "
             "int*, int*, int, int, int, int, int, bool, float)",
             "void (anonymous namespace)::reference_edges_kernel<double>(double const*, ...)",
             "_ZN45_GLOBAL__N_1a2b3c4d_reference_edges_cu_0123456722reference_edges_kernelIfEEvPKT_"]
    pats = [re.compile(p) for f in sorted(ROOT.glob("stereobench/kernels/*.json"))
            for p in json.loads(f.read_text())["patterns"]]
    assert len(pats) >= 9
    assert not any(p.search(n) for p in pats for n in names)
    # The patterns do count the kernels they are written for.
    assert any(p.search("(anonymous namespace)::match_and_score_kernel(int const*)")
               for p in pats)


@pytest.mark.parametrize("seed", range(4))
def test_near_ties_tell_a_reciprocal_from_a_divide(seed):
    """On the planted near-ties the rule with products by 1/3 sets other
    edges than the rule's divides, in both modes and at the three tie
    thresholds: so the card tests below, run on these planes, fail a
    kernel that multiplies by the reciprocal."""
    x = near_ties(seed)
    for mode in MODES:
        flipped = sum(int((reciprocal_edges(x, thr, mode)
                           != edges.find_edges(x, thr, mode, "reference")).sum())
                      for thr in (0.2, 0.15, 0.1))
        assert flipped > 0, mode


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_k11_matches_plain(a, b, thr, mode, device):
    """K11 on ``a``, ``b`` (one launch) == the plain version on the CPU and
    on the card, bit for bit."""
    before = fused_edges.reference_edges.launches
    got = fused_edges.reference_edges(a.to(device), b.to(device), thr, mode)
    torch.cuda.synchronize()
    assert fused_edges.reference_edges.launches == before + 1
    card = fused_edges.reference_edges_reference(a.to(device), b.to(device), thr, mode)
    for g, c, x in zip(got, card, (a, b)):
        assert g.dtype == torch.int32 and g.shape == x.shape and g.is_contiguous()
        want = edges.find_edges(x, thr, mode, "reference")
        assert torch.equal(g.cpu(), want), (tuple(x.shape), thr, mode)
        assert torch.equal(c.cpu(), want)


# [..., H, W] for K11: one pixel, a row, a column, planes under the 3 x 3
# window, tile edges (128 columns, 32 rows: heights 31-33, widths
# 127-129), widths that are not a multiple of 4 (element stores), batch
# 1 and 3 and a leading dim.
K11_SHAPES = [(1, 1, 1), (1, 1, 9), (3, 7, 1), (1, 2, 2), (3, 3, 5), (1, 31, 127),
              (3, 32, 128), (1, 33, 129), (3, 37, 45), (1, 70, 3), (2, 3, 40, 261)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K11_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_k11_matches_plain(cuda_device, mode, dtype, shape):
    for kind in ("uniform", "pixels", "constant"):
        a, b = planes(shape, kind, dtype, seed=shape[-2] * 1000 + shape[-1])
        for thr in THRESHOLDS:
            assert_k11_matches_plain(a, b, thr, mode, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (2, 1110, 1390)], ids=str)
def test_k11_at_the_cells_sizes(cuda_device, shape, dtype):
    """K11 at 1024² and 1110 x 1390 against the plain version on the card,
    both modes, pixel / 256 and uniform planes."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    pix = [(torch.randint(0, 256, shape, generator=gen, device=cuda_device) / 256).to(dtype)
           for _ in range(2)]
    uni = [torch.rand(shape, generator=gen, device=cuda_device, dtype=dtype) for _ in range(2)]
    for a, b in (pix, uni):
        for mode in MODES:
            got = fused_edges.reference_edges(a, b, 0.15, mode)
            want = fused_edges.reference_edges_reference(a, b, 0.15, mode)
            for g, w in zip(got, want):
                assert torch.equal(g, w), mode


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_k11_at_near_ties(cuda_device, mode, dtype):
    """The planted near-ties, one plane a view, a batch of 3 and the tie
    thresholds: K11 decides each as the plain version does, where the
    reciprocal's rule does not (``test_near_ties_tell_a_reciprocal_from_a_divide``)."""
    for seed in range(0, 8, 2):
        a = torch.stack([near_ties(seed + k) for k in range(3)]).to(dtype)
        b = near_ties(seed + 1).to(dtype)
        for thr in (0.2, 0.15, 0.1):
            assert_k11_matches_plain(a[0], b, thr, mode, cuda_device)
            assert_k11_matches_plain(a, a.flip(0), thr, mode, cuda_device)
    if dtype == torch.float32:
        x = near_ties(0)
        assert not torch.equal(reciprocal_edges(x, 0.15, mode).to(cuda_device),
                               fused_edges.reference_edges(x.to(cuda_device),
                                                           x.to(cuda_device), 0.15, mode)[0])


@pytest.mark.cuda
def test_k11_empty_refused_and_narrow_dtypes(cuda_device):
    """Empty planes launch nothing; mixed devices, integer planes, and
    float16, bfloat16 and mixed float planes on the card are refused
    before any launch."""
    before = fused_edges.reference_edges.launches
    for shape in ((0, 5, 7), (2, 0, 7), (2, 5, 0)):
        x = torch.zeros(shape, device=cuda_device)
        el, er = fused_edges.reference_edges(x, x, 0.15)
        assert el.shape == er.shape == shape and el.device == x.device
    x = torch.rand((2, 9, 13), device=cuda_device)
    with pytest.raises(ValueError):
        fused_edges.reference_edges(x, x.cpu(), 0.15)
    with pytest.raises(ValueError):
        fused_edges.reference_edges(x.to(torch.int32), x.to(torch.int32), 0.15)
    for dtype in (torch.float16, torch.bfloat16):
        h = x.to(dtype)
        for mode in MODES:
            with pytest.raises(ValueError, match="float32 or two float64"):
                fused_edges.reference_edges(h, h.flip(-1), 0.15, mode)
        with pytest.raises(ValueError, match="float32 or two float64"):
            fused_edges.reference_edges(h[:, :0], h[:, :0], 0.15)
    with pytest.raises(ValueError, match="float32 or two float64"):
        fused_edges.reference_edges(x, x.double(), 0.15)
    assert fused_edges.reference_edges.launches == before


@pytest.mark.cuda
def test_k11_is_counted_as_a_torch_op(cuda_device):
    """On the profiler's trace K11 is one ``reference_edges_kernel`` op,
    which no pattern of ``stereobench/kernels`` matches."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand((2, 40, 60), device=cuda_device)
    fused_edges.reference_edges(x, x, 0.15)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_edges.reference_edges(x, x, 0.15)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(names) == 1 and "reference_edges_kernel" in names[0], names
    pats = [re.compile(p) for f in ROOT.glob("stereobench/kernels/*.json")
            for p in json.loads(f.read_text())["patterns"]]
    assert pats and not any(p.search(names[0]) for p in pats)


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_reference_rule_forward_equals_the_plain_forward(cuda_device, mode, subpixel):
    """A reference-rule ``ClassicPipeline`` forward on the card equals the
    plain forward (``classic_forward_reference``) on the card and the CPU's
    forward on every plane, and counts one K11 launch a forward (both
    views); the plain forward launches none."""
    params = StereoParams(num_shifts=24, square_width=9, times=6, mode=mode)
    img = torch.stack([near_ties(s, (48, 70)) for s in range(3)])
    left, right = img, torch.roll(img, 3, dims=-1)
    lt, rt = left.to(cuda_device), right.to(cuda_device)
    pipe = build_classic_pipeline(params, subpixel=subpixel)
    tracing.enable()
    got = pipe(lt, rt)
    torch.cuda.synchronize()
    before = fused_edges.reference_edges.launches
    plain = classic.classic_forward_reference(lt, rt, params, subpixel=subpixel)
    torch.cuda.synchronize()
    tracing.disable()
    assert fused_edges.reference_edges.launches == before
    req = tracing.records()["requests"]
    assert req[0]["counters"]["launches.K11"] == 1 and "launches.K11" not in req[1]["counters"]
    cpu = classic.classic_forward_batched(left, right, params, subpixel=subpixel)
    assert sorted(got) == sorted(plain) == sorted(cpu)
    for k in cpu:
        for other in (plain[k].cpu(), cpu[k]):
            assert torch.equal(got[k].cpu().view(torch.int32), other.view(torch.int32)), k
