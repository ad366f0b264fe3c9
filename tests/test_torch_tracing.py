"""The port's tracer (``stereomatching_tpu_torch/utils/tracing.py``): off
by default, on under ``torch.profiler`` or after ``enable()``, the span
tree of each route, the counters, the buffer's bound, the clock it
shares with the profiler, and outputs bitwise the same with it on and
off.  Tiny shapes on the CPU; the last test runs on a CUDA card and
skips without one (``python -m pytest --noconftest
tests/test_torch_tracing.py -m cuda`` there)."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu_torch.models import build_classic_pipeline, build_modern_pipeline
from stereomatching_tpu_torch.models import modern
from stereomatching_tpu_torch.utils import tracing

H, W = 20, 48

# (route name, pipeline builder, input kind, the stages of its forward).
ROUTES = {
    "classic-exact": (lambda: build_classic_pipeline(StereoParams(
        num_shifts=8, square_width=5, mode=BoundaryMode.GHOST, edge_rule="exact")),
        "float", ["match", "diffusion", "contour"]),
    "classic-reference": (lambda: build_classic_pipeline(StereoParams(
        num_shifts=8, square_width=5, mode=BoundaryMode.WRAP, edge_rule="reference"),
        subpixel=True), "float", ["edges", "match", "diffusion", "contour"]),
    "sgm": (lambda: build_modern_pipeline(ModernParams(
        aggregation="sgm", cost="census", num_disparities=16, median_filter=True,
        uniqueness=True)), "int",
        ["census", "volume", "aggregation", "tail", "median", "lr_check", "fill"]),
    "box-sad": (lambda: build_modern_pipeline(ModernParams(
        cost="sad", num_disparities=16, window=5)), "int",
        ["census", "disparity", "lr_check", "fill"]),
    "box-census": (lambda: build_modern_pipeline(ModernParams(
        cost="census", num_disparities=16, window=5, median_filter=True)), "int",
        ["census", "disparity", "median", "lr_check", "fill"]),
}


def _pair(kind, batch=2, device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    px = [torch.from_numpy(rng.integers(0, 256, (batch, H, W))) for _ in range(2)]
    if kind == "float":
        return [(x.to(torch.float32) / 256.0).to(device) for x in px]
    return [x.to(torch.int32).to(device) for x in px]


def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def test_off_by_default_and_records_nothing():
    assert not tracing.on()
    fwd, kind, _ = ROUTES["classic-exact"]
    fwd()(*_pair(kind))
    recs = tracing.records()
    assert recs["spans"] == [] and recs["requests"] == [] and recs["dropped"] == 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_outputs_bitwise_the_same_on_and_off(route):
    build, kind, _ = ROUTES[route]
    fwd, inputs = build(), _pair(kind)
    off = fwd(*inputs)
    tracing.enable()
    on = fwd(*inputs)
    tracing.disable()
    assert list(on) == list(off)
    for k in off:
        assert torch.equal(_bits(on[k]), _bits(off[k])), k
    assert tracing.records()["spans"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_span_tree(route):
    build, kind, stages = ROUTES[route]
    fwd = build()
    tracing.enable()
    fwd(*_pair(kind, batch=2))
    fwd(*_pair(kind, batch=1)[:1] * 2)
    tracing.disable()
    spans = tracing.records()["spans"]
    assert len(spans) == 2 * (1 + len(stages))
    for r in range(2):
        root, *kids = [s for s in spans if s["request"] == r]
        assert (root["name"], root["parent"], root["pairs"]) == ("forward", None, 2 - r)
        assert [s["name"] for s in kids] == stages
        assert all(s["parent"] == root["id"] for s in kids)
        # Stages share their boundaries and lie inside the root.
        assert root["host_start_ns"] <= kids[0]["host_start_ns"]
        for a, b in zip(kids, kids[1:]):
            assert a["host_end_ns"] == b["host_start_ns"]
        assert kids[-1]["host_end_ns"] == root["host_end_ns"]
        assert all(s["device_ms"] is None for s in (root, *kids))
    assert [s["id"] for s in spans] == list(range(len(spans)))
    assert tracing.records()["spans"] == spans  # reading does not clear


def test_on_under_the_profiler_and_a_new_session_clears():
    fwd, kind, _ = ROUTES["classic-exact"]
    pipe, inputs = fwd(), _pair(kind)
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
        pipe(*inputs)
        pipe(*inputs)
    assert not tracing.on()
    assert len(tracing.records()["requests"]) == 2
    pipe(*inputs)  # off: nothing recorded, the records stay
    assert len(tracing.records()["requests"]) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(*inputs)
    recs = tracing.records()
    assert len(recs["requests"]) == 1 and recs["spans"][0]["request"] == 0


def test_the_clock_is_the_profilers():
    """A ``record_function`` range opened inside a span lies within the
    span's host stamps on the profiler's clock."""

    def spin(ns):
        t = time.time_ns()
        while time.time_ns() - t < ns:
            pass

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("forward"):
            spin(200_000)
            with record_function("inside"):
                torch.ones(64).sum()
            spin(200_000)
    tracing.disable()
    start = prof.profiler.kineto_results.trace_start_ns()
    root = tracing.records()["spans"][0]
    inside = [e for e in prof.events() if e.name == "inside"]
    assert len(inside) == 1
    lo, hi = ((root[k] - start) / 1e3 for k in ("host_start_ns", "host_end_ns"))
    assert lo <= inside[0].time_range.start <= inside[0].time_range.end <= hi


@pytest.mark.parametrize("dtype,syncs", [(torch.int32, 1), (torch.uint8, 0)])
def test_host_sync_counts_the_box_sad_pixel_check(dtype, syncs):
    pipe = ROUTES["box-sad"][0]()
    left, right = (x.to(dtype) for x in _pair("int"))
    tracing.enable()
    pipe(left, right)
    tracing.disable()
    (req,) = tracing.records()["requests"]
    assert req["counters"].get("host_sync", 0) == syncs


@pytest.mark.parametrize("d", [16, 264])
def test_plain_stage_follows_plain_stages(d):
    params = ModernParams(aggregation="sgm", cost="census", num_disparities=d)
    left, right = (x[:, :8] for x in _pair("int", batch=1))
    left, right = (torch.cat([x] * 6, dim=-1) for x in (left, right))  # W 288 > D
    tracing.enable()
    build_modern_pipeline(params)(left, right)
    tracing.disable()
    (req,) = tracing.records()["requests"]
    got = {k.split(".", 1)[1] for k in req["counters"] if k.startswith("plain_stage.")}
    assert got == set(modern.plain_stages(params))
    assert got == ({"aggregate"} if d > 256 else set())


def test_the_buffer_is_bounded(monkeypatch):
    pipe, kind, stages = ROUTES["classic-exact"]
    pipe, inputs = pipe(), _pair(kind)
    per = 1 + len(stages)
    monkeypatch.setattr(tracing, "DEFAULT_CAPACITY", per + 2)
    tracing.enable()
    for _ in range(3):
        pipe(*inputs)
    tracing.disable()
    recs = tracing.records()
    assert len(recs["spans"]) == per + 2
    assert recs["dropped"] == 3 * per - (per + 2)
    assert len(recs["requests"]) == 3
    # A kept stage always has its root: the third request kept nothing.
    assert {s["request"] for s in recs["spans"]} == {0, 1}


# ----------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _requests_on_device(ops, checksum):
    """Each request's device ops in a closed loop, split at the checksum's:
    dicts of ``ops`` (the program's) and ``checksum_start`` (us)."""
    out, cur = [], None
    for name, s, e in sorted(ops, key=lambda o: o[1]):
        if checksum.search(name):
            if cur is not None and cur["checksum_start"] is None:
                cur["checksum_start"] = s
            continue
        if cur is None or cur["checksum_start"] is not None:
            cur = {"ops": [], "checksum_start": None}
            out.append(cur)
        cur["ops"].append((name, s, e))
    return out


def _pair_requests(roots, counters, reqs, is_kernel, kernel):
    """(root, device request) index pairs, in order: a device request goes
    with the next root if it holds as many launches of ``kernel`` as that
    root counted; one that holds more merged several roots' requests (the
    profiler lost a checksum's record), and one that holds fewer lost a
    kernel's, so each is skipped with the roots it covers."""
    pairs, j = [], 0
    for g, dev in enumerate(reqs):
        if j >= len(roots):
            break
        want = counters[roots[j]["request"]][f"launches.{kernel}"]
        n = sum(1 for name, _, _ in dev["ops"] if is_kernel(name))
        if n == want:
            pairs.append((j, g))
        j += max(1, round(n / want))
    return pairs


def _online_cell(name, card):
    from stereobench import harness

    cell = harness.load_cell(name)
    return cell.route.program(cell.params), harness.make_pool(cell, 2**31 + 9, card)


def _box_census(card):
    params = ModernParams(cost="census", num_disparities=128, window=9)
    gen = torch.Generator(device=card).manual_seed(9)
    pool = [[torch.randint(0, 256, (1, 1110, 1390), generator=gen, device=card,
                           dtype=torch.int32) for _ in range(2)] for _ in range(3)]
    return build_modern_pipeline(params), pool


# (route, the stage and the kernel it holds, the program and its inputs):
# the online cells' sizes, where the device works longer than the host
# issues, as in the cells whose idle the benchmark puts down to the host.
SGM_STAGES = ["census", "volume", "aggregation", "tail", "lr_check", "fill"]
CARD = [("classic-exact", "match", "K1", lambda c: _online_cell("classic-4k-online", c),
         ROUTES["classic-exact"][2]),
        ("sgm", "aggregation", "K4", lambda c: _online_cell("sgm-mb2005-online", c), SGM_STAGES),
        ("box-census", "disparity", "K7", _box_census, ["census", "disparity", "lr_check", "fill"])]


@pytest.mark.cuda
@pytest.mark.parametrize("route,stage,kernel,make,stages", CARD, ids=[c[0] for c in CARD])
def test_spans_on_the_card(card, route, stage, kernel, make, stages):
    """In a closed loop on the card, each request's root events hold all of
    its device ops and none of the checksum's, and its stage's events hold
    its kernel's launches, placed on the trace by the device alone: the
    root's start event is reached after the request before ended and
    before the request's first op.  The benchmark's ``issue_idle_pct``
    rests on the first.  The outputs are bitwise the same with tracing
    on.  Prints what it read."""
    from stereobench import harness
    from stereobench.metrics import _spans

    pipe, pool = make(card)
    off = pipe(*pool[0])
    torch.cuda.synchronize()
    tracing.enable()
    on = pipe(*pool[0])
    tracing.disable()
    for k in off:
        assert torch.equal(_bits(on[k]), _bits(off[k])), k
    del on, off
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        win = harness.drive(pipe, pool, 1, 2.0, card, poll=False)
    float(win.acc)
    ops = harness.device_ops(prof.events())
    r = harness.read_trace(ops, win.seconds * 1e6, win.requests, win.enqueue_s, None)
    recs = tracing.records()
    roots = _spans.roots(recs)
    reqs = _requests_on_device(ops, harness.CHECKSUM_KERNEL)
    pats = r.kernel_patterns[kernel]

    def is_kernel(name):
        return any(p.search(name) for p in pats)

    counters = {q["request"]: q["counters"] for q in recs["requests"]}
    pairs = _pair_requests(roots, counters, reqs, is_kernel, kernel)
    assert len(roots) == win.requests >= 20 and len(pairs) >= 0.95 * len(roots)
    misses = {"root": [], "stage": []}  # (request, how far outside, us)
    for j, g in pairs:
        root, dev = roots[j], reqs[g]
        (st,) = [s for s in recs["spans"] if s["parent"] == root["id"] and s["name"] == stage]
        assert [s["name"] for s in recs["spans"] if s["parent"] == root["id"]] == stages
        if not g or dev["checksum_start"] is None:
            continue
        # Where the stream reached the root's start event, from the device's
        # side: after the ops before, before the request's first op.
        lo, hi = max(o[2] for o in reqs[g - 1]["ops"]), dev["ops"][0][1]
        d_root = 1e3 * root["device_ms"]
        # Every op of the request before the root's end event, the checksum
        # after it.
        t_lo = max(lo, max(e for _, _, e in dev["ops"]) - d_root)
        t_hi = min(hi, dev["checksum_start"] - d_root)
        if t_lo > t_hi + 2.0:
            misses["root"].append((j, t_lo - t_hi))
        k_ops = [(s, e) for n, s, e in dev["ops"] if is_kernel(n)]
        a, d = 1e3 * st["device_start_ms"], 1e3 * st["device_ms"]
        k_s, k_e = min(s for s, _ in k_ops), max(e for _, e in k_ops)
        t_lo, t_hi = max(lo, k_e - a - d), min(hi, k_s - a)
        if t_lo > t_hi + 2.0:
            misses["stage"].append((j, t_lo - t_hi))
    idle = _spans.idle_in_roots_us(r, recs)
    print(f"{route}: {len(pairs)} of {len(roots)} roots paired on the device, "
          f"{len(misses['root'])} with an op outside the root or the checksum inside, "
          f"{len(misses['stage'])} with a kernel outside its stage; idle inside the roots "
          f"{100 * idle / r.window_us:.2f}% of the window, device idle "
          f"{100 * (1 - r.busy_us / r.window_us):.2f}%")
    # The profiler's device timestamps now and then step against the
    # card's event clock inside a request (up to ~0.1 ms seen): 95% of the
    # requests hold to 2 us, every one to 0.2 ms.
    for kind, m in misses.items():
        assert len(m) <= 0.05 * len(pairs) and all(x < 200 for _, x in m), (kind, m)
    assert 0 <= idle <= r.window_us - r.busy_us


def _c_program(card):
    """The C reference's default program at ``classic-ref-1mp-b32``'s
    settings (wrap, the reference edge rule, 30 shifts) on 1024² × 4."""
    from stereobench import harness

    cell = harness.load_cell("classic-ref-1mp-b32")
    cell.traffic = {**cell.traffic, "batch": 4, "pool": 3}
    return cell.route.program(cell.params), harness.make_pool(cell, 2**31 + 13, card)


@pytest.mark.cuda
def test_the_c_programs_route_on_the_card(card):
    """The C reference's default route on the card: the forward is bitwise
    its plain version and makes no blocking call (CUDA's sync debug mode
    raises on one); each request counts one K11 launch (both views'
    edges), one K8 launch and no plain stage; in a closed loop each
    request's ``edges`` stage holds its ops before K8 and no K8 launch,
    and its ``match`` stage holds K8, placed on the trace as
    ``test_spans_on_the_card`` places them."""
    from stereobench import harness
    from stereobench.metrics import _spans
    from stereomatching_tpu_torch.models.classic import classic_forward_reference

    pipe, pool = _c_program(card)
    got = pipe(*pool[0])
    want = classic_forward_reference(*pool[0], pipe.params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    del got, want
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe(*pool[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        win = harness.drive(pipe, pool, 1, 2.0, card, poll=False)
    float(win.acc)
    ops = harness.device_ops(prof.events())
    recs = tracing.records()
    roots = _spans.roots(recs)
    assert len(roots) == win.requests >= 20
    counters = {q["request"]: q["counters"] for q in recs["requests"]}
    for c in counters.values():
        assert c.get("launches.K8") == 1 and c.get("launches.K11") == 1
        assert not [k for k in c if k.startswith("plain_stage.")], c
    pats = harness.kernel_patterns()["K8"]

    def is_k8(name):
        return any(p.search(name) for p in pats)

    reqs = _requests_on_device(ops, harness.CHECKSUM_KERNEL)
    pairs = _pair_requests(roots, counters, reqs, is_k8, "K8")
    assert len(pairs) >= 0.95 * len(roots)
    misses = []  # (request, how far outside, us)
    for j, g in pairs:
        root, dev = roots[j], reqs[g]
        kids = {s["name"]: s for s in recs["spans"] if s["parent"] == root["id"]}
        assert list(kids) == ["edges", "match", "diffusion", "contour"]
        if not g or dev["checksum_start"] is None:
            continue
        ((k_s, k_e),) = [(s, e) for n, s, e in dev["ops"] if is_k8(n)]
        before = [e for _, s, e in dev["ops"] if s < k_s]
        edges, match = kids["edges"], kids["match"]
        e_end = 1e3 * (edges["device_start_ms"] + edges["device_ms"])
        m_a, m_d = 1e3 * match["device_start_ms"], 1e3 * match["device_ms"]
        # Where the stream reached the root's start event, t: after the ops
        # before and before the request's first op; the edges stage ends at
        # t + e_end after the ops before K8 and before K8; K8 lies inside
        # [t + m_a, t + m_a + m_d].
        lo, hi = max(o[2] for o in reqs[g - 1]["ops"]), dev["ops"][0][1]
        t_lo = max(lo, max(before) - e_end, k_e - m_a - m_d)
        t_hi = min(hi, k_s - e_end, k_s - m_a)
        if t_lo > t_hi + 2.0:
            misses.append((j, t_lo - t_hi))
    print(f"C program: {len(pairs)} of {len(roots)} roots paired, {len(misses)} with K8 "
          f"outside its stage or an edge op outside the edges")
    # The tolerances of test_spans_on_the_card: the profiler's device
    # timestamps step against the card's event clock now and then.
    assert len(misses) <= 0.05 * len(pairs) and all(x < 200 for _, x in misses), misses
