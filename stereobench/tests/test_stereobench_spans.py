"""The readers of the program's own spans (``metrics/_spans.py`` and the
metrics that read it) on synthetic readings and synthetic span records."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from stereobench import harness
from stereobench.metrics import _spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"
                and m["name"].split(".")[0] not in ("enqueue_ms",)]
STAGES = {"match", "diffusion", "contour", "census", "volume", "aggregation", "tail",
          "lr_check", "fill"}
K1 = "void (anonymous namespace)::match_score_edges_kernel<false, true>(float const*)"
ADD = "void at::native::elementwise_kernel<128, 4>(CUDAFunctor_add<int>)"
SUM = "void at::native::reduce_kernel<512, 1, ReduceOp<double, sum_functor<double> > >()"


def _records(requests):
    """Span records of ``requests``: per request (pairs, host start ns,
    host end ns, {stage: device ms}); the root's device ms is the sum of
    its stages'."""
    spans, reqs = [], []
    for r, (pairs, t0, t1, stages) in enumerate(requests):
        root = len(spans)
        spans.append({"id": root, "name": "forward", "parent": None, "request": r,
                      "host_start_ns": t0, "host_end_ns": t1, "pairs": pairs,
                      "device_ms": None if stages is None else sum(stages.values()),
                      "device_start_ms": 0.0})
        for name, ms in (stages or {}).items():
            spans.append({"id": len(spans), "name": name, "parent": root, "request": r,
                          "host_start_ns": t0, "host_end_ns": t1, "device_ms": ms,
                          "device_start_ms": 0.0})
        reqs.append({"request": r, "counters": {}})
    return {"spans": spans, "requests": reqs, "dropped": 0}


def _readings(ops=(), window_us=0.0, pairs=0):
    return harness.read_trace(list(ops), window_us, pairs, [0.001], None)


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(_spans, "program_records", lambda: recs)
    return use


def test_every_span_metric_is_read_here():
    names = {m.split(".")[0] for m in SPAN_METRICS}
    assert names == {f"{s}_ms" for s in STAGES} | {"issue_idle_pct"}
    assert len(SPAN_METRICS) == 19


@pytest.mark.parametrize("metric", [m for m in SPAN_METRICS if m.split("_ms")[0] in STAGES])
def test_a_stage_reads_device_ms_per_pair(records, metric):
    stage = metric.split("_ms")[0]
    records(_records([(2, 0, 10, {stage: 3.0, "other": 7.0}),
                      (2, 20, 30, {stage: 5.0, "other": 1.0}),
                      (4, 40, 50, {"other": 9.0})]))
    assert harness.metric_reader(metric).read(_readings()) == pytest.approx(8.0 / 4)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_nothing_to_read_without_spans(records, metric):
    ops = [(K1, 10, 40), (SUM, 40, 45)]
    records(None)  # the control, or a program without the tracer
    assert harness.metric_reader(metric).read(_readings(ops, 100.0, 2)) is None
    records(_records([]))
    assert harness.metric_reader(metric).read(_readings(ops, 100.0, 2)) is None
    if metric.split("_ms")[0] in STAGES:  # spans on the CPU have no device time
        stage = metric.split("_ms")[0]
        records(_records([(1, 0, 10, None)]))
        recs = _spans.program_records()
        recs["spans"].append({"id": 1, "name": stage, "parent": 0, "request": 0,
                              "host_start_ns": 0, "host_end_ns": 10, "device_ms": None,
                              "device_start_ms": None})
        assert harness.metric_reader(metric).read(_readings(ops, 100.0, 2)) is None


def test_the_tracers_own_records_are_read():
    import torch

    from stereomatching_tpu_torch.config import StereoParams
    from stereomatching_tpu_torch.models import build_classic_pipeline
    from stereomatching_tpu_torch.utils import tracing

    pipe = build_classic_pipeline(StereoParams(num_shifts=4, square_width=3))
    tracing.enable()
    try:
        pipe(torch.rand(2, 12, 20), torch.rand(2, 12, 20))
    finally:
        tracing.disable()
    got = _spans.roots(_spans.program_records())
    tracing.clear()
    assert len(got) == 1 and got[0]["pairs"] == 2
    assert harness.metric_reader("match_ms").read(_readings()) is None  # no device time


def _closed_loop(n=5, lost=()):
    """A closed loop of ``n`` requests, one in flight, on a trace in us:
    each root's start event is reached 2 us after the request before
    ended (its checksum included); the host then issues an op at +20 us,
    K1 at +60 us (220 us long, with an op that overlaps its end) and
    leaves ``forward``; the stream reaches the root's end event at the
    last op's end, then runs the checksum.  The ops of the requests in
    ``lost`` are missing from the trace, as where the profiler lost them.
    -> (ops, records, window us, device idle us inside the roots)."""
    ops, reqs, idle, t = [(SUM, 0, 1)], [], 0.0, 1.0
    for i in range(n):
        e0 = t + 2
        own = [(ADD, e0 + 20, e0 + 30), (K1, e0 + 60, e0 + 280), (ADD, e0 + 270, e0 + 290)]
        e1 = e0 + 290
        idle += 20 + 30  # [e0, +20) and [+30, +60)
        reqs.append((1, 0, 0, {"match": (e1 - e0) / 1e3}))
        if i not in lost:
            ops += own
        ops += [(SUM, e1 + 3, e1 + 8)]
        t = e1 + 8
    return ops, _records(reqs), t + 5, idle


def test_idle_in_roots_is_the_roots_device_time_less_the_programs_busy_time(records):
    ops, recs, window, idle = _closed_loop()
    r = _readings(ops, window, 5)
    assert _spans.idle_in_roots_us(r, recs) == pytest.approx(idle)
    records(recs)
    got = harness.metric_reader("issue_idle_pct").read(r)
    assert got == pytest.approx(100 * idle / window)
    # The rest of the device's idle lies between the roots.
    assert got < harness.metric_reader("device_idle_pct.online").read(r)


def test_idle_in_roots_needs_device_times_and_device_ops():
    ops, recs, window, _ = _closed_loop()
    r = _readings(ops, window, 5)
    assert _spans.idle_in_roots_us(r, None) is None
    for s in recs["spans"]:
        s["device_ms"] = None  # a run on the CPU
    assert _spans.idle_in_roots_us(r, recs) is None
    only_checksums = [op for op in ops if op[0] == SUM]
    assert _spans.idle_in_roots_us(_readings(only_checksums, window, 5), _closed_loop()[1]) is None


def test_a_request_the_profiler_lost_reads_as_idle():
    """Where the trace lost a request's ops, its root's device time counts
    as idle: the reading errs high by the lost busy time, and no more."""
    ops, recs, window, idle = _closed_loop(n=8)
    lost_ops, _, _, _ = _closed_loop(n=8, lost={3})
    r = _readings(lost_ops, window, 8)
    assert _spans.idle_in_roots_us(r, recs) == pytest.approx(idle + 290 - 50)
