"""The cell ``classic-ref-1mp-b32``: the C reference's default program
(wrap boundaries, the float reference edge rule, 30 shifts) on the CPU,
at tiny sizes: the port's route against the plain reference on every
plane, the route's work model by hand, the cell's files, and whole runs
of the harness that come out correct for the port and not correct for
the control or a broken program."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from stereobench import control, harness, scenes, workmodel
from stereobench.routes import classic_ref
from stereobench.tests.test_stereobench_runs import _altered, _half_batch, _stale

ROOT = Path(__file__).resolve().parents[2]
CELL = "classic-ref-1mp-b32"
PARAMS = json.loads(
    (ROOT / "stereobench/configs/classic-wrap-ref-d30.json").read_text())["params"]
# The cell's traffic cut to a CPU run: narrower than num_shifts +
# square_width, so that the match and the box wrap across the image.
TINY = {"height": 24, "width": 40, "batch": 4, "check_requests": 2, "warmup_requests": 2}
CPU = torch.device("cpu")
SEED = 2**31 + 29
INT32, FP32 = 132 * 64 * 1.98e9, 132 * 128 * 1.98e9


def _tiny_cell(**traffic):
    cell = harness.load_cell(CELL)
    cell.traffic = {**cell.traffic, **TINY, **traffic}
    return cell


def _run(cell, program=None, trace=False):
    return harness.run(cell, SEED, 0.5, trace, CPU, time.perf_counter(),
                       program=program).result


def test_the_configuration_is_the_c_programs_defaults():
    from stereomatching_tpu_torch.config import StereoParams

    assert StereoParams.from_json(json.dumps(PARAMS)) == StereoParams()
    assert PARAMS == {"threshold": 0.15, "square_width": 21, "times": 32, "lines": 10,
                      "num_shifts": 30, "mode": "wrap", "edge_rule": "reference"}


# (batch, height, width): the second is narrower than 30 + 21 columns.
@pytest.mark.parametrize("b,h,w", [(2, 48, 96), (1, 64, 40)])
def test_the_ports_cpu_route_equals_the_reference(b, h, w):
    gen = torch.Generator().manual_seed(SEED + w)
    scene = harness.load_json(ROOT / "stereobench/traffic/stream-1mp-b32.json")["scene"]
    pair = scenes.layered_batch(gen, b, h, w, classic_ref.max_shift(PARAMS), classic_ref.SIGN,
                                scene)
    left, right = classic_ref.inputs(*pair)
    got = classic_ref.program(PARAMS)(left, right)
    want = classic_ref.reference(left, right, PARAMS)
    assert set(want) == set(classic_ref.PLANES) <= set(got)
    for p in classic_ref.PLANES:
        assert harness.mismatches(got[p], want[p]) == 0, p
    assert int(want["edges-1"].sum()) > 0 and int(want["score_best"].amax()) > 0


def test_the_work_model_by_hand():
    npix = 1024 * 1024
    st = classic_ref.stages(PARAMS, 1024, 1024)
    assert list(st) == ["edges", "match", "diffusion", "contour"]
    assert classic_ref.EDGE_OPS == 61
    assert st["edges"] == (16 * npix, 2 * 61 * npix, FP32)
    assert st["match"] == (16 * npix, (5 + 2 / 32) * npix * 30, INT32)
    assert st["diffusion"] == (8 * npix, 5 * npix * 31, INT32)
    assert st["contour"] == (8 * npix, 12 * npix, FP32)
    # The edges and the contour bind on bytes, the match and the diffusion
    # on int32 operations.
    least = {k: workmodel.least_s(v) * 1e6 for k, v in st.items()}
    assert least["edges"] == pytest.approx(16 * npix / 3.35e12 * 1e6)
    assert least["match"] == pytest.approx((5 + 2 / 32) * npix * 30 / INT32 * 1e6)
    assert least == pytest.approx({"edges": 5.008, "match": 9.521, "diffusion": 9.717,
                                   "contour": 2.504}, abs=1e-3)
    assert workmodel.least_s_per_pair(st) * 1e6 == pytest.approx(26.749, abs=1e-3)


def test_the_cell_loads():
    cell = harness.load_cell(CELL)
    assert cell.route is classic_ref and cell.params == PARAMS
    assert cell.entry["chips"] == 1 and cell.traffic["name"] == "stream-1mp-b32"
    for name in ("max_shift", "reference_block", "program", "inputs", "reference", "stages"):
        assert callable(getattr(cell.route, name))
    assert cell.route.max_shift(PARAMS) == 29
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "enqueue_ms", "torch_ops_ms", "kernel_ms", "roofline_pct", "device_idle_pct",
        "match_ms", "diffusion_ms", "contour_ms"}


def test_the_port_is_correct():
    r = _run(_tiny_cell())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    assert all(c["value"] == 0 for k, c in r["checks"].items() if k.startswith("mismatched"))


def test_a_traced_run_reads_the_host_span():
    r = _run(_tiny_cell(trace_seconds=0.2), trace=True)
    assert r["correct"] and set(r["metrics"]) == {"enqueue_ms"}  # no device work on the CPU


def test_the_control_is_not_correct():
    cell = _tiny_cell()
    r = _run(cell, program=control.control_program(cell))
    assert not r["correct"]
    assert sum(c["value"] for k, c in r["checks"].items() if k.startswith("mismatched")) > 0


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered])
def test_a_broken_program_is_not_correct(fault):
    cell = _tiny_cell()
    r = _run(cell, program=fault(cell.route.program(cell.params)))
    assert not r["correct"] and r["failed"] > 0
