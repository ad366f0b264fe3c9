"""The yardstick's parts: the work model against hand counts, the scene
generator, the plain reference against the port's CPU route, and the
reading of a trace."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from stereobench import harness, scenes, workmodel
from stereobench.reference import classic as ref_classic
from stereobench.reference import sgm as ref_sgm

ROOT = Path(__file__).resolve().parents[2]
CLASSIC = json.loads((ROOT / "stereobench/configs/classic-ghost-d64.json").read_text())["params"]
SGM = json.loads((ROOT / "stereobench/configs/sgm-census4-d256.json").read_text())["params"]
INT32, POPC = 132 * 64 * 1.98e9, 132 * 16 * 1.98e9


def test_classic_work_by_hand():
    st = workmodel.classic_stages({**CLASSIC, "num_shifts": 2, "times": 3}, 4, 8)
    assert st["match"] == (768, (5 + 1 / 16) * 32 * 2, INT32)
    assert st["diffusion"] == (256, 5 * 32 * 2, INT32)
    assert st["contour"] == (256, 12 * 32, 132 * 128 * 1.98e9)
    assert workmodel.least_s(st["match"]) == max(768 / 3.35e12, 324 / INT32)


def test_sgm_work_by_hand():
    st = workmodel.sgm_stages({**SGM, "num_disparities": 32}, 2, 3)
    assert workmodel.sgm_dtype_bytes({**SGM, "num_disparities": 32}) == (1, 2)
    assert st["census"] == (96, 864, INT32)
    assert st["volume"] == (240, 192, POPC)
    assert st["aggregation"] == (576, 6912, INT32)
    assert st["tail"] == (480, 768, INT32)
    assert st["lr_check"] == (54, 48, INT32)
    assert workmodel.least_s(st["fill"]) == 54 / 3.35e12
    total = sum(workmodel.least_s(w) for w in st.values())
    assert workmodel.least_s_per_pair(st) == total


@pytest.mark.parametrize("change", [{}, {"num_disparities": 48}, {"sgm_p2": 120},
                                    {"sgm_directions": 8}, {"cost": "sad"},
                                    {"census_window": 3, "sgm_directions": 8, "sgm_p2": 4000}])
def test_storage_rule_matches_the_program(change):
    from stereomatching_tpu_torch.config import ModernParams
    from stereomatching_tpu_torch.models.modern import _sgm_out_dtype, _sgm_storage_dtype

    params = {**SGM, **change}
    mp = ModernParams.from_json(json.dumps(params))
    sizes = tuple(torch.tensor([], dtype=f(mp)).element_size()
                  for f in (_sgm_storage_dtype, _sgm_out_dtype))
    assert workmodel.sgm_dtype_bytes(params) == sizes


@pytest.mark.parametrize("sign", [-1, 1])
def test_scenes_deterministic_and_layered(sign):
    spec = {"regions": 3, "background_shift": [0.1, 0.3], "foreground_shift": [0.5, 1.0],
            "region_size": [0.1, 0.3]}

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return scenes.layered_batch(gen, 2, 30, 50, 12, sign, spec)

    a, b = make(2**31 + 7), make(2**31 + 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == torch.uint8 and a[0].shape == (2, 30, 50)
    c = make(2**31 + 8)
    assert not torch.equal(a[0], c[0])
    # The background's rows match at its own shift somewhere in every image.
    left, right = a
    found = []
    for i in range(2):
        best = max(range(13), key=lambda d: int(
            (right[i, :, max(0, -sign * d): 50 - max(0, sign * d)]
             == left[i, :, max(0, sign * d): 50 - max(0, -sign * d)]).sum()))
        found.append(best)
    assert all(0 <= d <= 12 for d in found)


def _classic_params(**kw):
    return {**CLASSIC, "num_shifts": 8, "square_width": 5, "times": 9, "lines": 4, **kw}


@pytest.mark.parametrize("kw", [{}, {"mode": "wrap", "edge_rule": "reference"},
                                {"mode": "wrap"}, {"edge_rule": "reference"}])
def test_classic_reference_equals_the_ports_cpu_route(kw):
    from stereomatching_tpu_torch.config import StereoParams
    from stereomatching_tpu_torch.models.classic import classic_forward_batched

    params = _classic_params(**kw)
    gen = torch.Generator().manual_seed(5)
    spec = {"regions": 3, "background_shift": [0.1, 0.3], "foreground_shift": [0.5, 1.0],
            "region_size": [0.1, 0.3]}
    left, right = (x.to(torch.float32) / 256 for x in
                   scenes.layered_batch(gen, 2, 24, 40, 7, -1, spec))
    got = classic_forward_batched(left, right, StereoParams.from_json(json.dumps(params)))
    want = ref_classic.forward(left, right, params)
    assert set(want) <= set(got)
    for k in want:
        assert harness.mismatches(got[k], want[k]) == 0, k


@pytest.mark.parametrize("kw", [{"num_disparities": 32}, {"num_disparities": 24},
                                {"num_disparities": 16, "sgm_directions": 8},
                                {"num_disparities": 16, "census_window": 3, "lr_max_diff": 0,
                                 "fill_iterations": 40}])
def test_sgm_reference_equals_the_ports_cpu_route(kw):
    from stereomatching_tpu_torch.config import ModernParams
    from stereomatching_tpu_torch.models.modern import modern_forward

    params = {**SGM, **kw}
    gen = torch.Generator().manual_seed(6)
    spec = {"regions": 3, "background_shift": [0.05, 0.3], "foreground_shift": [0.5, 1.0],
            "region_size": [0.1, 0.3]}
    left, right = (x.to(torch.int32) for x in
                   scenes.layered_batch(gen, 2, 20, 44, params["num_disparities"] - 1, 1, spec))
    got = modern_forward(left, right, ModernParams.from_json(json.dumps(params)))
    want = ref_sgm.forward(left, right, params)
    for k in want:
        assert harness.mismatches(got[k], want[k]) == 0, k


def test_mismatches_counts_bits_values_and_shapes():
    a = torch.tensor([0.0, 1.0, float("nan")])
    assert harness.mismatches(a, a.clone()) == 0
    assert harness.mismatches(a, torch.tensor([-0.0, 1.0, float("nan")])) == 1
    assert harness.mismatches(torch.tensor([1, 2], dtype=torch.int16),
                              torch.tensor([1, 3], dtype=torch.int32)) == 1
    assert harness.mismatches(torch.zeros(2, 3), torch.zeros(3, 2)) == 6


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reading_a_trace():
    from torch.autograd import DeviceType

    k1 = "void (anonymous namespace)::match_score_edges_kernel<false, true>(float const*)"
    add = "void at::native::elementwise_kernel<128, 4>(CUDAFunctor_add<int>)"
    total = "void at::native::reduce_kernel<512, 1, ReduceOp<double, sum_functor<double> > >()"
    events = [
        _event("aten::add", 2, 8, DeviceType.CPU),  # a host op: not the device's
        _event(k1, 10, 40, DeviceType.CUDA),
        _event(add, 40, 50, DeviceType.CUDA),
        _event(total, 60, 63, DeviceType.CUDA),
        _event(k1, 80, 95, DeviceType.CUDA),
    ]
    ops = harness.device_ops(events)
    assert [o[1] for o in ops] == [10, 40, 60, 80]
    r = harness.read_trace(ops, 100.0, 2, [0.001, 0.003], 1e-5)
    assert r.window_us == 100 and r.busy_us == 58 and r.checksum_us == 3
    read = {m: harness.metric_reader(m).read(r) for m in
            ("enqueue_ms", "kernel_ms", "torch_ops_ms", "roofline_pct", "device_idle_pct")}
    assert read["enqueue_ms"] == pytest.approx(2.0)
    assert read["kernel_ms"] == pytest.approx(45 / 2 / 1e3)
    assert read["torch_ops_ms"] == pytest.approx(10 / 2 / 1e3)
    assert read["roofline_pct"] == pytest.approx(100 * 1e-5 / (58e-6 / 2))
    assert read["device_idle_pct"] == pytest.approx(42.0)
    gaps = dict(r.idle_gaps)
    assert gaps == {"checksum": 10, k1: 17, "head and tail of the window": 15}
    br = harness.breakdown_of(r)
    assert br["device_ops"][0][0] == k1 and br["device_ops"][0][1] == pytest.approx(45e-6)
    assert br["idle_gaps"][0] == [k1, pytest.approx(17e-6)] and len(br["idle_gaps"]) == 3


def test_the_checksum_reads_a_strided_sample_in_float64():
    planes = {"a": torch.arange(2 * 300 * 500, dtype=torch.int32).reshape(2, 300, 500),
              "b": torch.ones(7, dtype=torch.bool), "c": torch.tensor(2.5)}
    parts = [harness._sample(t) for t in planes.values()]
    assert parts[0].data_ptr() == planes["a"].data_ptr() and parts[0].stride()[-1] == 9
    assert 4096 / 2 <= parts[0].numel() <= 4096 * 2
    want = sum(x.to(torch.float64).sum() for x in parts)
    got = harness.checksum(planes)
    assert got.dtype == torch.float64 and float(got) == float(want)


def test_readers_find_nothing_without_device_work():
    r = harness.Readings([], [], 0.0, 100.0, 0.0, 0, harness.kernel_patterns(), None, [])
    for m in ("enqueue_ms", "kernel_ms", "torch_ops_ms", "roofline_pct", "device_idle_pct"):
        assert harness.metric_reader(m).read(r) is None


def test_percentile_is_numpys_default():
    import numpy as np

    v = [3.0, 1.0, 7.0, 2.0, 9.0, 4.0]
    assert harness.percentile(v, 95) == pytest.approx(float(np.percentile(v, 95)))
