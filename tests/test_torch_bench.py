"""The port's measurement library (``stereomatching_tpu_torch/bench``) and
its tools on the CPU: the thesis model against the JAX one, the harness
and ``python -m stereomatching_tpu_torch.bench`` at 32x48, the roofline's
phase models against the ``utils/bench.py`` bounds they are built from,
the verdict's arithmetic, the halo model against the JAX package's
``ici_phase_model``, the graphs, ``tools/scaling_bench_torch.py`` and
``tools/render_graphs_torch.py``.  No time read here is a device figure:
these tests check control flow and counts."""

import dataclasses
import importlib.util
import itertools
import json
import os
import sys

import pytest

from stereomatching_tpu.bench.harness import pixel_passes as jax_pixel_passes
from stereomatching_tpu.bench.roofline import ici_phase_model
from stereomatching_tpu.config import StereoParams as JStereoParams
from stereomatching_tpu_torch.bench import roofline
from stereomatching_tpu_torch.bench.harness import (
    BenchResult, phase_timings, pixel_passes, size_sweep, time_fn)
from stereomatching_tpu_torch.config import ModernParams, StereoParams
from stereomatching_tpu_torch.utils import bench as ub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = StereoParams(square_width=9, times=4, num_shifts=8, edge_rule="exact")


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bound_ms(m) -> float:
    return max(m["bytes"] / ub.HBM_BYTES_PER_S, roofline.ops_seconds(m)) * 1e3


@pytest.mark.parametrize("sw,times,shifts", itertools.product((1, 9, 21), (0, 32), (1, 30, 64)))
def test_pixel_passes_equals_jax(sw, times, shifts):
    kw = dict(square_width=sw, times=times, num_shifts=shifts)
    assert pixel_passes(StereoParams(**kw)) == jax_pixel_passes(JStereoParams(**kw))
    assert pixel_passes(StereoParams()) == 575


def test_time_fn_and_harness_on_cpu():
    r = time_fn(lambda a: a + 1, (1,), iters=2, warmup=1, name="add", pixels=10, device="cpu")
    assert r.iters == 2 and r.mean_s > 0 and r.pixels_per_s > 0
    sweep = size_sweep([(32, 48), (48, 64)], SMALL, iters=1, device="cpu")
    assert [s.name for s in sweep] == ["48x32", "64x48"] and all(s.mean_s > 0 for s in sweep)
    import numpy as np

    rng = np.random.default_rng(0)
    left, right = (rng.integers(0, 256, (32, 48)).astype(np.float32) / 256 for _ in range(2))
    for plain in (False, True):
        names = [r.name for r in phase_timings(left, right, SMALL, 1, "cpu", plain)]
        assert names == ["edges (per image)", "match+box+argmax (plain)", "diffusion (plain)",
                         "contour", "end-to-end (plain)"]


def test_harness_refuses_cuda_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        size_sweep([(32, 48)], SMALL, iters=1)


def test_bench_cli_runs(capsys):
    from stereomatching_tpu_torch.bench.__main__ import main

    assert main(["--sizes", "32x48", "--phases-size", "32x48", "--iters", "1", "--shifts", "6",
                 "--device", "cpu", "--json"]) == 0
    cap = capsys.readouterr()
    assert cap.err.startswith("# device=cpu power_limit=None")
    assert "per-phase breakdown" in cap.out
    lines = [json.loads(l) for l in cap.out.splitlines() if l.startswith("{")]
    assert [l["phase"] for l in lines if "phase" in l][-1] == "end-to-end (plain)"
    sizes = [l for l in lines if "size" in l]
    assert sizes[0]["size"] == "48x32" and sizes[0]["tier"] == "plain"
    assert sizes[0]["pixels"] == 32 * 48 * pixel_passes(StereoParams(num_shifts=6))


def test_classic_models_are_the_kernel_bounds():
    p = StereoParams(num_shifts=64)
    m = roofline.classic_phase_models(p, 1024, 1024)
    npix = 1024 * 1024
    assert _bound_ms(m["match_score_edges"]) == ub.k1_bound_ms(npix, 64)[0]
    assert _bound_ms(m["match_and_score"]) == ub.k8_bound_ms(npix, 64)[0]
    assert _bound_ms(m["diffusion"]) == ub.k2_bound_ms(npix, 32)[0]
    assert m["match_score_edges"]["bytes"] == 24 * npix
    assert m["match_score_edges"]["ops"] == {"int32_ops_per_s": ub.loop_ops(npix, 64)}
    assert m["edges"]["bytes"] == 16 * npix and m["contour"]["bytes"] == 8 * npix
    parts = ("match_score_edges", "diffusion", "contour")
    assert m["end_to_end"]["bytes"] == sum(m[k]["bytes"] for k in parts)
    assert m["end_to_end"]["ops"] == {
        "int32_ops_per_s": ub.loop_ops(npix, 64) + ub.K2_CELL_OPS * npix * 31,
        "fp32_unfused_ops_per_s": roofline.CONTOUR_OPS * npix}
    # The route's operations take the sum of the phases' operation times.
    assert roofline.ops_seconds(m["end_to_end"]) == pytest.approx(
        sum(roofline.ops_seconds(m[k]) for k in parts), rel=1e-12)


@pytest.mark.parametrize("directions", [4, 8])
def test_sgm_models_are_the_kernel_bounds(directions):
    p = ModernParams(num_disparities=64, aggregation="sgm", cost="census",
                     sgm_directions=directions)
    npix, nvox = 1024 * 1024, 1024 * 1024 * 64
    m = roofline.sgm_phase_models(p, 1024, 1024, filled=1000)
    assert _bound_ms(m["volume"]) == ub.k3_bound_ms(npix, 64, 1, "census")[0]
    assert _bound_ms(m["aggregation"]) == ub.k4_bound_ms(nvox, directions, 1, 2)[0]
    assert _bound_ms(m["tail"]) == ub.k5_bound_ms(npix, 64, 2)[0]
    assert _bound_ms(m["fill"]) == ub.k6_bound_ms(npix, 1000)[0]
    assert m["aggregation"]["bytes"] == (3 + (directions - 1) * 5) * nvox


def test_k4_bound_is_the_one_pass_per_path_floor():
    nvox = 8 * 1024 * 1024 * 64
    for paths, per_voxel in ((4, 3 + 3 * 5), (8, 3 + 7 * 5)):
        ms, by = ub.k4_bound_ms(nvox, paths, 1, 2)
        assert by == "bytes" and ms == pytest.approx(per_voxel * nvox / ub.HBM_BYTES_PER_S * 1e3)


def test_verdict_arithmetic():
    peaks = roofline.Peaks(int32_ops_per_s=1e12)
    model = {"bytes": 3.35e9, "ops": {"int32_ops_per_s": 1e12}}  # 1 ms of bytes, 1 s of ops
    v = roofline.verdict("x", 2.0, model, peaks, power_limit="700.00 W")
    assert v["bound_by"] == "operations" and v["bound_ms"] == pytest.approx(1000.0)
    assert v["share_of_bound_pct"] == pytest.approx(50.0) and v["x_from_bound"] == 2.0
    assert v["achieved_gbps"] == pytest.approx(3.35 / 2) and v["mbytes"] == 3350.0
    assert v["gops"] == 1000.0 and v["power_limit"] == "700.00 W"
    v = roofline.verdict("y", 0.002, dict(model, ops={"int32_ops_per_s": 1e6}), peaks)
    assert v["bound_by"] == "bytes" and v["share_of_bound_pct"] == pytest.approx(50.0)
    # Two units: their times add.
    two = {"bytes": 0.0, "ops": {"int32_ops_per_s": 1e12, "popc_per_s": peaks.popc_per_s}}
    assert roofline.verdict("w", 4.0, two, peaks)["bound_ms"] == pytest.approx(2000.0)
    with pytest.raises(ValueError, match="below its bound"):
        roofline.verdict("z", 0.5, model, peaks)


def test_measure_runs_on_cpu():
    rows = roofline.measure(h=32, w=48, d=8, batch=2, iters=1, device="cpu")
    assert [r["phase"] for r in rows] == ["edges", "match_and_score", "match_score_edges",
                                          "diffusion", "contour", "end_to_end",
                                          "end_to_end_reference"]
    rows = roofline.measure_sgm(h=32, w=48, d=8, batch=2, iters=1, device="cpu")
    assert [r["phase"] for r in rows] == ["census", "volume", "aggregation", "tail",
                                          "lr_check", "fill", "end_to_end"]
    assert all(r["power_limit"] is None for r in rows)


@pytest.mark.parametrize("rule,plain", [("exact", False), ("reference", False),
                                        ("exact", True), ("reference", True)])
def test_classic_stages_chain_to_the_pipeline(rule, plain):
    """The stage table run in order gives the pipeline's contour bands."""
    import numpy as np
    import torch

    from stereomatching_tpu_torch.models.classic import build_classic_pipeline

    params = dataclasses.replace(SMALL, edge_rule=rule)
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.integers(0, 256, (2, 32, 48)).astype(np.float32) / 256)
            for _ in range(2))
    stages = roofline.classic_stages(params, plain)
    head = ["edges", "match_and_score"] if rule == "reference" else ["match_score_edges"]
    assert list(stages) == head + ["diffusion", "contour"]
    inputs, (bands,) = roofline.run_stages(stages, (a, b))
    assert list(inputs) == list(stages) and inputs[head[0]] == (a, b)
    assert torch.equal(bands, build_classic_pipeline(params)(a, b)["output-0"])
    maps = roofline.classic_stages(params, plain, edge_maps=True)
    assert list(maps)[:2] == ["edges", "match_and_score"]
    assert torch.equal(roofline.run_stages(maps, (a, b))[1][0], bands)


@pytest.mark.parametrize("fields,names", [
    (dict(aggregation="sgm", cost="census"),
     ["census", "volume", "aggregation", "tail", "lr_check", "fill"]),
    (dict(aggregation="sgm", cost="census", sgm_directions=8, median_filter=True,
          uniqueness=True),
     ["census", "volume", "aggregation", "tail", "uniqueness", "median", "lr_check", "fill"]),
    (dict(), ["disparity_left", "disparity_right", "lr_check", "fill"]),
    (dict(cost="census", median_filter=True),
     ["census", "disparity_left", "disparity_right", "median", "lr_check", "fill"]),
])
def test_modern_stages_chain_to_the_pipeline(fields, names):
    """The stage table run in order gives the pipeline's filled plane."""
    import numpy as np
    import torch

    from stereomatching_tpu_torch.models.modern import build_modern_pipeline

    params = ModernParams(num_disparities=8, **fields)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.integers(0, 256, (2, 24, 40))).to(torch.int32)
            for _ in range(2))
    stages = roofline.modern_stages(params)
    assert list(stages) == names
    _, (filled,) = roofline.run_stages(stages, (a, b))
    assert torch.equal(filled, build_modern_pipeline(params)(a, b)["filled"])


@pytest.mark.parametrize("times,sw,d,mode", [(32, 21, 64, "ghost"), (4, 9, 8, "wrap")])
def test_halo_model_against_jax_exchange_table(times, sw, d, mode):
    """Where the two exchange tables agree, the same payload per round and
    the same rounds; each difference named:
    (a) the port exchanges the two images (maps) one at a time and each
        direction in a round of its own (``DistComm.shift`` waits for its
        send and receive), where the JAX model counts one round for both;
    (b) the port exchanges the right edge map after extending it by
        num_shifts columns (``prehalo_blocks``)."""
    rows, w, batch = 256, 1024, 2
    kw = dict(times=times, square_width=sw, num_shifts=d, edge_rule="exact")
    port = roofline.halo_phase_model(StereoParams(**kw, mode=mode), w, batch)
    jax = ici_phase_model(JStereoParams(**kw), rows, w, batch)
    assert port.keys() == jax.keys()
    # Agreeing: the contour's two all-reduces, bytes and rounds.
    for k in ("bytes", "exchanges"):
        assert port["contour_reduce"][k] == jax["contour_reduce"][k]
    # Payload per round agrees for the edges and the diffusion; (a) the rounds.
    for name, per_round in (("edges_halo", 4), ("diffusion_halo", 2)):
        assert port[name]["bytes"] / port[name]["exchanges"] == jax[name]["bytes"]
        assert port[name]["exchanges"] == per_round * jax[name]["exchanges"] or (
            jax[name]["exchanges"] == 0 and port[name]["exchanges"] == 0)
    # The box halos: (a) 4 rounds for 1, (b) the right map's D extra columns.
    assert port["boxfilter_halo"]["exchanges"] == 4 * jax["boxfilter_halo"]["exchanges"]
    assert port["boxfilter_halo"]["bytes"] == (
        2 * jax["boxfilter_halo"]["bytes"] + 2 * (sw // 2) * d * 4 * batch)
    for m in port.values():
        assert m["us"] == pytest.approx(
            m["exchanges"] * roofline.Peaks().exchange_latency_us
            + m["bytes"] / ub.NVLINK_BYTES_PER_S_EACH_WAY * 1e6)


def test_weak_scaling_per_shard_cost_flat_in_n():
    p = StereoParams(num_shifts=64, edge_rule="exact")
    pred = roofline.weak_scaling_prediction(p, 256, 1024, batch=2, shard_counts=(1, 2, 4, 8, 16))
    assert pred[0]["predicted_efficiency"] == 1.0 and pred[0]["t_halo_us"] == 0.0
    halos = {r["t_halo_us"] for r in pred[1:]}
    comps = {r["t_compute_us_bound"] for r in pred}
    assert len(halos) == 1 and len(comps) == 1  # the halo and compute per shard: flat in N
    # The output gather (not in the JAX tier) grows with N, and so only the
    # efficiency falls past N = 2.
    gathers = [r["t_gather_us"] for r in pred[1:]]
    assert gathers == sorted(gathers) and gathers[0] < gathers[-1]
    effs = [r["predicted_efficiency"] for r in pred]
    assert effs == sorted(effs, reverse=True) and all(0 < e <= 1 for e in effs)
    assert all(r["compute_from"] == "bound" for r in pred)
    # A measured 1-shard time in place of the bound: the same exchanges.
    slow = roofline.weak_scaling_prediction(p, 256, 1024, batch=2, shard_counts=(1, 2),
                                            compute_us=5000.0)
    assert slow[1]["t_compute_us"] == 5000.0 and slow[1]["compute_from"] == "measured"
    assert slow[1]["t_halo_us"] == pred[1]["t_halo_us"]
    assert slow[1]["predicted_efficiency"] == pytest.approx(
        5000.0 / (5000.0 + pred[1]["t_halo_us"] + pred[1]["t_gather_us"]))
    assert roofline.main(["--ici"]) == 0


def test_graphs_written(tmp_path):
    pytest.importorskip("matplotlib")
    from stereomatching_tpu_torch.bench.graphs import speedup_graph, throughput_graph, times_graph

    rs = [BenchResult("48x32", 0.01, 0.009, 0.001, 3, pixels=48 * 32 * 575),
          BenchResult("64x48", 0.02, 0.019, 0.001, 3, pixels=64 * 48 * 575)]
    r2 = [dataclasses.replace(r, mean_s=r.mean_s / 4) for r in rs]
    assert times_graph({"plain": rs, "kernels": r2}, str(tmp_path / "t.png"))
    assert speedup_graph(rs, r2, str(tmp_path / "s.png"))
    assert throughput_graph(rs, str(tmp_path / "th.png"))
    assert os.path.getsize(tmp_path / "t.png") > 0


def test_graphs_without_matplotlib(tmp_path, monkeypatch):
    from stereomatching_tpu_torch.bench import graphs

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.warns(UserWarning, match="matplotlib unavailable"):
        assert graphs.times_graph({"x": []}, str(tmp_path / "t.png")) is False


def test_scaling_tool_on_cpu(capsys):
    tool = _tool("scaling_bench_torch")
    assert tool.main(["--device", "cpu", "--rows-per-shard", "16", "--width", "48",
                      "--disparities", "8", "--batch", "1", "--iters", "1",
                      "--max-shards", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and [r["shards"] for r in out["results"]] == [1, 2]
    assert [r["height"] for r in out["results"]] == [16, 32]
    assert out["results"][0]["weak_scaling_efficiency"] == 1.0
    # The shards stacked on one device exchange by slicing: no NVLink model.
    assert [r["model_efficiency"] for r in out["results"]] == [1.0, None]
    assert out["model_exchange_latency_us"] == roofline.Peaks().exchange_latency_us


def test_render_tool(tmp_path):
    pytest.importorskip("matplotlib")
    log = tmp_path / "bench.log"
    rec = {"mean_s": 0.01, "min_s": 0.009, "std_s": 0.001, "iters": 3, "pixels": 1000,
           "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    lines = ["# a header line", "== size sweep (end-to-end) =="]
    for tier, scale in (("kernels", 1), ("plain", 20)):
        for size in ("240x135", "480x270"):
            lines.append(json.dumps({**rec, "size": size, "tier": tier,
                                     "mean_s": rec["mean_s"] * scale}))
    log.write_text("\n".join(lines) + "\n")
    out = tmp_path / "graphs"
    assert _tool("render_graphs_torch").main([str(log), "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == [
        "speedup_NVIDIA_H100_80GB_HBM3.png", "throughput_NVIDIA_H100_80GB_HBM3_kernels.png",
        "throughput_NVIDIA_H100_80GB_HBM3_plain.png", "times.png"]
