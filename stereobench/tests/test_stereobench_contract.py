"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from stereobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key])
        for r in e.get("reduced", []):
            assert NAME.match(r)


def test_metrics_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert fours <= max(1, len(cells) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_a_cell_names_loads(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert set(c.config["reduced"]) == set(
        next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])["reduced"])
    for key in ("height", "width", "batch", "in_flight", "pool", "warmup_requests",
                "check_requests", "trace_seconds", "scene"):
        assert key in c.traffic
    assert c.traffic["pool"] > c.traffic["in_flight"]
    for name in ("max_shift", "reference_block", "program", "inputs", "reference", "stages"):
        assert callable(getattr(c.route, name))
    assert c.route.SIGN in (-1, 1) and c.route.PLANES
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_states_what_the_benchmark_says(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = harness.metric_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES, reader.BETTER) == (
        m["layer"], m["unit"], m["source"], m["moves"], m["better"])
    assert callable(reader.read)


def test_kernel_files():
    """Every kernel-name set loads, is named by its file, names a source
    of the program's and has patterns; the set itself is open, so that a
    later file adds a kernel without an edit here."""
    paths = sorted((ROOT / "stereobench" / "kernels").glob("*.json"))
    assert paths
    pats = harness.kernel_patterns()
    assert set(pats) == {path.stem for path in paths}
    for path in paths:
        spec = json.loads(path.read_text())
        assert spec["kernel"] == path.stem
        assert spec["source"].startswith("stereomatching_tpu_torch/csrc/")
        assert (ROOT / spec["source"]).is_file()
        assert spec["patterns"] and all(pats[path.stem])
