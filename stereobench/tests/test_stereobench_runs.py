"""Whole runs at tiny sizes on the CPU: the harness decides ``correct``
true for the port, false for the control and for a broken program;
the run command refuses without a card; no run loads JAX; and a cell
made of new files alone runs."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from stereobench import control, harness
from stereobench.tests._tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELLS = ["classic-1mp-b32", "sgm-mb2005-b8", "sgm-mb2005-online", "classic-4k-online"]


def _run(cell, program=None, trace=False, seed=2**31 + 11):
    return harness.run(cell, seed, 1.0, trace, CPU, time.perf_counter(), program=program)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_is_correct(name):
    cell = tiny_cell(name)
    r = _run(cell).result
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 3
    assert list(r)[-1] == "checks"
    assert r["checks"]["pairs_checked"]["value"] >= r["checks"]["pairs_checked"]["at_least"]


@pytest.mark.parametrize("name", ["classic-1mp-b32", "sgm-mb2005-online"])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    r = _run(cell, program=control.control_program(cell)).result
    assert not r["correct"]
    assert sum(c["value"] for k, c in r["checks"].items() if k.startswith("mismatched")) > 0


def _stale(program):
    """A step that returns its state unchanged: each call hands back the
    outputs of the call before."""
    last = {}

    def run(left, right):
        out = program(left, right)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return run


def _half_batch(program):
    """Half of the batch left out: the second half's outputs are the
    first half's again."""
    def run(left, right):
        h = max(1, left.shape[0] // 2)
        out = program(left[:h], right[:h])
        return {k: torch.cat([v, v])[: left.shape[0]] if v.ndim else v for k, v in out.items()}

    return run


def _altered(program):
    """An answer altered where it is produced: one element of the first
    plane."""
    def run(left, right):
        out = program(left, right)
        first = next(iter(out))
        plane = out[first].clone()
        flat = plane.view(-1)
        flat[flat.numel() // 2] = 1 - flat[flat.numel() // 2] if plane.dtype == torch.bool \
            else flat[flat.numel() // 2] + 1
        return {**out, first: plane}

    return run


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(name, fault):
    cell = tiny_cell(name)
    if fault is _half_batch and cell.traffic["batch"] < 2:
        cell = tiny_cell(name, batch=2)
    r = _run(cell, program=fault(cell.route.program(cell.params))).result
    assert not r["correct"] and r["failed"] > 0


def test_a_traced_run_on_the_cpu_reads_the_host_span():
    r = _run(tiny_cell("classic-1mp-b32", trace_seconds=0.2), trace=True).result
    assert r["correct"]
    assert set(r["metrics"]) == {"enqueue_ms"}  # no device work to read on the CPU
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _cmd(root, *extra):
    return [sys.executable, str(root / "stereobench" / "run.py"), "--workload",
            "classic-1mp-b32", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0",
            *extra]


def test_the_command_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(_cmd(ROOT), capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def _copy_benchmark(tmp: Path, with_program: bool) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "stereobench", tmp / "stereobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        (tmp / "stereomatching_tpu_torch").symlink_to(ROOT / "stereomatching_tpu_torch")
    return tmp


def test_the_command_refuses_without_the_program(tmp_path):
    root = _copy_benchmark(tmp_path, with_program=False)
    p = subprocess.run(_cmd(root), capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


FORBIDDEN_CHECK = """
import importlib, pkgutil, sys, time, torch
sys.path.insert(0, {root!r})
import stereobench
from stereobench import harness
from stereobench.tests._tiny import tiny_cell
for m in pkgutil.walk_packages(stereobench.__path__, "stereobench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for name in ("classic-1mp-b32", "sgm-mb2005-online"):
    assert harness.run(tiny_cell(name), 5, 0.2, False, torch.device("cpu"),
                       time.perf_counter()).result["correct"]
found = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax",
                                                            "stereomatching_tpu"}})
assert "stereomatching_tpu_torch" in sys.modules
print(found)
"""


def test_no_module_of_jax_is_loaded():
    p = subprocess.run([sys.executable, "-c", FORBIDDEN_CHECK.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import stereobench.reference.classic, stereobench.reference.sgm; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('stereomatching')))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr[-2000:]
    for path in (ROOT / "stereobench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("stereomatching") for n in names)


NEW_CELL = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from stereobench import harness
cell = harness.load_cell("classic-new-tiny")
res = harness.run(cell, 9, 0.5, {trace}, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted(harness.kernel_patterns())))
print(json.dumps(res.result))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_of_new_files_runs(tmp_path, trace):
    """A configuration, a traffic mix, a per-layer metric and a kernel-name
    set added as new files, with entries added to BENCHMARK.json, run
    without an edit to any file the benchmark has."""
    root = _copy_benchmark(tmp_path, with_program=True)
    sb = root / "stereobench"
    before = {p: p.read_bytes() for p in sb.rglob("*") if p.is_file()}
    config = json.loads((sb / "configs/classic-ghost-d64.json").read_text())
    config.update(name="classic-wrap-d8", params={**config["params"], "mode": "wrap",
                                                   "edge_rule": "reference", "num_shifts": 8,
                                                   "square_width": 5})
    (sb / "configs/classic-wrap-d8.json").write_text(json.dumps(config))
    traffic = json.loads((sb / "traffic/stream-1mp-b32.json").read_text())
    traffic.update(name="tiny-b2", height=24, width=40, batch=2, pool=3, check_requests=2,
                   warmup_requests=1, trace_seconds=0.2)
    (sb / "traffic/tiny-b2.json").write_text(json.dumps(traffic))
    (sb / "metrics/enqueue_max_ms.py").write_text(
        'LAYER = "pipeline entry"\nUNIT = "ms"\nSOURCE = "program_span"\n'
        'BETTER = "lower"\nMOVES = "latency_ms_p95"\n\n\n'
        'def read(r):\n    return 1e3 * max(r.enqueue_s) if r.enqueue_s else None\n')
    (sb / "kernels/K10.json").write_text(json.dumps(
        {"kernel": "K10", "source": "stereomatching_tpu_torch/csrc/disparity.cu",
         "computes": "a test's", "patterns": ["no_such_kernel"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "classic-wrap-d8", "source": "https://example.org/x",
                             "file": "stereobench/configs/classic-wrap-d8.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "classic-new-tiny", "config": "classic-wrap-d8",
                               "traffic": "tiny-b2", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "classic-1mp-b32" in m.get("workloads", []):
            m["workloads"].append("classic-new-tiny")
    bench["per_layer"].append({"name": "enqueue_max_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "pipeline entry",
                               "moves": "latency_ms_p95"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", NEW_CELL.format(root=str(root), trace=trace)],
                       capture_output=True, text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    kernels, line = p.stdout.strip().splitlines()[-2:]
    assert "K10" in json.loads(kernels)
    r = json.loads(line)
    assert r["correct"]
    if trace:
        assert {"enqueue_ms", "enqueue_max_ms"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    for path, data in before.items():
        assert path.read_bytes() == data, path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_on_the_card(card, name):
    p = subprocess.run([sys.executable, str(ROOT / "stereobench" / "run.py"), "--workload",
                        name, "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
