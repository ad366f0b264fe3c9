"""One run of one cell: set-up, the measured window, the optional traced
segment, and the comparison with the plain reference that decides
``correct``.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration and traffic, ``configs/<config>.json`` the
route and its parameters, ``routes/<route>.py`` the program's entry, its
input format, its plain reference and its work model,
``traffic/<mix>.json`` the image size, batch, requests in flight and
scenes, ``metrics/<metric>.py`` each per-layer metric's reader and
``kernels/*.json`` the names the port's CUDA kernels carry in the trace.

The loop keeps ``in_flight`` requests queued on the device: request
i + in_flight is issued as soon as request i's completion event has
fired.  A request's latency runs from the host-clock instant it is
issued to the instant the host sees its completion event.  Each
request's outputs are consumed on the device by a small checksum.
The traced segment records the device's activity alone, so that the
host issues its work at the untraced pace.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import re
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from stereobench import scenes, workmodel

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# Samples per output plane in the checksum, about.
CHECKSUM_SAMPLES = 4096
# The checksum works in float64, which the program never uses on the
# device: a device op whose name holds ``double`` is the checksum's.
CHECKSUM_KERNEL = re.compile(r"\bdouble\b")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    route: object
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def params(self) -> Dict:
        return self.config["params"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    route = importlib.import_module(f"stereobench.routes.{config['route']}")

    def applies(metric: Dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name, entry, config, traffic, route,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def kernel_patterns() -> Dict[str, list]:
    """{kernel: [compiled name patterns]} of every ``kernels/*.json``."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        spec = load_json(path)
        out[spec["kernel"]] = [re.compile(p) for p in spec["patterns"]]
    return out


def metric_reader(name: str):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``
    (a name may hold dots, as ``kernel_ms.online``)."""
    module = f"stereobench.metrics.{name.replace('.', '__')}"
    if module not in sys.modules:
        spec = importlib.util.spec_from_file_location(module, HERE / "metrics" / f"{name}.py")
        reader = importlib.util.module_from_spec(spec)
        sys.modules[module] = reader
        spec.loader.exec_module(reader)
    return sys.modules[module]


def end_to_end_value(name: str, win: "Window", batch: int, setup_s: float) -> Optional[float]:
    """The value of the end-to-end metric ``name`` from a window: a name
    ending in ``pairs_per_s`` is the pairs completed over the window's
    seconds, in ``latency_ms_p<q>`` the q-th percentile of the requests'
    latencies in ms, in ``setup_s`` the set-up's seconds (a prefix such
    as ``online_`` names the cells' kind)."""
    if name.endswith("pairs_per_s"):
        return win.requests * batch / win.seconds
    m = re.search(r"latency_ms_p(\d+)$", name)
    if m:
        return 1e3 * percentile(win.latencies_s, int(m.group(1)))
    if name.endswith("setup_s"):
        return setup_s
    return None


# ------------------------------------------------------------------ inputs


def seed_of(seed: int) -> int:
    """The generator's seed: any whole number, folded into 63 bits."""
    return seed % (2**63)


def make_pool(cell: Cell, seed: int, device: torch.device) -> List[Tuple]:
    """``pool`` distinct batches of the cell's scenes, made on ``device``
    from ``seed``, in the program's input format."""
    t = cell.traffic
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    scene = t["scene"]
    if scene["family"] != "layered":
        raise ValueError(f"unknown scene family {scene['family']!r}")
    pool = []
    for _ in range(t["pool"]):
        pair = scenes.layered_batch(gen, t["batch"], t["height"], t["width"],
                                    cell.route.max_shift(cell.params), cell.route.SIGN, scene)
        pool.append(cell.route.inputs(*pair))
    return pool


# ------------------------------------------------------------------ the loop


def _sample(t: torch.Tensor) -> torch.Tensor:
    """About ``CHECKSUM_SAMPLES`` elements of ``t`` as a strided view (no
    copy): every step-th row and column of each image."""
    if t.dim() == 0:
        return t.reshape(1)
    step = max(1, math.ceil(math.sqrt(t.numel() / CHECKSUM_SAMPLES)))
    if t.dim() == 1:
        return t[:: step * step]
    return t[..., ::step, ::step]


def checksum(outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float64 sum of a strided sample of every output plane, on the
    device: each sample copied into one float64 buffer, then summed."""
    parts = [_sample(t) for t in outputs.values()]
    device = parts[0].device
    buf = torch.empty(sum(x.numel() for x in parts), dtype=torch.float64, device=device)
    at = 0
    for x in parts:
        buf[at: at + x.numel()].view(x.shape).copy_(x)
        at += x.numel()
    return buf.sum()


@dataclasses.dataclass
class Window:
    """What one stretch of the loop did."""

    seconds: float = 0.0
    requests: int = 0
    # The checksums' running sum, on the device.
    acc: Optional[torch.Tensor] = None
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    # (request index, pool slot, outputs) of the requests kept for the check.
    kept: List[Tuple[int, int, Dict]] = dataclasses.field(default_factory=list)


def drive(program: Callable, pool: List[Tuple], in_flight: int, seconds: float,
          device: torch.device, keep: int = 0, rng: Optional[random.Random] = None,
          first_slot: int = 0, poll: bool = True) -> Window:
    """Issue requests for ``seconds`` with ``in_flight`` in flight, then
    wait for the last.  ``keep`` outputs are kept by reservoir sampling
    with ``rng`` (every request equally likely).  Every device op between
    the call and its return belongs to the window's requests; the caller
    reads ``win.acc`` afterwards.  ``poll``: wait for a completion by
    polling its event, else by one blocking call, which the driver spins
    in (one CUDA call a request, where a profiler records each poll)."""
    win = Window(acc=torch.zeros((), dtype=torch.float64, device=device))
    acc = win.acc
    pending: deque = deque()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    t_end = t0
    while True:
        while len(pending) < in_flight and time.perf_counter() - t0 < seconds:
            i = win.requests
            slot = (first_slot + i) % len(pool)
            t_issue = time.perf_counter()
            out = program(*pool[slot])
            win.enqueue_s.append(time.perf_counter() - t_issue)
            acc += checksum(out)
            event = torch.cuda.Event() if cuda else None
            if cuda:
                event.record()
            pending.append((t_issue, event))
            if keep:
                if i < keep:
                    win.kept.append((i, slot, out))
                else:
                    j = rng.randrange(i + 1)
                    if j < keep:
                        win.kept[j] = (i, slot, out)
            del out
            win.requests += 1
        if not pending:
            break
        t_issue, event = pending.popleft()
        if cuda and not poll:
            event.synchronize()
        # Poll rather than block: the host sees the event as soon as it
        # fires, without a wake-up from sleep.
        while cuda and not event.query():
            pass
        t_end = time.perf_counter()
        win.latencies_s.append(t_end - t_issue)
    win.seconds = t_end - t0
    return win


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default rule)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ------------------------------------------------------------------ the trace


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""

    enqueue_s: List[float]
    device_ops: List[Tuple[str, float, float]]  # (name, start us, end us) in the window
    checksum_us: float
    window_us: float
    busy_us: float
    pairs: int
    kernel_patterns: Dict[str, list]
    least_s_per_pair: Optional[float]
    idle_gaps: List[Tuple[str, float]]  # (the op the device waited for, idle us)


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """-> (covered length, merged intervals) of (start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def read_trace(ops: List[Tuple[str, float, float]], window_us: float, pairs: int,
               enqueue_s: List[float], least_s: Optional[float]) -> Readings:
    """Readings from the device ops (name, start us, end us) of one traced
    window of ``window_us``, timed by the host's clock from the first
    request's issue to the last one's completion."""
    busy, merged = union_us([(s, e) for _, s, e in ops])
    checksum_us = sum(e - s for name, s, e in ops if CHECKSUM_KERNEL.search(name))
    return Readings(enqueue_s, ops, checksum_us, window_us, busy, pairs, kernel_patterns(),
                    least_s, idle_gaps(ops, merged, window_us - busy))


def idle_gaps(ops, merged, idle_us: float) -> List[Tuple[str, float]]:
    """The device's idle time by the op it waited for: each gap between
    its busy intervals goes to the op that ended it (the host had not yet
    issued it); what is left of ``idle_us`` lies before the first op and
    after the last, while the host issued the first request and saw the
    last one's completion."""
    first = {}
    for name, s, _ in ops:
        first.setdefault(s, name)
    out: Dict[str, float] = {}
    inner = 0.0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        name = first[s1]
        label = "checksum" if CHECKSUM_KERNEL.search(name) else name[:160]
        out[label] = out.get(label, 0.0) + (s1 - e0)
        inner += s1 - e0
    if idle_us - inner > 0:
        out["head and tail of the window"] = idle_us - inner
    return sorted(out.items(), key=lambda kv: -kv[1])


def device_ops(events) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of the profiler's device events."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA]


def traced(program, pool, cell: Cell, device, enqueue_s, least_s) -> Tuple[Readings, Window]:
    """One segment of ``trace_seconds`` under ``torch.profiler`` with the
    device's activity alone; without a card, no device op to read."""
    from torch.profiler import ProfilerActivity, profile

    t = cell.traffic
    ops: List[Tuple[str, float, float]] = []
    gc.collect()
    gc.disable()
    try:
        if device.type == "cuda":
            # CUPTI records every CUDA call: a poll loop would flood it.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                win = drive(program, pool, t["in_flight"], t["trace_seconds"], device,
                            poll=False)
            ops = device_ops(prof.events())
        else:
            win = drive(program, pool, t["in_flight"], t["trace_seconds"], device)
    finally:
        gc.enable()
    float(win.acc)
    readings = read_trace(ops, win.seconds * 1e6, win.requests * t["batch"], enqueue_s,
                          least_s)
    return readings, win


# ------------------------------------------------------------------ the check


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want``: bit patterns for
    float planes, values for integer and bool planes; a plane of another
    shape differs everywhere."""
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel(), 1)
    if got.is_floating_point() or want.is_floating_point():
        a = got.to(torch.float32).contiguous().view(torch.int32)
        b = want.to(torch.float32).contiguous().view(torch.int32)
    else:
        a, b = got.to(torch.int64), want.to(torch.int64)
    return int((a != b).sum())


def check(cell: Cell, pool: List[Tuple], kept: List[Tuple[int, int, Dict]],
          float_dtype: torch.dtype = torch.float32) -> Tuple[Dict[str, Dict], int]:
    """Compare every kept request's planes with the reference on its
    inputs, the kept requests' pairs taken together in blocks of
    ``route.reference_block`` pairs -> (checks, requests that differ)."""
    route, params, t = cell.route, cell.params, cell.traffic
    block = route.reference_block(params, t["height"], t["width"])
    # (kept request, pair) of every pair to check, in order.
    pairs = [(k, i) for k in range(len(kept)) for i in range(t["batch"])]
    diff = [{p: 0 for p in route.PLANES} for _ in kept]
    for b0 in range(0, len(pairs), block):
        part = pairs[b0: b0 + block]
        left = torch.stack([pool[kept[k][1]][0][i] for k, i in part])
        right = torch.stack([pool[kept[k][1]][1][i] for k, i in part])
        want = route.reference(left, right, params, float_dtype)
        for j, (k, i) in enumerate(part):
            out = kept[k][2]
            for p in route.PLANES:
                diff[k][p] += (mismatches(out[p][i], want[p][j]) if p in out
                               else max(want[p][j].numel(), 1))
        del want
    counts = {p: sum(d[p] for d in diff) for p in route.PLANES}
    checks = {f"mismatched_{p}": {"value": n, "at_most": 0} for p, n in counts.items()}
    need = t["check_requests"] * t["batch"]
    checks["pairs_checked"] = {"value": len(pairs), "at_least": need}
    return checks, sum(any(d.values()) for d in diff)


def checks_pass(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["at_most"] if "at_most" in c else c["value"] >= c["at_least"]
               for c in checks.values())


# ------------------------------------------------------------------ one run


@dataclasses.dataclass
class RunResult:
    result: Dict
    checks: Dict[str, Dict]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, program: Optional[Callable] = None,
        describe_device: Optional[Callable[[], Dict]] = None,
        marks: Optional[List[Tuple[str, float]]] = None) -> RunResult:
    """Set up, measure ``seconds``, optionally trace, then check.
    ``program`` replaces the route's entry (the control and the fault
    tests put theirs in its place).  ``marks``: (step, instant) of the
    caller's set-up so far, reported with this set-up's own."""
    t = cell.traffic
    marks = list(marks or [])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pool = make_pool(cell, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("inputs made", time.perf_counter()))
    if program is None:
        program = cell.route.program(cell.params)
    out = program(*pool[0])
    float(checksum(out))
    marks.append(("first request", time.perf_counter()))
    warm = t["warmup_requests"]
    for i in range(1, warm):
        out = program(*pool[i % len(pool)])
        float(checksum(out))
    del out
    if cuda:
        torch.cuda.synchronize(device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    marks.append(("warm", t_ready))

    rng = random.Random(seed)
    # No collection of Python's garbage inside the window: its pauses
    # would land on whichever request is being issued.
    gc.collect()
    gc.disable()
    try:
        win = drive(program, pool, t["in_flight"], seconds, device, keep=t["check_requests"],
                    rng=rng, first_slot=warm)
        float(win.acc)
    finally:
        gc.enable()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    pairs = win.requests * t["batch"]
    metrics = {}
    for m in cell.end_to_end:
        value = end_to_end_value(m["name"], win, t["batch"], setup_s)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(describe_device() if describe_device else {"platform": device.type})
    dev["memory_peak_bytes"] = memory_peak
    steps, prev = [], t_start
    for step, at in marks:
        steps.append(f"{step} {at - prev:.3f}")
        prev = at
    notes = ["set-up s: " + ", ".join(steps),
             f"window {win.seconds:.6f} s, {win.requests} requests, {pairs} pairs, "
             f"latency samples {len(win.latencies_s)}, p50 "
             f"{1e3 * percentile(win.latencies_s, 50):.6f} ms"]
    breakdown = None
    if trace:
        least = workmodel.least_s_per_pair(cell.route.stages(cell.params, t["height"],
                                                             t["width"])) or None
        readings, twin = traced(program, pool, cell, device, win.enqueue_s, least)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = readings.busy_us / 1e6
        dev["window_s"] = readings.window_us / 1e6
        breakdown = breakdown_of(readings)
        notes.append(f"traced {readings.window_us / 1e6:.6f} s, {twin.requests} requests, "
                     f"checksum kernels {readings.checksum_us:.3f} us")
    del program
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, bad = check(cell, pool, win.kept)
    notes.append(f"check {time.perf_counter() - t_check:.3f} s over {len(win.kept)} requests")
    result = {"correct": checks_pass(checks), "attempted": win.requests, "failed": bad,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["notes"] = notes
    result["checks"] = checks
    return RunResult(result, checks)


def breakdown_of(r: Readings) -> Dict[str, list]:
    """The ten device ops that took most time and the ten largest idle
    shares by the op the device waited for, in seconds over the traced
    window."""
    per: Dict[str, float] = {}
    for name, s, e in r.device_ops:
        per[name[:160]] = per.get(name[:160], 0.0) + (e - s) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n[:160], v / 1e6] for n, v in r.idle_gaps[:10]]}
