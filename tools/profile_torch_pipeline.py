#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port on one NVIDIA GPU, at the
bench shapes: the classic pipeline (ghost mode, exact rule, 1024x1024,
64 shifts), its reference-rule route (the CLI's default: wrap mode, the
reference edge rule) or one route of the modern pipeline at 1024x1024,
D=64: the SGM route (census, 4 paths), the box route (``ModernParams()``:
SAD, window 9) or the 8-direction quality stack (census, 8 paths, median,
uniqueness).

    python3 tools/profile_torch_pipeline.py                   # classic
    python3 tools/profile_torch_pipeline.py --pipeline reference  # reference rule
    python3 tools/profile_torch_pipeline.py --pipeline sgm    # SGM route
    python3 tools/profile_torch_pipeline.py --pipeline box    # box route
    python3 tools/profile_torch_pipeline.py --pipeline sgm8   # 8-direction stack
    python3 tools/profile_torch_pipeline.py --pipeline sgm --mesh 1x4   # sharded tier
    python3 tools/profile_torch_pipeline.py --k1-against DIR  # K1 against another K1
    python3 tools/profile_torch_pipeline.py --k8-against DIR  # K8 and K9 against others
    python3 tools/profile_torch_pipeline.py --k4-against DIR [DIR ...]  # K4 against others
    python3 tools/profile_torch_pipeline.py --k7-against DIR [DIR ...]  # K7 against others
    python3 tools/profile_torch_pipeline.py --k5-against DIR [DIR ...]  # K5 against others
    python3 tools/profile_torch_pipeline.py --k2-against DIR [DIR ...]  # K2 against others
    python3 tools/profile_torch_pipeline.py --k6-against DIR [DIR ...]  # K6 against others
    python3 tools/profile_torch_pipeline.py --k3-against DIR [DIR ...]  # K3 against others

Classic:
Prints the card's ``nvidia-smi`` name and power limit, then one line per
reading:

- device-resident ms/pair of ``ClassicPipeline`` at batch 1, 8 and 32:
  5 repeats of 5 iterations each, timed with CUDA events, and the peak
  device memory of that batch;
- ``torch.profiler`` over 3 batches of 8: device time per kernel name
  (total, share, per launch) and the device's busy share (union of the
  kernel intervals over the span from the first kernel's start to the
  last one's end);
- a split of one batch-8 forward into its stages, each timed with CUDA
  events (exact rule: K1, K2, contour; reference rule: the torch edge
  maps of both images, K8, K2, contour);
- ``Matcher`` (uint8 numpy in, numpy out) at batch 8, three runs, and
  the split of one run into host u8->f32, host-to-device copy, pipeline
  and device-to-host copy + numpy, each step synchronised.

Modern routes (``--pipeline sgm``, ``box``, ``sgm8``): the same three
readings for ``ModernPipeline`` at batch 1, 8 and 32, the profiler over
3 batches of 32 (bench.py's SGM batch), a split of one batch-32 forward
into its stages, each timed with CUDA events (SGM: census transform, K3
volume, K4 paths, K5 tail, then the torch median and uniqueness ratio
where the params ask for them, the torch LR check, K6 fill; box: K7 for
each reference view, the torch LR check, K6 fill), and ``ModernMatcher``
at batch 8 split into host pixel checks, host-to-device copy (uint8),
pipeline (with the widening to int32) and device-to-host copy + numpy.

With ``--mesh DATAxROWS`` (any route) the sharded tier instead, its
shards all on ``cuda:0``: device-resident ms/pair of the sharded pipeline
beside the single-device one at batch 8 (5 repeats each), and the
profiler over 3 sharded batches of 8 (device time per kernel name, busy
share).

With ``--k1-against DIR`` (``DIR`` holds another ``match_score_edges.cu``
with the headers it includes, e.g. an earlier commit's, unpacked by
``git show``) K1 against that version in one process: both built by
``nvcc`` with the port's flags (the other into a temporary directory),
outputs compared bitwise, device ms per batch of 8 (ghost, exact rule,
1024x1024, 64 shifts, sw 21, with and without the sub-pixel plane) timed
in turns other, this, this, other (CUDA events over 10 launches after a
warmup), and the shared-memory loads, stores and barriers in each
kernel's SASS (``cuobjdump -sass``): in total and in each loop.

With ``--k8-against DIR`` (``DIR`` holds another ``match_and_score.cu``
and the ``match_loop.cuh`` it includes, e.g. the parent commit's,
unpacked by ``git show``) K8 and K9 against that version in one process:
both built by ``nvcc`` with the port's flags, then at the bench instance
(8 random 1024x1024 pairs, D=64, sw 21) K8 on their reference-rule edge
maps (ghost and wrap, with and without the sub-pixel plane) and K9 on
their data 2 x rows 4 halo blocks (exact rule, ghost and wrap), each
instance's planes compared bitwise between the libraries and timed in
turns other, this, this, other (CUDA events over 10 launches after a
warmup) beside its bound (``utils/bench.py``); and the shared-memory
loads, stores, barriers and all instructions of each kernel's SASS, in
total and in each loop, and their registers.

With ``--k4-against DIR [DIR ...]`` (each ``DIR`` holds another
``sgm_directional.cu``: the parent's, or a trial source) K4 against those
versions in one process.  At the bench instance, the census int8 volume
of 8 random pairs (1024x1024, D=64, int16 aggregate): every library's
outputs compared bitwise with this one's (each of the 8 passes written
and added, the 4- and 8-path sums, a seeded column launch's L and carry),
then each pass, the two sums and a seeded column launch on a
[8, 256, 1024, 64] shard timed in turns (the others, this, then the same
in reverse; CUDA events over 10 launches, 5 for the sums after a
warmup), each pass beside the bytes it must move, its GB/s and its floor
at 3.35 TB/s.  Then at each instance of ``K4_SWEEP`` (D 64, 128 and 256;
int8 / int16, int16 / int16 and int32 / int32 volume / aggregate; random
costs at 8x1024x1024): the 8-path sum compared bitwise, then rows written
and added, a diagonal family added and the 4- and 8-path sums timed in
turns beside their byte floors.  For each library: the global loads and
stores, cp.async copies (``LDGSTS``), shared loads, ``REDUX``, ``SHFL``
and all instructions of the bench instance's SASS (each loop's in
address order), and every instance's registers and local memory
(``cuobjdump -res-usage``).

With ``--k7-against DIR [DIR ...]`` (each ``DIR`` holds another
``disparity.cu``: the parent's, or a trial source) K7 against those
versions in one process, at each instance of
``stereomatching_tpu_torch.utils.bench.K7_SWEEP`` (8 random 1024x1024
pairs; SAD windows 1, 5, 9, 15, 31 and 101 at D=64, window 9 at D=128
and 256; census codes of the 5x5 transform at 14 windows and D, 6 of
them on the strips, 8 on the tiles): every
library's disparity, subpixel and cost planes compared bitwise with this
one's for both reference views, then the left view timed in turns (the
others, this, then the same in reverse; CUDA events over 10 launches
after a warmup, 3 from window 50) beside the instance's bound.  For each
library: the shared-memory loads and stores, barriers, shuffles,
``REDUX`` and all instructions of the SAD kernels' SASS (in total and in
each loop), and every kernel's registers and local memory.  A trial
source with ``MIN_CENSUS_STRIP_WARPS = 1`` takes the census strips
wherever they fit, so beside it the census instances show where the
route rule's choice wins.

With ``--k5-against DIR [DIR ...]`` (each ``DIR`` holds another
``sgm_tail.cu``: the parent's, or a trial source) K5 against those
versions in one process, at each instance of ``K5_SWEEP`` (random costs
0..2999; int16 at D 64 with and without the second best, 128, 256, 37 and
100; int32 at D 64 and 256; batch 8 up to D=64, nvox held from there):
every library's planes compared bitwise with this one's, then timed in
turns beside ``k5_bound_ms``, with the route ``k5_route`` takes; and each
library's shared loads and stores, barriers, ``cp.async`` copies
(``LDGSTS``), ``REDUX``, ``SHFL`` and all instructions per kernel and
loop, and every kernel's registers.

With ``--k2-against DIR [DIR ...]`` (the parent's ``fill_web_holes.cu``
first, then any trial sources) K2 against those versions in one process:
the parent's spread at the bench instance (its first call after loading,
5 repeats of 10 launches, its three planes placed four ways, the clocks
before and after), then at each instance of ``K2_SWEEP`` (times 32 with
``value_bound`` 65 and ``None``, times 100, 16-bit cells, one 4K image)
every library's web, min and max compared bitwise with this one's, then
timed in turns beside ``k2_bound_ms``; and each library's SASS counts and
registers.  ``nvidia-smi`` clocks, power and temperature are printed at
the start and the end.

With ``--k6-against DIR [DIR ...]`` (the parent's ``fill_invalid.cu``
first, then trial sources, e.g. this one with its tile or most sweeps a
launch changed) K6 against those versions in one process, at each
instance of ``K6_SWEEP`` (8 x 1024 x 1024 with the SGM route's validity
plane at 16, 32 and 100 sweeps and with 40% random holes at 1, 16 and
100; one 2160 x 3840 image): every library's output compared bitwise with
this one's and this one's with the plain version, then timed in turns
beside ``k6_bound_ms``, with each library's launches; each library's
SASS counts and registers.

With ``--k3-against DIR [DIR ...]`` (the parent's ``sgm_volume.cu``
first, then trial sources) K3 the same way at each instance of
``K3_SWEEP`` (census int8 at D 64, 128 and 256, SAD int16 and census
int32 at D 64, census int8 at D 37 and 100; batch 8 up to D=64, nvox
held from there), beside ``k3_bound_ms``, with the route ``k3_route``
takes.

Inputs are random uint8 pairs from ``SEED``.  Imports no jax.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stereomatching_tpu_torch.bench.roofline import (  # noqa: E402
    KERNEL_OF, card, classic_stages, modern_stages, run_stages)

SIZE, SHIFTS, SEED = 1024, 64, 0


def event_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def stage_times(stages, pair, iters: int) -> dict:
    """ms of each stage of a route (``bench.roofline``'s stage table) run
    alone on its input from one forward of ``pair``, after one untimed
    call (which takes the caching allocator's first block for its
    output), by "<kernel> <stage>" ("torch" for torch ops)."""
    import torch

    def timed(fn, args):
        fn(*args)
        return event_ms(lambda: fn(*args), iters)

    with torch.no_grad():
        inputs, _ = run_stages(stages, pair)
        return {f"{KERNEL_OF.get(k, 'torch')} {k}": timed(fn, inputs[k])
                for k, fn in stages.items()}


def busy_share(intervals) -> tuple[float, float]:
    """-> (busy us, span us) of a list of (start, end) kernel intervals."""
    intervals = sorted(intervals)
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, intervals[-1][1] - intervals[0][0]


def profile_kernels(run, label: str) -> None:
    """Print device time per kernel name and the busy share of ``run()``
    (which ends in a synchronise) under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    per_name: dict[str, list[float]] = {}
    for e in kernels:
        per_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    total = sum(sum(v) for v in per_name.values())
    print(f"[profile {label}] device time {total / 1e3:.3f} ms", flush=True)
    for name, ts in sorted(per_name.items(), key=lambda kv: -sum(kv[1])):
        print(f"  {sum(ts) / 1e3:9.3f} ms {100 * sum(ts) / total:6.2f}% "
              f"{len(ts):5d} x {sum(ts) / len(ts):9.3f} us  {name[:90]}")
    busy, span = busy_share([(e.time_range.start, e.time_range.end) for e in kernels])
    print(f"[busy] device busy {100 * busy / span:.1f}% of a {span / 1e3:.3f} ms "
          f"device span", flush=True)


# The modern routes: (ModernParams fields, label).
MODERN = {
    "sgm": (dict(aggregation="sgm", cost="census"), "SGM census, 4 paths"),
    "box": (dict(), "box route, SAD, window 9"),
    "sgm8": (dict(aggregation="sgm", cost="census", sgm_directions=8, median_filter=True,
                  uniqueness=True), "SGM census, 8 paths, median, uniqueness"),
}


def main_modern(route: str) -> None:
    import numpy as np
    import torch

    from stereomatching_tpu_torch import ModernParams
    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.models import modern
    from stereomatching_tpu_torch.serving import ModernMatcher

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    dev = torch.device("cuda", 0)
    n = SIZE
    fields, label = MODERN[route]
    params = ModernParams(num_disparities=SHIFTS, **fields)
    pipe = modern.ModernPipeline(params)
    rng = np.random.default_rng(SEED)
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{label}, {n}x{n}, D={SHIFTS}, random u8 pairs", flush=True)

    def batch_u8(b):
        return (rng.integers(0, 256, (b, n, n), dtype=np.uint8),
                rng.integers(0, 256, (b, n, n), dtype=np.uint8))

    def to_dev(u8):
        return torch.from_numpy(u8).to(dev).to(torch.int32)

    for b in (1, 8, 32):
        lt, rt = (to_dev(x) for x in batch_u8(b))
        pipe(lt, rt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reps = [event_ms(lambda: pipe(lt, rt), 5 if b < 32 else 3) / b for _ in range(5)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"[batch {b}] device-resident ms/pair, 5 repeats: "
              f"{', '.join(f'{r:.4f}' for r in reps)}; peak device memory "
              f"{peak:.1f} MiB", flush=True)
        del lt, rt

    lt, rt = (to_dev(x) for x in batch_u8(32))

    def three():
        for _ in range(3):
            pipe(lt, rt)
        torch.cuda.synchronize()

    three()
    profile_kernels(three, "batch 32 x3")

    # The route's stages, in modern_forward's order, each timed alone.
    times = stage_times(modern_stages(params), (lt, rt), 3)
    whole = event_ms(lambda: pipe(lt, rt), 3)
    print(f"[stages batch 32] forward {whole:.3f} ms; " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / whole:.1f}%)" for k, v in times.items()), flush=True)
    del lt, rt

    matcher = ModernMatcher(params, device=dev)
    lu, ru = batch_u8(8)
    matcher(lu, ru)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        matcher(lu, ru)
        runs.append((time.perf_counter() - t0) * 1e3)
    clock = time.perf_counter
    t0 = clock()
    lp, rp = matcher._to_pixels(lu), matcher._to_pixels(ru)
    t1 = clock()
    lt, rt = torch.from_numpy(lp).to(dev), torch.from_numpy(rp).to(dev)
    torch.cuda.synchronize()
    t2 = clock()
    out = matcher.pipeline(lt.to(torch.int32), rt.to(torch.int32))
    torch.cuda.synchronize()
    t3 = clock()
    artifacts_to_numpy(out)
    t4 = clock()
    whole = (t4 - t0) * 1e3
    parts = {"host pixel checks": t1 - t0, "H2D (uint8)": t2 - t1, "pipeline": t3 - t2,
             "D2H + numpy": t4 - t3}
    print(f"[ModernMatcher batch 8] {', '.join(f'{r:.3f}' for r in runs)} ms; split of "
          f"one {whole:.3f} ms run: " + ", ".join(
              f"{k} {v * 1e3:.3f} ms ({100 * v * 1e3 / whole:.1f}%)"
              for k, v in parts.items()), flush=True)


def main_classic(rule: str) -> None:
    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.serving import Matcher

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    dev = torch.device("cuda", 0)
    n = SIZE
    mode = BoundaryMode.GHOST if rule == "exact" else BoundaryMode.WRAP
    params = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule=rule)
    pipe = ClassicPipeline(params)
    rng = np.random.default_rng(SEED)
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{mode.value}, {rule}, {n}x{n}, D={SHIFTS}, random u8 pairs", flush=True)

    def batch_u8(b):
        return (rng.integers(0, 256, (b, n, n), dtype=np.uint8),
                rng.integers(0, 256, (b, n, n), dtype=np.uint8))

    def to_dev(u8):
        return torch.from_numpy(u8.astype(np.float32) / np.float32(256.0)).to(dev)

    for b in (1, 8, 32):
        lt, rt = (to_dev(x) for x in batch_u8(b))
        pipe(lt, rt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reps = [event_ms(lambda: pipe(lt, rt), 5) / b for _ in range(5)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"[batch {b}] device-resident ms/pair, 5 repeats of 5: "
              f"{', '.join(f'{r:.4f}' for r in reps)}; peak device memory "
              f"{peak:.1f} MiB", flush=True)
        del lt, rt

    lt, rt = (to_dev(x) for x in batch_u8(8))

    def three():
        for _ in range(3):
            pipe(lt, rt)
        torch.cuda.synchronize()

    three()
    profile_kernels(three, "batch 8 x3")

    times = stage_times(classic_stages(params), (lt, rt), 5)
    whole = event_ms(lambda: pipe(lt, rt), 5)
    print(f"[stages batch 8] forward {whole:.3f} ms; " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / whole:.1f}%)" for k, v in times.items()), flush=True)

    matcher = Matcher(params, device=dev)
    lu, ru = batch_u8(8)
    matcher(lu, ru)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        matcher(lu, ru)
        runs.append((time.perf_counter() - t0) * 1e3)
    clock = time.perf_counter
    t0 = clock()
    lb, rb = matcher._to_brightness(lu), matcher._to_brightness(ru)
    t1 = clock()
    lt, rt = torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)
    torch.cuda.synchronize()
    t2 = clock()
    arts = matcher.pipeline(lt, rt)
    torch.cuda.synchronize()
    t3 = clock()
    artifacts_to_numpy(arts)
    t4 = clock()
    whole = (t4 - t0) * 1e3
    parts = {"host u8->f32": t1 - t0, "H2D": t2 - t1, "pipeline": t3 - t2,
             "D2H + numpy": t4 - t3}
    print(f"[Matcher batch 8] {', '.join(f'{r:.3f}' for r in runs)} ms; split of "
          f"one {whole:.3f} ms run: " + ", ".join(
              f"{k} {v * 1e3:.3f} ms ({100 * v * 1e3 / whole:.1f}%)"
              for k, v in parts.items()), flush=True)


def main_sharded(route: str, data: int, rows: int) -> None:
    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.models.modern import ModernPipeline
    from stereomatching_tpu_torch.parallel import (
        build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh)

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    dev = torch.device("cuda", 0)
    mesh = make_mesh(data=data, rows=rows, devices=[dev] * (data * rows))
    rng = np.random.default_rng(SEED)
    u8 = [rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8) for _ in range(2)]
    if route in ("classic", "reference"):
        rule = "exact" if route == "classic" else "reference"
        mode = BoundaryMode.GHOST if rule == "exact" else BoundaryMode.WRAP
        params = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule=rule)
        sharded, single = build_sharded_pipeline(params, mesh), ClassicPipeline(params)
        lt, rt = (torch.from_numpy(x.astype(np.float32) / np.float32(256.0)).to(dev) for x in u8)
        label = f"{mode.value}, {rule}"
    else:
        fields, label = MODERN[route]
        params = ModernParams(num_disparities=SHIFTS, **fields)
        sharded, single = build_sharded_modern_pipeline(params, mesh), ModernPipeline(params)
        lt, rt = (torch.from_numpy(x).to(dev).to(torch.int32) for x in u8)
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; sharded "
          f"{label}, mesh data {data} x rows {rows} on cuda:0, {SIZE}x{SIZE}, D={SHIFTS}, "
          f"random u8 pairs, batch 8", flush=True)
    for name, fn in (("sharded", sharded), ("single device", single)):
        fn(lt, rt)
        torch.cuda.synchronize()
        reps = [event_ms(lambda: fn(lt, rt), 3) / 8 for _ in range(5)]
        print(f"[{name}] device-resident ms/pair, 5 repeats of 3: "
              f"{', '.join(f'{r:.4f}' for r in reps)}", flush=True)

    def three():
        for _ in range(3):
            sharded(lt, rt)
        torch.cuda.synchronize()

    profile_kernels(three, "sharded batch 8 x3")


def print_sass(label: str, library, ops=("LDS", "STS", "BAR"), kernels=None) -> None:
    """The counts of ``ops`` in each kernel of ``library`` (those whose
    name the regex ``kernels`` finds, if given), in total and per loop."""
    from stereomatching_tpu_torch.utils.build import sass_counts

    for name, c in sass_counts(library, ops).items():
        if kernels is None or kernels.search(name):
            print(f"[sass {label}] {name}: total {c['total']}")
            for start, end, counts in c["loops"]:
                print(f"[sass {label}]   loop {start:#06x}-{end:#06x}: {counts}")


def print_build(label: str, library, ops) -> None:
    """SASS counts of ``ops`` per kernel and loop of a built library, and
    every kernel's registers and local memory."""
    from stereomatching_tpu_torch.utils.build import resource_usage

    print_sass(label, library, ops)
    print(f"[regs {label}] " + "; ".join(
        f"{m}: {r['REG']} regs, {r['LOCAL']} B local"
        for m, r in resource_usage(library).items()), flush=True)


def time_in_turns(order: list, make, iters: int) -> list:
    """Each label of ``order`` in turn: ``make(label)`` gives a launch,
    run once, then timed -> [(label, ms)]."""
    times = []
    for label in order:
        fn = make(label)
        fn()
        times.append((label, event_ms(fn, iters)))
    return times


def turns_text(times: list, scale: float = 1.0, fmt: str = ".4f") -> str:
    return ", ".join(f"{label} {ms * scale:{fmt}}" for label, ms in times)


def main_k1_against(src_dir: Path) -> None:
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.ops import fused
    from stereomatching_tpu_torch.utils.build import _target

    print("[card] {name}, {power_limit}".format(**card(torch.device("cuda", 0))), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("match_score_edges", [src_dir], tmp)
        other_so = libs[src_dir.name]
        print_sass("other", other_so)
        print_sass("this", libs["this"])
        other = ctypes.CDLL(str(other_so))
        other.match_score_edges.argtypes = fused._SIGNATURES["match_score_edges"]
        other.match_score_edges.restype = ctypes.c_int
        params = StereoParams(num_shifts=SHIFTS, mode=BoundaryMode.GHOST, edge_rule="exact")
        rng = np.random.default_rng(SEED)
        lt, rt = (torch.from_numpy(rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)
                                   .astype(np.float32) / 256).cuda() for _ in range(2))
        for sub in (False, True):
            outs = [torch.empty_like(lt, dtype=torch.int32) for _ in range(4)]
            outs += [torch.empty_like(lt)] if sub else []

            def run_other():
                err = other.match_score_edges(
                    lt.data_ptr(), rt.data_ptr(), *[o.data_ptr() for o in outs[:4]],
                    outs[4].data_ptr() if sub else None, 8, SIZE, SIZE, params.half,
                    params.num_shifts, 1, ctypes.c_float(params.threshold),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"other K1 failed: CUDA error {err}")

            def run_this():
                return fused.match_score_edges(lt, rt, params, subpixel=sub)

            run_other()
            mine = run_this()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(mine, outs))
            runs = {"other": run_other, "this": run_this}
            times = time_in_turns(["other", "this", "this", "other"], runs.get, 10)
            print(f"[k1 against] subpixel={sub} outputs equal: {same}; ms per batch of 8 "
                  + turns_text(times), flush=True)
            if not same:
                sys.exit("the two K1 versions disagree")
    print(f"[k1 against] this library: {_target('match_score_edges').name}")


def main_k8_against(src_dir: Path) -> None:
    """K8 and K9 against the ``match_and_score.cu`` in ``src_dir`` (with
    the ``match_loop.cuh`` it includes) in one process: every plane of
    both libraries compared bitwise, then each instance timed in turns
    other, this, this, other beside its bound; the shared-memory loads,
    stores, barriers and all instructions of each library's SASS."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.ops import fused
    from stereomatching_tpu_torch.ops.edges import find_edges
    from stereomatching_tpu_torch.parallel import make_mesh
    from stereomatching_tpu_torch.parallel.mesh import run as run_blocks
    from stereomatching_tpu_torch.parallel.pipeline import prehalo_blocks, shard_extent
    from stereomatching_tpu_torch.utils.bench import k8_bound_ms, k9_bound_ms
    from stereomatching_tpu_torch.utils.build import _target, resource_usage

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("match_and_score", [src_dir], tmp)
        for label, so in libs.items():
            print_sass(label, so, ("LDS", "STS", "BAR", "ALL"))
            print(f"[regs {label}] " + "; ".join(
                f"{m}: {r['REG']} regs, {r['LOCAL']} B local"
                for m, r in resource_usage(so).items()), flush=True)
        fns = {}
        for label, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for entry in ("match_and_score", "match_and_score_prehalo"):
                getattr(lib, entry).argtypes = fused._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            fns[label] = lib
        other = next(k for k in fns if k != "this")
        order = [other, "this", "this", other]

        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        lt, rt = (torch.from_numpy(rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)
                                   .astype(np.float32) / np.float32(256.0)).to(dev)
                  for _ in range(2))
        npix = lt.numel()

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def k8_case(mode, sub):
            """K8 on the reference-rule edge maps of the random pairs."""
            p = StereoParams(num_shifts=SHIFTS, mode=mode)
            el, er = (find_edges(x, p.threshold, mode, "reference") for x in (lt, rt))
            outs = [torch.empty_like(el) for _ in range(2)] + ([torch.empty_like(lt)] if sub else [])

            def call(lib):
                err = lib.match_and_score(
                    el.data_ptr(), er.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                    outs[2].data_ptr() if sub else None, 8, SIZE, SIZE, p.half, SHIFTS,
                    int(mode == BoundaryMode.GHOST), stream())
                if err:
                    raise RuntimeError(f"K8 launch failed: CUDA error {err}")
            label = f"K8 {mode.value}{', sub-pixel' if sub else ''}, 8x{SIZE}x{SIZE}"
            return label, k8_bound_ms(npix, SHIFTS, sub), call, outs

        def k9_case(mode):
            """K9 on the data 2 x rows 4 blocks of the random pairs (exact
            rule), as the sharded classic tier builds them."""
            p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule="exact")
            mesh = make_mesh(data=2, rows=4, devices=[dev] * 8)
            bl, hs, ws = shard_extent(tuple(lt.shape), mesh)
            kw = run_blocks(mesh, bl, hs, ws, lambda sh: prehalo_blocks(
                sh, sh.scatter(lt), sh.scatter(rt), p)[2])[0]
            l_blk, r_blk, halo = kw["l_blk"], kw["r_blk"], kw["halo"]
            b, rows_in, w = l_blk.shape
            kept = rows_in - 2 * halo
            row0 = kw["row0"].to(dev, torch.int32).contiguous()
            col0 = torch.zeros_like(row0)
            outs = [torch.empty((b, kept, w), dtype=torch.int32, device=dev) for _ in range(2)]

            def call(lib):
                err = lib.match_and_score_prehalo(
                    l_blk.data_ptr(), r_blk.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                    b, rows_in, w, r_blk.shape[2], halo, p.half, SHIFTS,
                    int(mode == BoundaryMode.WRAP), int(mode == BoundaryMode.GHOST),
                    row0.data_ptr(), kw["h_global"], col0.data_ptr(), w, stream())
                if err:
                    raise RuntimeError(f"K9 launch failed: CUDA error {err}")
            label = f"K9 {mode.value}, blocks {tuple(l_blk.shape)}"
            bnd = k9_bound_ms(l_blk.numel() + r_blk.numel(), b * kept * w, b * 2 * p.half * w,
                              SHIFTS)
            return label, bnd, call, outs

        cases = [k8_case(mode, sub) for sub in (False, True)
                 for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)]
        cases += [k9_case(mode) for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)]
        for label, bnd, call, outs in cases:
            call(fns["this"])
            ref = [o.clone() for o in outs]
            call(fns[other])
            torch.cuda.synchronize()
            if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(outs, ref)):
                sys.exit(f"{label}: {other} differs from this")
            del ref
            times = time_in_turns(order, lambda lb: (lambda: call(fns[lb])), 10)
            print(f"[k8 against] {label}: outputs equal; bound {bnd[0]:.4f} ms ({bnd[1]}); ms per "
                  f"batch of 8 " + turns_text(times), flush=True)
    print(f"[k8 against] this library: {_target('match_and_score').name}; card {smi}")


K4_OPS = ("LDG", "STG", "LDGSTS", "LDS", "REDUX", "SHFL", "ALL")
K4_BENCH = "signed char, short, (int)2,"  # int8 costs, int16 aggregate, 2 per lane
# The other K4 instances timed by --k4-against: (D, volume, aggregate) at
# 8 x 1024 x 1024; ND = ceil(D / 32) disparities a lane.
K4_SWEEP = [(128, "int8", "int16"), (256, "int8", "int16"), (64, "int16", "int16"),
            (128, "int16", "int16"), (256, "int16", "int16"), (64, "int32", "int32"),
            (128, "int32", "int32"), (256, "int32", "int32")]


def k4_entry(library):
    """``sgm_directional`` of a built K4 library, ready for ctypes."""
    import ctypes

    from stereomatching_tpu_torch.ops import fused_sgm

    fn = ctypes.CDLL(str(library)).sgm_directional
    fn.argtypes = fused_sgm._SIGNATURES["sgm_directional"]
    fn.restype = ctypes.c_int
    return fn


def k4_call(fn, vol, agg, direction, reverse, accumulate, seed=None, carry=None):
    """One K4 launch of ``fn`` with the bench's P1 8, P2 96."""
    import torch

    b, h, w, d = vol.shape
    err = fn(vol.data_ptr(), vol.element_size(), agg.data_ptr(), agg.element_size(), b, h, w, d,
             8, 96, direction, int(reverse), int(accumulate),
             None if seed is None else seed.data_ptr(), None if carry is None else carry.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")


def print_k4_build(label: str, library) -> None:
    """SASS counts (``K4_OPS``, each loop's in address order) of the bench
    instantiation of a K4 library, and the registers and local memory of
    every instantiation."""
    from stereomatching_tpu_torch.utils.build import resource_usage, sass_counts

    for name, c in sass_counts(library, K4_OPS, order=True).items():
        if K4_BENCH not in name:
            continue
        print(f"[sass {label}] {name}: total {c['total']}")
        for start, end, counts in c["loops"]:
            print(f"[sass {label}]   loop {start:#06x}-{end:#06x}: {counts}")
    # mangled: directional_kernel<volume, aggregate, ND, CHAIN, ASYNC>
    print(f"[regs {label}] " + "; ".join(
        f"{m.split('directional_kernel')[-1]}: {r['REG']} regs, {r['LOCAL']} B local"
        for m, r in resource_usage(library).items()), flush=True)


def build_libraries(name: str, src_dirs: list[Path], tmp: str) -> dict:
    """This checkout's ``csrc/<name>.cu`` and each ``DIR/<name>.cu`` of
    ``src_dirs`` built with the port's nvcc flags (the others into
    ``tmp``), one nvcc each, all started together -> {label: library},
    "this" first, then each directory's name."""
    from stereomatching_tpu_torch.utils.build import NVCC_FLAGS, build, find_nvcc

    t0 = time.perf_counter()
    procs = [(d.name, Path(tmp) / f"{name}_{d.name}.so", subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(Path(tmp) / f"{name}_{d.name}.so"),
         str(d / f"{name}.cu")])) for d in src_dirs]
    libs = {"this": build(name)}
    for label, so, proc in procs:
        if proc.wait() != 0:
            sys.exit(f"nvcc failed for {label}")
        libs[label] = so
    print(f"[build] {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def main_k4_against(src_dirs: list[Path]) -> None:
    """K4 against other ``sgm_directional.cu`` sources in one process:
    outputs compared bitwise, then each pass, the 4- and 8-path sums and a
    seeded chain launch timed in turns at the bench instance, and a pass
    of each kind and both sums at the instances of ``K4_SWEEP``."""
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch.ops import costvolume, fused_sgm, sgm
    from stereomatching_tpu_torch.utils.build import _target

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("sgm_directional", src_dirs, tmp)
        for label, so in libs.items():
            print_k4_build(label, so)
        fns = {label: k4_entry(so) for label, so in libs.items()}
        others = [k for k in fns if k != "this"]
        order = [*others, "this"]
        order = order + order[::-1]

        def turns(make, iters):
            return time_in_turns(order, lambda label: make(fns[label]), iters)

        def same(what, fn_run):
            ref = fn_run(fns["this"])
            for label in others:
                got = fn_run(fns[label])
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    sys.exit(f"K4 {label} differs from this on {what}")
                del got
            del ref

        rng = np.random.default_rng(SEED)
        dev = torch.device("cuda", 0)
        pix = [torch.from_numpy(rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)).to(dev)
               .to(torch.int32) for _ in range(2)]
        codes = [costvolume.census_transform(x).contiguous() for x in pix]
        vol = fused_sgm.sgm_volume(*codes, SHIFTS, "census", torch.int8)
        del pix, codes
        nvox = vol.numel()
        paths = sgm.PATHS + sgm.DIAG_PATHS

        # Bitwise: each pass written and added onto a filled aggregate, the
        # 4- and 8-path sums, a seeded chain launch (L and carry).
        def run_pass(fn, vol, base, direction, reverse, acc):
            a = base.clone()
            k4_call(fn, vol, a, direction, reverse, acc)
            return a

        def run_sum(fn, vol, agg, n):
            for i, (direction, reverse) in enumerate(paths[:n]):
                k4_call(fn, vol, agg, direction, reverse, i > 0)
            return agg

        base = torch.full(vol.shape, 7, dtype=torch.int16, device=dev)
        hs = SIZE // 4
        shard = vol[:, hs:2 * hs].contiguous()
        seed = torch.empty((8, SIZE, SHIFTS), dtype=torch.int32, device=dev)
        k4_call(fns["this"], vol[:, :hs].contiguous(), torch.empty_like(shard, dtype=torch.int16),
                sgm.Y, False, False, carry=seed)
        chain_agg = torch.full(shard.shape, 7, dtype=torch.int16, device=dev)
        chain_carry = torch.empty_like(seed)

        def run_chain(fn):
            a, c = chain_agg.clone(), torch.empty_like(seed)
            k4_call(fn, shard, a, sgm.Y, False, True, seed=seed, carry=c)
            return a, c

        for d, r in paths:
            for a in (False, True):
                same(f"dir {d} rev {int(r)} acc {int(a)}",
                     lambda fn, d=d, r=r, a=a: (run_pass(fn, vol, base, d, r, a),))
        for n in (4, 8):
            same(f"{n}-path sum", lambda fn, n=n: (run_sum(fn, vol, torch.empty_like(base), n),))
        same("seeded column launch", run_chain)
        torch.cuda.synchronize()
        print(f"[k4 against] outputs equal: {', '.join(others)} == this on the 8 passes "
              f"(written and added), the 4- and 8-path sums and a seeded column launch "
              f"(8x{SIZE}x{SIZE}, D={SHIFTS}, census int8 volume, int16 aggregate)", flush=True)

        agg = base.clone()
        for direction, reverse in paths:
            for acc in (False, True):
                nbytes = (vol.element_size() + agg.element_size() * (2 if acc else 1)) * nvox
                floor = nbytes / 3.35e12 * 1e3
                times = turns(lambda fn: (lambda: k4_call(fn, vol, agg, direction, reverse, acc)), 10)
                print(f"[k4 pass] dir {direction} rev {int(reverse)} acc {int(acc)}: "
                      f"{nbytes / 1e9:.3f} GB, floor {floor:.4f} ms at 3.35 TB/s; ms (GB/s) "
                      + ", ".join(f"{label} {ms:.4f} ({nbytes / ms / 1e6:.0f})"
                                  for label, ms in times), flush=True)
        for n in (4, 8):
            nbytes = (n * vol.element_size() + (2 * n - 1) * agg.element_size()) * nvox
            times = turns(lambda fn: (lambda: run_sum(fn, vol, agg, n)), 5)
            print(f"[k4 sum] {n} paths: {nbytes / 1e9:.3f} GB, floor {nbytes / 3.35e12 * 1e3:.4f} "
                  f"ms; ms " + turns_text(times), flush=True)
        cbytes = (1 + 2 * 2) * shard.numel() + 4 * 2 * seed.numel()
        times = turns(lambda fn: (lambda: k4_call(fn, shard, chain_agg, sgm.Y, False, True,
                                                  seed=seed, carry=chain_carry)), 10)
        print(f"[k4 chain] seeded column launch on [8, {hs}, {SIZE}, {SHIFTS}] (accumulating, "
              f"seed and carry): {cbytes / 1e9:.3f} GB, floor {cbytes / 3.35e12 * 1e6:.1f} us; us "
              + turns_text(times, 1e3, ".1f"), flush=True)
        del vol, base, agg, shard, seed, chain_agg, chain_carry

        # The other instances, on random costs in [0, 60]: the 8-path sum
        # compared bitwise, then rows written and added, the (y+1, x+1)
        # diagonals added, and the 4- and 8-path sums timed in turns.
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for d, vdt, adt in K4_SWEEP:
            vdt, adt = getattr(torch, vdt), getattr(torch, adt)
            vol = torch.randint(0, 61, (8, SIZE, SIZE, d), generator=gen, device=dev, dtype=vdt)
            agg = torch.zeros(vol.shape, dtype=adt, device=dev)
            same(f"D {d} {vdt} / {adt}", lambda fn: (run_sum(fn, vol, agg.clone(), 8),))
            nvox, vb, ab = vol.numel(), vol.element_size(), agg.element_size()
            cells = []
            for what, nbytes, run, iters in [
                ("rows written", (vb + ab) * nvox,
                 lambda fn: (lambda: k4_call(fn, vol, agg, sgm.X, False, False)), 5),
                ("rows added", (vb + 2 * ab) * nvox,
                 lambda fn: (lambda: k4_call(fn, vol, agg, sgm.X, False, True)), 5),
                ("diagonals added", (vb + 2 * ab) * nvox,
                 lambda fn: (lambda: k4_call(fn, vol, agg, sgm.DIAG_PLUS, False, True)), 5),
                ("4-path sum", (4 * vb + 7 * ab) * nvox, lambda fn: (lambda: run_sum(fn, vol, agg, 4)), 3),
                ("8-path sum", (8 * vb + 15 * ab) * nvox, lambda fn: (lambda: run_sum(fn, vol, agg, 8)), 3),
            ]:
                times = turns(run, iters)
                cells.append(f"{what} (floor {nbytes / 3.35e9:.4f}) "
                             + turns_text(times))
            print(f"[k4 sweep] D {d}, {str(vdt)[6:]} volume, {str(adt)[6:]} aggregate, "
                  f"8x{SIZE}x{SIZE}, outputs equal; ms: " + "; ".join(cells), flush=True)
            del vol, agg
    print(f"[k4 against] this library: {_target('sgm_directional').name}; card {smi}")


K7_OPS = ("LDS", "STS", "BAR", "SHFL", "REDUX", "ALL")


def main_k7_against(src_dirs: list[Path]) -> None:
    """K7 against other ``disparity.cu`` sources in one process: at each
    instance of ``K7_SWEEP`` every library's three planes compared bitwise
    with this one's for both reference views, then the left view timed in
    turns (the others, this, then the same in reverse) beside the bound;
    then each library's SASS counts of the SAD kernels at window 9, D=64,
    and every kernel's registers and local memory."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch import ModernParams
    from stereomatching_tpu_torch.ops import costvolume, fused_modern
    from stereomatching_tpu_torch.utils.bench import K7_BENCH_KERNELS, K7_SWEEP, k7_bound_ms
    from stereomatching_tpu_torch.utils.build import _target, resource_usage

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("disparity", src_dirs, tmp)
        for label, so in libs.items():
            print_sass(label, so, K7_OPS, K7_BENCH_KERNELS)
            print(f"[regs {label}] " + "; ".join(
                f"{m}: {r['REG']} regs, {r['LOCAL']} B local"
                for m, r in resource_usage(so).items()), flush=True)
        fns = {}
        for label, so in libs.items():
            fn = ctypes.CDLL(str(so)).disparity
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[label] = fn
        others = [k for k in fns if k != "this"]
        order = [*others, "this"]
        order = order + order[::-1]

        rng = np.random.default_rng(SEED)
        dev = torch.device("cuda", 0)
        pix = [torch.from_numpy(rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)).to(dev)
               .to(torch.int32) for _ in range(2)]
        codes = [costvolume.census_transform(x).contiguous() for x in pix]
        npix = pix[0].numel()
        outs = [torch.empty_like(pix[0], dtype=dt) for dt in (torch.int32, torch.float32, torch.int32)]

        def call(fn, inputs, d, window, census, right):
            a, b = inputs[::-1] if right else inputs
            err = fn(a.data_ptr(), b.data_ptr(), *[o.data_ptr() for o in outs], 8, SIZE, SIZE, d,
                     window // 2, census, right, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K7 launch failed: CUDA error {err}")

        for cost, window, d in K7_SWEEP:
            census = int(cost == "census")
            inputs = codes if census else pix
            for right in (0, 1):
                call(fns["this"], inputs, d, window, census, right)
                ref = [o.clone() for o in outs]
                for label in others:
                    call(fns[label], inputs, d, window, census, right)
                    if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                               for x, y in zip(outs, ref)):
                        sys.exit(f"K7 {label} differs from this at {cost} window {window} D {d} "
                                 f"right {right}")
                del ref
            iters = 10 if window < 50 else 3
            times = time_in_turns(
                order, lambda label: (lambda: call(fns[label], inputs, d, window, census, 0)),
                iters)
            route = fused_modern.route(ModernParams(num_disparities=d, window=window, cost=cost))
            print(f"[k7 instance] {cost} window {window} D {d}, 8x{SIZE}x{SIZE}, both views equal; "
                  f"this: {route}; bound {k7_bound_ms(cost, npix, d)[0]:.4f} ms; ms per view "
                  + turns_text(times), flush=True)
    print(f"[k7 against] this library: {_target('disparity').name}; card {smi}")


def clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# K5's timed instances: (dtype, D, uniqueness), each at 8 x 1024 x 1024
# pixels scaled down by D / 64 from D=128 (nvox fixed at the bench
# instance's).  The first two are the SGM and 8-direction routes' tails.
K5_SWEEP = [("int16", 64, False), ("int16", 64, True), ("int32", 64, False),
            ("int16", 128, False), ("int16", 256, False), ("int32", 256, False),
            ("int16", 37, False), ("int16", 100, False)]
K5_OPS = ("LDS", "STS", "BAR", "LDGSTS", "REDUX", "SHFL", "ALL")


def main_k5_against(src_dirs: list[Path]) -> None:
    """K5 against other ``sgm_tail.cu`` sources in one process: at each
    instance of ``K5_SWEEP`` every library's planes (with and without
    the second best) compared bitwise with this one's, then the call
    timed in turns (the others, this, then the same in reverse) beside
    ``k5_bound_ms``; then each library's SASS counts per kernel and
    loop, and every kernel's registers and local memory.  A library
    without ``sgm_tail_smem_bytes`` (the parent's) takes the C entry
    without a route argument; this one takes ``k5_route``'s route."""
    import ctypes
    import tempfile

    import torch

    from stereomatching_tpu_torch.ops import fused_sgm
    from stereomatching_tpu_torch.utils.bench import k5_bound_ms
    from stereomatching_tpu_torch.utils.build import _target

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"clocks {clocks()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("sgm_tail", src_dirs, tmp)
        fns = {}
        for label, so in libs.items():
            print_build(label, so, K5_OPS)
            lib = ctypes.CDLL(str(so))
            routed = hasattr(lib, "sgm_tail_smem_bytes")
            lib.sgm_tail.argtypes = fused_sgm._SIGNATURES["sgm_tail"][:None if routed else -2] + [
                ctypes.c_void_p] * (0 if routed else 1)
            lib.sgm_tail.restype = ctypes.c_int
            fns[label] = (lib.sgm_tail, routed)
        others = [k for k in fns if k != "this"]
        order = [*others, "this"]
        order = order + order[::-1]
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for dtype_name, d, uniq in K5_SWEEP:
            dtype = getattr(torch, dtype_name)
            batch = max(1, 8 * 64 // max(d, 64))
            agg = torch.randint(0, 3000, (batch, SIZE, SIZE, d), generator=gen, device=dev,
                                dtype=torch.int32).to(dtype)
            npix = batch * SIZE * SIZE
            route = fused_sgm.k5_route(agg.shape, dtype)
            outs = [torch.empty((batch, SIZE, SIZE), dtype=dt, device=dev)
                    for dt in (torch.int32, torch.float32, torch.int32, torch.int32, torch.int32)]

            def call(label):
                fn, routed = fns[label]
                extra = [int(route == "segments")] if routed else []
                err = fn(agg.data_ptr(), agg.element_size(), *[o.data_ptr() for o in outs[:4]],
                         outs[4].data_ptr() if uniq else None, batch, SIZE, SIZE, d, *extra,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K5 {label} failed: CUDA error {err}")

            call("this")
            ref = [o.clone() for o in outs[:4 + uniq]]
            for label in others:
                call(label)
                if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                           for a, b in zip(outs, ref)):
                    sys.exit(f"K5 {label} differs from this at {dtype_name} D {d} uniq {uniq}")
            del ref
            times = time_in_turns(order, lambda label: (lambda: call(label)), 10)
            b = k5_bound_ms(npix, d, agg.element_size(), uniq)
            print(f"[k5 instance] {dtype_name} D {d} uniqueness {uniq}, {batch}x{SIZE}x{SIZE}, "
                  f"planes equal; this: {route}; bound {b[0]:.4f} ms ({b[1]}); ms per call "
                  + turns_text(times), flush=True)
            del agg, outs
    print(f"[k5 against] this library: {_target('sgm_tail').name}; card {smi}; "
          f"clocks {clocks()}")


# K2's timed instances: (batch, H, W, times, value_bound).  The first is
# the classic pipeline's (bench.py's first line: times 32, 64 shifts); the
# others: a resumed web (no bound, int32 storage), chained launches
# (times 100), 16-bit storage, and one 4K image.
K2_SWEEP = [(8, 1024, 1024, 32, 65), (8, 1024, 1024, 32, None), (8, 1024, 1024, 100, 65),
            (8, 1024, 1024, 32, 65536), (1, 2160, 3840, 32, 65)]
K2_OPS = ("LDS", "STS", "BAR", "LDG", "STG", "ALL")


def main_k2_against(src_dirs: list[Path]) -> None:
    """K2 against other ``fill_web_holes.cu`` sources in one process.
    First the spread of the parent's K2 (the first library given) at the
    bench instance: its first launch after the build, 5 repeats of 10
    launches, and the same on its three int32 planes placed four ways
    (separate allocations, one buffer back to back, one buffer with 1 MB
    + 4 KB between planes, fresh allocations), each with the planes'
    addresses, and the clocks before and after.  Then at each instance of
    ``K2_SWEEP`` every library's web, min and max compared bitwise with
    this one's, then the call timed in turns (the others, this, then the
    same in reverse) beside ``k2_bound_ms``; this one's 5 repeats at the
    bench instance; each library's SASS counts and registers.  A library
    without ``fill_web_holes_max_steps`` (the parent's) takes the C entry
    of one launch per step and two int32 scratch planes."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch.ops import fused_diffusion
    from stereomatching_tpu_torch.utils.bench import k2_bound_ms
    from stereomatching_tpu_torch.utils.build import _target

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"clocks (sm, mem, power, temp) {clocks()}", flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("fill_web_holes", src_dirs, tmp)
        fns = {}
        for label, so in libs.items():
            print_build(label, so, K2_OPS)
            lib = ctypes.CDLL(str(so))
            fused = hasattr(lib, "fill_web_holes_max_steps")
            lib.fill_web_holes_range.argtypes = (
                [P] * 5 + [I] * 5 + [P] if fused else [P] * 6 + [I] * 4 + [P])
            lib.fill_web_holes_range.restype = I
            fns[label] = (lib.fill_web_holes_range, fused)
        others = [k for k in fns if k != "this"]
        parent = others[0]
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)

        def make_web(b, h, w, vb):
            web = rng.integers(1, 65 if vb is None else min(vb, 2**31 - 1), (b, h, w))
            web[rng.random(web.shape) < 0.4] = 0
            return torch.from_numpy(web.astype(np.int32)).to(dev)

        def caller(label, web, times, vb, planes=None):
            """-> (launch, out, mn, mx): one call of ``label``'s C entry
            on preallocated buffers (``planes``: the parent's out and two
            scratch planes, if given)."""
            fn, fused = fns[label]
            b, h, w = web.shape
            mn = torch.empty(b, dtype=torch.int32, device=dev)
            mx = torch.empty_like(mn)
            stream = torch.cuda.current_stream().cuda_stream
            if fused:
                plan = fused_diffusion.k2_plan(times, vb)
                out = torch.empty_like(web)
                scratch = torch.empty((4, b, h, w), dtype=fused_diffusion.K2_STORAGE[
                    plan.storage_bytes], device=dev) if plan.launches > 1 else None
                args = (web.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), mn.data_ptr(),
                        mx.data_ptr(), b, h, w, times, plan.storage_bytes, stream)
            else:
                out, s0, s1 = planes or [torch.empty_like(web) for _ in range(3)]
                args = (web.data_ptr(), out.data_ptr(), s0.data_ptr(), s1.data_ptr(),
                        mn.data_ptr(), mx.data_ptr(), b, h, w, times, stream)

            held = [web, out, scratch] if fused else [web, out, s0, s1]  # alive while launched

            def launch():
                mn.fill_(2**31 - 1)
                mx.fill_(-(2**31))
                err = fn(*args)
                if err:
                    raise RuntimeError(f"K2 {label} failed: CUDA error {err}")
            launch.held = held
            return launch, out, mn, mx

        # The parent's spread at the bench instance.
        web = make_web(8, SIZE, SIZE, 65)
        for label in (parent, "this"):
            launch = caller(label, web, 32, 65)[0]
            torch.cuda.synchronize()
            print(f"[k2 first launch] {label}: {event_ms(launch, 1):.4f} ms (the first call "
                  f"after loading the library), then {event_ms(launch, 1):.4f}", flush=True)
        launch = caller(parent, web, 32, 65)[0]
        reps = [event_ms(launch, 10) for _ in range(5)]
        print(f"[k2 spread] {parent} 5 x 10 launches: "
              + ", ".join(f"{r:.4f}" for r in reps) + f" ms; clocks {clocks()}", flush=True)
        n = web.numel()
        big = torch.empty(3 * n + 2 * (2**18 + 2**10), dtype=torch.int32, device=dev)
        gap = 2**18 + 2**10  # 1 MB + 4 KB of int32
        placements = {
            "separate": [torch.empty_like(web) for _ in range(3)],
            "back to back": [big[i * n:(i + 1) * n].view_as(web) for i in range(3)],
            "1 MB + 4 KB apart": [big[i * (n + gap):i * (n + gap) + n].view_as(web)
                                  for i in range(3)],
        }
        placements["fresh"] = None
        for name, planes in placements.items():
            if planes is None:
                planes = [torch.empty_like(web) for _ in range(3)]
            launch = caller(parent, web, 32, 65, planes)[0]
            launch()
            reps = [event_ms(launch, 10) for _ in range(3)]
            print(f"[k2 placement] {parent} planes {name} at "
                  + ", ".join(f"{t.data_ptr():#x}" for t in planes) + ": "
                  + ", ".join(f"{r:.4f}" for r in reps) + " ms", flush=True)
        del big, placements

        order = [*others, "this"]
        order = order + order[::-1]
        for b, h, w, times, vb in K2_SWEEP:
            web = make_web(b, h, w, vb)
            runs = {label: caller(label, web, times, vb) for label in fns}
            runs["this"][0]()
            ref = [x.clone() for x in runs["this"][1:]]
            for label in others:
                runs[label][0]()
                if not all(torch.equal(x, y) for x, y in zip(runs[label][1:], ref)):
                    plain = fused_diffusion.fill_web_holes_range_reference(web, times)
                    agree = {lab: all(torch.equal(x, y) for x, y in zip(got, plain))
                             for lab, got in ((label, runs[label][1:]), ("this", ref))}
                    sys.exit(f"K2 {label} differs from this at {b}x{h}x{w} times {times} "
                             f"value_bound {vb}; equal to the plain version: {agree}")
            times_ms = time_in_turns(order, lambda label: runs[label][0], 10)
            plan = fused_diffusion.k2_plan(times, vb)
            bd = k2_bound_ms(b * h * w, times)
            print(f"[k2 instance] {b}x{h}x{w} times {times} value_bound {vb}: web, min, max "
                  f"equal; this: {plan.storage_bytes}-byte cells, {plan.launches} launch(es); "
                  f"bound {bd[0]:.4f} ms ({bd[1]}); ms per call " + turns_text(times_ms),
                  flush=True)
            if (b, h, w, times, vb) == K2_SWEEP[0]:
                reps = [event_ms(runs["this"][0], 10) for _ in range(5)]
                print(f"[k2 spread] this 5 x 10 launches: "
                      + ", ".join(f"{r:.4f}" for r in reps) + " ms", flush=True)
            del runs, ref, web
    print(f"[k2 against] this library: {_target('fill_web_holes').name}; card {smi}; "
          f"clocks (sm, mem, power, temp) {clocks()}")


# K6's timed instances: (validity, batch, H, W, iterations).  "sgm": the
# SGM route's LR-check plane of random pairs (its sub-pixel plane as d);
# "holes": 40% random holes in random d.  The first is the modern
# pipeline's default (16 sweeps) on the SGM route; one sweep shows a
# launch's fixed cost (staging and write-back).
K6_SWEEP = [("sgm", 8, 1024, 1024, 16), ("holes", 8, 1024, 1024, 16), ("sgm", 8, 1024, 1024, 32),
            ("sgm", 8, 1024, 1024, 100), ("holes", 8, 1024, 1024, 100), ("holes", 1, 2160, 3840, 16),
            ("holes", 8, 1024, 1024, 1)]
K6_OPS = ("LDS", "STS", "BAR", "LDG", "STG", "ALL")


def sgm_fill_inputs(b: int, h: int, w: int, seed: int):
    """The SGM route's (sub-pixel, LR-valid) planes of ``b`` random
    ``h`` x ``w`` pairs (census, 4 paths, D=64) on the card."""
    import numpy as np
    import torch

    from stereomatching_tpu_torch import ModernParams
    from stereomatching_tpu_torch.models import modern

    rng = np.random.default_rng(seed)
    lt, rt = (torch.from_numpy(rng.integers(0, 256, (b, h, w), dtype=np.uint8)).cuda()
              .to(torch.int32) for _ in range(2))
    out = modern.ModernPipeline(ModernParams(num_disparities=SHIFTS, aggregation="sgm",
                                             cost="census"))(lt, rt)
    return out["subpixel"].contiguous(), out["valid"].contiguous()


def main_k6_against(src_dirs: list[Path]) -> None:
    """K6 against other ``fill_invalid.cu`` sources in one process (the
    parent's first, then trial copies): at each instance of ``K6_SWEEP``
    every library's output compared bitwise with this one's, and this
    one's with the plain version, then the call timed in turns (the
    others, this, then the same in reverse) beside ``k6_bound_ms``, with
    each library's launches; each library's SASS counts and registers.
    Every library takes the same C entry; the parent's reads all three
    scratch planes."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch.ops import fused_diffusion
    from stereomatching_tpu_torch.utils.bench import k6_bound_ms, k6_filled
    from stereomatching_tpu_torch.utils.build import _target

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"clocks (sm, mem, power, temp) {clocks()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("fill_invalid", src_dirs, tmp)
        fns = {}
        for label, so in libs.items():
            print_build(label, so, K6_OPS)
            lib = ctypes.CDLL(str(so))
            lib.fill_invalid.argtypes = fused_diffusion._ENTRIES["fill_invalid"][1]
            lib.fill_invalid.restype = ctypes.c_int
            fused = hasattr(lib, "fill_invalid_max_sweeps")
            per_launch = lib.fill_invalid_max_sweeps() if fused else 1
            fns[label] = (lib.fill_invalid, per_launch)
        others = [k for k in fns if k != "this"]
        order = [*others, "this"]
        order = order + order[::-1]
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        for kind, b, h, w, iters in K6_SWEEP:
            if kind == "sgm":
                d, valid = sgm_fill_inputs(b, h, w, SEED)
            else:
                d = torch.from_numpy((rng.random((b, h, w)) * SHIFTS).astype(np.float32)).to(dev)
                valid = torch.from_numpy(rng.random((b, h, w)) >= 0.4).to(dev)
            outs = {label: torch.empty_like(d) for label in fns}
            scratch = [torch.empty_like(d)] + [torch.empty_like(valid, dtype=torch.uint8)
                                               for _ in range(2)]

            def call(label):
                fn = fns[label][0]
                err = fn(d.data_ptr(), valid.data_ptr(), outs[label].data_ptr(),
                         *[t.data_ptr() for t in scratch], b, h, w, iters,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K6 {label} failed: CUDA error {err}")

            for label in fns:
                call(label)
            bits = {label: o.view(torch.int32) for label, o in outs.items()}
            plain = fused_diffusion.fill_invalid_reference(d, valid, iters).view(torch.int32)
            if not torch.equal(bits["this"], plain):
                sys.exit(f"K6 this differs from the plain version at {kind} {b}x{h}x{w} "
                         f"iterations {iters}")
            for label in others:
                if not torch.equal(bits[label], bits["this"]):
                    sys.exit(f"K6 {label} differs from this at {kind} {b}x{h}x{w} "
                             f"iterations {iters}")
            times = time_in_turns(order, lambda label: (lambda: call(label)), 10)
            bd = k6_bound_ms(b * h * w, k6_filled(valid, iters))
            launches = ", ".join(f"{label} {-(-iters // fns[label][1])}" for label in fns)
            print(f"[k6 instance] {kind} {b}x{h}x{w} iterations {iters}, valid "
                  f"{float(valid.float().mean()):.2%}: equal to each other and to the plain "
                  f"version; launches {launches}; bound {bd[0]:.4f} ms ({bd[1]}); ms per call "
                  + turns_text(times), flush=True)
            del d, valid, outs, scratch, bits, plain
    print(f"[k6 against] this library: {_target('fill_invalid').name}; card {smi}; "
          f"clocks (sm, mem, power, temp) {clocks()}")


# K3's timed instances: (cost, volume dtype, D), each at 8 x 1024 x 1024
# pixels scaled down by D / 64 from D=64 (nvox fixed at the bench
# instance's).  The first is the SGM route's volume.
K3_SWEEP = [("census", "int8", 64), ("census", "int8", 128), ("census", "int8", 256),
            ("sad", "int16", 64), ("census", "int32", 64), ("census", "int8", 37),
            ("census", "int8", 100)]
K3_OPS = ("LDS", "STS", "LDG", "STG", "POPC", "MUFU", "BAR", "ALL")


def main_k3_against(src_dirs: list[Path]) -> None:
    """K3 against other ``sgm_volume.cu`` sources in one process (the
    parent's first, then trial copies): at each instance of ``K3_SWEEP``
    every library's volume compared bitwise with this one's, and this
    one's with the plain version, then the call timed in turns beside
    ``k3_bound_ms``, with the route ``k3_route`` takes; each library's
    SASS counts per kernel and loop and registers.  A library without
    ``sgm_volume_route`` (the parent's) takes the C entry without a route
    argument; this one takes ``k3_route``'s route."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from stereomatching_tpu_torch.ops import costvolume, fused_sgm
    from stereomatching_tpu_torch.utils.bench import k3_bound_ms
    from stereomatching_tpu_torch.utils.build import _target

    smi = "{name}, {power_limit}".format(**card(torch.device("cuda", 0)))
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"clocks (sm, mem, power, temp) {clocks()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libraries("sgm_volume", src_dirs, tmp)
        fns = {}
        for label, so in libs.items():
            print_build(label, so, K3_OPS)
            lib = ctypes.CDLL(str(so))
            routed = hasattr(lib, "sgm_volume_route")
            lib.sgm_volume.argtypes = fused_sgm._SIGNATURES["sgm_volume"][:None if routed else -2] + [
                ctypes.c_void_p] * (0 if routed else 1)
            lib.sgm_volume.restype = ctypes.c_int
            fns[label] = (lib.sgm_volume, routed)
        others = [k for k in fns if k != "this"]
        order = [*others, "this"]
        order = order + order[::-1]
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        for cost, dtype_name, d in K3_SWEEP:
            dtype = getattr(torch, dtype_name)
            batch = max(1, 8 * 64 // max(d, 64))
            pix = [torch.from_numpy(rng.integers(0, 256, (batch, SIZE, SIZE), dtype=np.uint8))
                   .to(dev).to(torch.int32) for _ in range(2)]
            ref, other = ([costvolume.census_transform(x).contiguous() for x in pix]
                          if cost == "census" else pix)
            vols = {label: torch.empty((batch, SIZE, SIZE, d), dtype=dtype, device=dev)
                    for label in fns}
            route = fused_sgm.k3_route(vols["this"].shape, dtype)

            def call(label):
                fn, routed = fns[label]
                extra = [fused_sgm.K3_ROUTES.index(route)] if routed else []
                vol = vols[label]
                err = fn(ref.data_ptr(), other.data_ptr(), vol.data_ptr(), batch, SIZE, SIZE, d,
                         int(cost == "census"), vol.element_size(), *extra,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K3 {label} failed: CUDA error {err}")

            for label in fns:
                call(label)
            if not torch.equal(vols["this"], fused_sgm.sgm_volume_reference(ref, other, d, cost,
                                                                            dtype)):
                sys.exit(f"K3 this differs from the plain version at {cost} {dtype_name} D {d}")
            for label in others:
                if not torch.equal(vols[label], vols["this"]):
                    sys.exit(f"K3 {label} differs from this at {cost} {dtype_name} D {d}")
            times = time_in_turns(order, lambda label: (lambda: call(label)), 10)
            bd = k3_bound_ms(batch * SIZE * SIZE, d, vols["this"].element_size(), cost)
            print(f"[k3 instance] {cost} {dtype_name} D {d}, {batch}x{SIZE}x{SIZE}: equal to each "
                  f"other and to the plain version; this: {route}; bound {bd[0]:.4f} ms "
                  f"({bd[1]}); ms per call " + turns_text(times), flush=True)
            del pix, ref, other, vols
    print(f"[k3 against] this library: {_target('sgm_volume').name}; card {smi}; "
          f"clocks (sm, mem, power, temp) {clocks()}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pipeline", choices=("classic", "reference", *MODERN),
                        default="classic")
    parser.add_argument("--mesh", metavar="DATAxROWS",
                        help="profile the sharded tier on a data x rows mesh on cuda:0")
    parser.add_argument("--k1-against", metavar="DIR", type=Path,
                        help="time K1 against the match_score_edges.cu in DIR")
    parser.add_argument("--k8-against", metavar="DIR", type=Path,
                        help="time K8 and K9 against the match_and_score.cu in DIR")
    parser.add_argument("--k4-against", metavar="DIR", type=Path, nargs="+",
                        help="time K4 against the sgm_directional.cu in each DIR")
    parser.add_argument("--k7-against", metavar="DIR", type=Path, nargs="+",
                        help="time K7 against the disparity.cu in each DIR")
    parser.add_argument("--k5-against", metavar="DIR", type=Path, nargs="+",
                        help="time K5 against the sgm_tail.cu in each DIR")
    parser.add_argument("--k2-against", metavar="DIR", type=Path, nargs="+",
                        help="time K2 against the fill_web_holes.cu in each DIR (the parent's first)")
    parser.add_argument("--k6-against", metavar="DIR", type=Path, nargs="+",
                        help="time K6 against the fill_invalid.cu in each DIR (the parent's first)")
    parser.add_argument("--k3-against", metavar="DIR", type=Path, nargs="+",
                        help="time K3 against the sgm_volume.cu in each DIR (the parent's first)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.k1_against:
        main_k1_against(args.k1_against.resolve())
    elif args.k8_against:
        main_k8_against(args.k8_against.resolve())
    elif args.k4_against:
        main_k4_against([d.resolve() for d in args.k4_against])
    elif args.k7_against:
        main_k7_against([d.resolve() for d in args.k7_against])
    elif args.k5_against:
        main_k5_against([d.resolve() for d in args.k5_against])
    elif args.k2_against:
        main_k2_against([d.resolve() for d in args.k2_against])
    elif args.k6_against:
        main_k6_against([d.resolve() for d in args.k6_against])
    elif args.k3_against:
        main_k3_against([d.resolve() for d in args.k3_against])
    elif args.mesh:
        data, rows = (int(x) for x in args.mesh.split("x"))
        main_sharded(args.pipeline, data, rows)
    elif args.pipeline in ("classic", "reference"):
        main_classic("exact" if args.pipeline == "classic" else "reference")
    else:
        main_modern(args.pipeline)


if __name__ == "__main__":
    main()
