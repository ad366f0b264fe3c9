"""``python -m stereomatching_tpu_torch.bench`` -- per-phase breakdown and
the reference's size-sweep measurement (test/time.sh + make graphs) of
the classic pipeline (counterpart of ``python -m stereomatching_tpu.bench``),
on the card unless ``--device cpu``.

Usage:
  python -m stereomatching_tpu_torch.bench [--sizes 135x240,270x480,...]
      [--phases-size 1080x1920] [--iters 3] [--shifts 30] [--mode ghost]
      [--plain] [--device cuda] [--json] [--graphs DIR] [--trace DIR]

The first line on stderr names the device (a card's name and power
limit).  ``--plain`` times the kernels' plain torch versions on the same
device in their place; ``--json`` adds a JSON line per phase and per size
(``tools/render_graphs_torch.py`` renders the graphs from them where
matplotlib is installed); ``--trace DIR`` writes a ``torch.profiler``
Chrome trace of the sweep into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from stereomatching_tpu_torch.bench.harness import (
    phase_timings, pixel_passes, size_sweep, tier_name)
from stereomatching_tpu_torch.bench.roofline import card
from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.utils.device import resolve_device

# The reference's fixture resolutions (test/imgs/{1..5}-WxH).
DEFAULT_SIZES = "135x240,270x480,540x960,1080x1920,2160x3840"


def _parse_sizes(s: str):
    out = []
    for item in s.split(","):
        h, w = item.lower().split("x")
        out.append((int(h), int(w)))
    return out


def _trace(trace_dir, device):
    """A ``torch.profiler`` context writing a Chrome trace into
    ``trace_dir`` on exit (a null context without one)."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    @contextlib.contextmanager
    def traced():
        with profile(activities=acts) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "sweep_trace.json"))

    return traced()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default=DEFAULT_SIZES, help="HxW list, comma-separated")
    p.add_argument("--phases-size", default="1080x1920")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--shifts", type=int, default=30)
    p.add_argument("--mode", choices=["wrap", "ghost"], default="ghost")
    p.add_argument("--plain", action="store_true",
                   help="time the kernels' plain torch versions in their place")
    p.add_argument("--device", default="cuda")
    p.add_argument("--graphs", default=None, help="write PNG graphs to this dir")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the sweep into DIR "
                        "(view with chrome://tracing or Perfetto)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    info = card(dev)
    params = StereoParams(
        num_shifts=args.shifts, mode=BoundaryMode(args.mode), edge_rule="exact"
    )
    tier = tier_name(args.plain, dev)
    print(f"# device={info['name']} power_limit={info['power_limit']} "
          f"D={args.shifts} sw={params.square_width} times={params.times} "
          f"mode={args.mode} tier={tier}", file=sys.stderr)

    ph, pw = _parse_sizes(args.phases_size)[0]
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, size=(ph, pw)).astype(np.float32) / 256.0
    right = rng.integers(0, 256, size=(ph, pw)).astype(np.float32) / 256.0

    print(f"== per-phase breakdown @ {pw}x{ph} ==")
    for r in phase_timings(left, right, params, args.iters, dev, args.plain):
        print(r.row())
        if args.json:
            print(json.dumps({"phase": r.name, "mean_s": r.mean_s, "min_s": r.min_s}))

    print("== size sweep (end-to-end) ==")
    with _trace(args.trace, dev):
        sweep = size_sweep(_parse_sizes(args.sizes), params, args.iters, dev, args.plain)
    for r in sweep:
        gpps = r.pixels_per_s / 1e9
        print(f"{r.row()}   {gpps:8.2f} Gpixel-passes/s")
        if args.json:
            print(json.dumps({"size": r.name, "mean_s": r.mean_s, "min_s": r.min_s,
                              "std_s": r.std_s, "iters": r.iters, "pixels": r.pixels,
                              "gpixel_passes_per_s": gpps, "tier": tier,
                              "device": info["name"], "power_limit": info["power_limit"]}))
    if args.trace:
        print(f"trace written to {args.trace}")

    if args.graphs:
        from stereomatching_tpu_torch.bench.graphs import throughput_graph, times_graph

        os.makedirs(args.graphs, exist_ok=True)
        wrote = times_graph({tier: sweep}, os.path.join(args.graphs, "times.png"))
        wrote &= throughput_graph(
            sweep,
            os.path.join(args.graphs, "throughput.png"),
            title=f"{tier}, {pixel_passes(params)} passes/px",
        )
        if wrote:
            print(f"graphs written to {args.graphs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
