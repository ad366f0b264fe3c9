#!/usr/bin/env python
"""Render the size sweep's graphs from the JSON lines that ``python -m
stereomatching_tpu_torch.bench --json`` printed (counterpart of
``tools/render_docs_graphs.py``, which draws numbers written into it; this
one draws only what a run measured).  The GPU host may have no
matplotlib, so a sweep run there keeps its output and the graphs are
drawn where matplotlib is installed:

    python tools/render_graphs_torch.py bench.log [more.log ...] \
        [--out build/graphs]

Each file may hold other lines too; the JSON lines with a "size" key are
read, one series per (device, tier: kernels or plain).  Writes
``times.png`` (every series), ``throughput_<series>.png`` (each) and,
when a device has both tiers, ``speedup_<device>.png`` (plain / kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from stereomatching_tpu_torch.bench.graphs import speedup_graph, throughput_graph, times_graph
from stereomatching_tpu_torch.bench.harness import BenchResult


def read_series(paths) -> Dict[str, List[BenchResult]]:
    """{"<device>, <tier>": the sweep's results in file order}."""
    series: Dict[str, List[BenchResult]] = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if "size" not in rec:
                    continue
                key = f"{rec['device']}, {rec['tier']}"
                series.setdefault(key, []).append(BenchResult(
                    rec["size"], rec["mean_s"], rec["min_s"], rec["std_s"], rec["iters"],
                    pixels=rec["pixels"]))
    return series


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "_", s).strip("_")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("inputs", nargs="+", help="files holding the bench's --json lines")
    p.add_argument("--out", default=os.path.join("build", "graphs"))
    args = p.parse_args(argv)

    series = read_series(args.inputs)
    if not series:
        print("no size-sweep JSON lines found", file=sys.stderr)
        return 1
    sizes = {tuple(r.name for r in rs) for rs in series.values()}
    if len(sizes) != 1:
        print(f"the series sweep different sizes: {sorted(sizes)}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    written = [os.path.join(args.out, "times.png")]
    ok = times_graph(series, written[0])
    for key, rs in series.items():
        written.append(os.path.join(args.out, f"throughput_{_slug(key)}.png"))
        ok &= throughput_graph(rs, written[-1], title=key)
    for key in series:
        device, tier = key.rsplit(", ", 1)
        if tier == "kernels" and f"{device}, plain" in series:
            written.append(os.path.join(args.out, f"speedup_{_slug(device)}.png"))
            ok &= speedup_graph(series[f"{device}, plain"], series[key], written[-1],
                                label="plain / kernels")
    if not ok:
        return 1
    print(f"rendered {len(written)} graphs into {os.path.normpath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
