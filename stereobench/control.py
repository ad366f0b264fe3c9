#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below
the configuration's stated float32 (bfloat16 for every float operation;
the integer work stays exact), driven through the harness's own run at
the cell's sizes and load, on several seeds in one process.  It has to
come out as not correct on every seed.

    python3 stereobench/control.py --workload <name> --seeds 1 2 3 [--seconds 4]

Prints one JSON line per seed with its checks, then one line with the
least reading of each number over the seeds.  Runs on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def control_program(cell, float_dtype=torch.bfloat16):
    """The reference in ``float_dtype``, in blocks of the route's
    ``reference_block`` pairs, as a program: (left, right) -> planes."""
    t = cell.traffic
    block = cell.route.reference_block(cell.params, t["height"], t["width"])

    def program(left, right):
        parts = [cell.route.reference(left[i: i + block], right[i: i + block], cell.params,
                                      float_dtype) for i in range(0, left.shape[0], block)]
        return {p: torch.cat([x[p] for x in parts]) for p in cell.route.PLANES}

    return program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from stereobench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    least = {}
    for seed in args.seeds:
        res = harness.run(cell, seed, args.seconds, False, device, time.perf_counter(),
                          program=control_program(cell))
        r = res.result
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": res.checks}), flush=True)
        for name, c in res.checks.items():
            least[name] = min(least.get(name, c["value"]), c["value"])
    print(json.dumps({"workload": cell.name, "seeds": args.seeds, "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
