#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on this machine's card:

    python3 stereobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers compared with the plain reference beside their
limits, which also close standard error.  Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for),
without the program beside the benchmark, or when a module of JAX or of
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "stereomatching_tpu_torch"
# Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "stereomatching_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def describe_card(device) -> dict:
    """The ``device`` entry of the result line."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit(index: int) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Import the benchmark and the program from this checkout alone.
    sys.path[0] = str(ROOT)
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"no {PROGRAM} package beside the benchmark in {ROOT}", file=sys.stderr)
        return 2
    # The program's kernels build under the checkout (its build/ directory);
    # caches a library of it could use stay there too.
    cache = ROOT / "build" / "stereobench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))

    import torch

    from stereobench import harness

    marks = [("imports", time.perf_counter())]

    cell = harness.load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros((), device=device)
    marks.append(("card", time.perf_counter()))

    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                      describe_device=lambda: describe_card(device), marks=marks)
    program = sys.modules.get(PROGRAM)
    if program is None or not Path(program.__file__).resolve().is_relative_to(ROOT):
        print(f"{PROGRAM} was not loaded from {ROOT}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result = res.result
    result["notes"].insert(0, f"card {power_limit(0)}; torch {torch.__version__}, "
                              f"CUDA {torch.version.cuda}")
    for line in result["notes"]:
        print(line, file=sys.stderr)
    print(f"correct = {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in res.checks.items():
        bound = (f"at most {c['at_most']}" if "at_most" in c else f"at least {c['at_least']}")
        print(f"check {name} = {c['value']} (limit: {bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
