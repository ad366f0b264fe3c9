#!/usr/bin/env python
"""The reference's full size sweep on the port (counterpart of
``tools/size_sweep_tpu.py``; report/data.txt rows 1-4, test/time.sh):
the classic pipeline at the five fixture sizes plus the 8K synthetic, on
the production path (the kernels, exact edge rule, ghost mode).

Honest timing: each iteration takes a distinct batch, already on the
device, and the sum of its ``score_best``, ``web-2``, ``output-0`` and
``edges-1`` planes is read back before the next one starts (the JAX
tool's in-jit sum and ``device_get``).  The batch is fitted to memory by
the JAX tool's rule, which gives batch 4 at 7680x4320.  Each size draws
its pairs from ``numpy.random.default_rng((SEED, w, h))``, so a size
gives the same checksum alone as inside the ladder.  Prints one JSON
line per size: the JAX tool's keys (``size``, ``batch``, ``d``,
``ms_per_pair``, ``pairs_per_sec``, ``checksum``: the sum over every
iteration, the warmup's included) plus ``route``, ``device``,
``peak_mib`` (the device's peak allocation; null on the CPU) and
``card`` (``nvidia-smi``'s name and power limit; null on the CPU).

    python tools/size_sweep_torch.py [--sizes 1920x1080,7680x4320]
        [--disparities 64] [--iters 3] [--device cuda|cpu]

The card is the default, with no fallback: ``--device cpu`` runs the
kernels' plain versions on the CPU.  ``run_size(..., plain=True)`` runs
them on the card (``chip_smoke.py`` phase 36 checks the 8K checksum so).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (W, H): the reference's fixture ladder (test/imgs/{1..5}-*) and 8K,
# the JAX tool's SIZES.
SIZES = [(240, 135), (480, 270), (960, 540), (1920, 1080),
         (3840, 2160), (7680, 4320)]
# The planes the checksum sums, the JAX tool's.
PLANES = ("score_best", "web-2", "output-0", "edges-1")
SEED = 0


def batch_for(w: int, h: int) -> int:
    """The JAX tool's batch: the power of two nearest below 128 Mi
    pixels / (w h), between 1 and 128."""
    return max(1, min(128, int(2 ** math.floor(math.log2(128 * 1024 * 1024 / max(w * h, 1))))))


def parse_sizes(text: Optional[str]) -> List[Tuple[int, int]]:
    """``"WxH,WxH"`` -> [(W, H), ...]; None -> ``SIZES``."""
    if not text:
        return list(SIZES)
    return [tuple(int(v) for v in s.split("x")) for s in text.split(",")]


def sweep_pairs(w: int, h: int, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The ``n`` (left, right) uint8 batches [batch_for(w, h), h, w] a
    size's iterations take, the warmup's first."""
    rng = np.random.default_rng((SEED, w, h))
    b = batch_for(w, h)
    return [tuple(rng.integers(0, 256, (b, h, w), dtype=np.uint8) for _ in range(2))
            for _ in range(n)]


def plane_sum(out: Dict) -> "torch.Tensor":
    """The sum of ``PLANES`` of an artifact dict, an int64 scalar on
    their device."""
    import torch

    return sum(out[k].sum(dtype=torch.int64) for k in PLANES)


def run_size(w: int, h: int, disparities: int = 64, iters: int = 3, device="cuda",
             plain: bool = False) -> Dict[str, object]:
    """One size of the sweep -> its JSON record; ``plain`` runs the
    kernels' plain versions in their place."""
    import torch

    from stereomatching_tpu_torch.bench.harness import time_fn
    from stereomatching_tpu_torch.bench.roofline import card
    from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.models.classic import (
        build_classic_pipeline, classic_forward_reference)
    from stereomatching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    params = StereoParams(num_shifts=disparities, mode=BoundaryMode.GHOST, edge_rule="exact")
    params.validate_for_image(w, h)
    pipe = (torch.no_grad()(lambda a, b: classic_forward_reference(a, b, params)) if plain
            else build_classic_pipeline(params))
    batch = batch_for(w, h)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ins = iter([tuple(torch.from_numpy(x).to(dev).to(torch.float32) / 256.0 for x in pair)
                for pair in sweep_pairs(w, h, iters + 1)])
    sums = []

    def step():
        sums.append(int(plane_sum(pipe(*next(ins)))))

    res = time_fn(step, (), iters=iters, warmup=1, device=dev)
    ms = res.mean_s * 1e3 / batch
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
    info = card(dev)
    return {
        "size": f"{w}x{h}", "batch": batch, "d": disparities,
        "ms_per_pair": ms, "pairs_per_sec": 1e3 / ms, "checksum": sum(sums),
        "route": "plain" if plain or dev.type == "cpu" else "kernels",
        "device": str(dev), "peak_mib": peak,
        "card": f"{info['name']}, {info['power_limit']}" if dev.type == "cuda" else None,
    }


def sweep(sizes: Sequence[Tuple[int, int]] = SIZES, disparities: int = 64, iters: int = 3,
          device="cuda") -> List[Dict[str, object]]:
    """``run_size`` over ``sizes``, each record printed as it comes."""
    out = []
    for w, h in sizes:
        out.append(run_size(w, h, disparities, iters, device))
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=str, default=None,
                   help="comma list like 1920x1080,7680x4320 (default: the ladder)")
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sweep(parse_sizes(args.sizes), args.disparities, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
