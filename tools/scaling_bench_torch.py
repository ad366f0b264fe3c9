#!/usr/bin/env python
"""Weak-scaling benchmark of the port's sharded classic tier (counterpart
of ``tools/scaling_bench.py``): BASELINE.md's ">= 90% weak-scaling
efficiency at N >= 2" measurement.

Sweeps shard counts 1, 2, 4, ... along ``--axis rows`` (image height
grows with the mesh) or ``cols`` (width grows), keeping the work per
shard constant, through ``parallel.build_sharded_pipeline`` (ghost, exact
rule), and reports throughput and efficiency against the 1-shard run.
Each shard count is timed with the checksum discipline of
``bench.roofline``: a distinct batch on the device every iteration, each
output's last element summed there and read back once.  Where each shard
has a GPU of its own (rows axis), every result also carries the
efficiency ``roofline.weak_scaling_prediction`` gives from this run's
1-shard time and the exchange latency of ``roofline.Peaks``.

With one visible GPU the shards are stacked on ``cuda:0`` (one launch per
stage over all of them; the numbers exercise the harness, not the
interconnect); with several, one process runs a thread per GPU, one shard
each, their halos crossing between the cards.  ``--device cpu`` runs the
shards stacked on the CPU.

    python tools/scaling_bench_torch.py [--rows-per-shard 256] [--width 1024]
        [--batch 2] [--iters 3] [--max-shards N] [--axis rows|cols]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _devices(dev, shards: int) -> list:
    """One device per shard: each its own GPU where several are visible,
    else the one device repeated (the shards stacked on it)."""
    import torch

    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        if shards > torch.cuda.device_count():
            raise ValueError(f"{shards} shards > {torch.cuda.device_count()} visible GPUs")
        return [torch.device("cuda", i) for i in range(shards)]
    return [dev] * shards


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-shard", type=int, default=256)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--max-shards", type=int, default=None,
                   help="default: the visible GPUs where there are several, else 4")
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--axis", choices=["rows", "cols"], default="rows",
                   help="which spatial mesh axis to sweep (cols: W grows with the "
                        "shard count and x halos ride col exchanges)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from stereomatching_tpu_torch.bench.roofline import card, checksum, weak_scaling_prediction
    from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.parallel import build_sharded_pipeline, make_mesh
    from stereomatching_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    n_gpu = torch.cuda.device_count() if dev.type == "cuda" else 0
    max_shards = args.max_shards or (n_gpu if n_gpu > 1 else 4)
    params = StereoParams(
        num_shifts=args.disparities, mode=BoundaryMode.GHOST, edge_rule="exact"
    )
    rng = np.random.default_rng(args.seed)

    def sync(devices):
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    results = []
    shards = 1
    while shards <= max_shards:
        devices = _devices(dev, shards)
        if args.axis == "cols":
            h, w = args.rows_per_shard, shards * args.width
            mesh = make_mesh(data=1, rows=1, cols=shards, devices=devices)
        else:
            h, w = shards * args.rows_per_shard, args.width
            mesh = make_mesh(data=1, rows=shards, devices=devices)
        fn = build_sharded_pipeline(params, mesh)

        def step(left, right, fn=fn):
            out = fn(left, right)
            return checksum(out["web-2"], out["output-0"])

        batches = [
            tuple(torch.from_numpy(rng.integers(0, 256, (args.batch, h, w), dtype=np.uint8))
                  .to(devices[0]).to(torch.float32) / 256.0 for _ in range(2))
            for _ in range(args.iters + 1)
        ]
        float(step(*batches[0]))  # the kernels' build and first launch
        sync(devices)
        acc = torch.zeros((), dtype=torch.float64, device=devices[0])
        t0 = time.perf_counter()
        for left, right in batches[1:]:
            acc += step(left, right)
        total = float(acc)
        sync(devices)
        dt = time.perf_counter() - t0
        mpix_s = args.batch * args.iters * h * w / dt / 1e6
        results.append({"shards": shards, "height": h, "width": w, "devices": len(set(devices)),
                        "ms_per_batch": dt / args.iters * 1e3, "mpix_per_s": mpix_s,
                        "checksum": total})
        del batches
        shards *= 2

    base = results[0]["mpix_per_s"]
    model = weak_scaling_prediction(params, args.rows_per_shard, args.width, args.batch,
                                    [r["shards"] for r in results],
                                    compute_us=results[0]["ms_per_batch"] * 1e3)
    for r, m in zip(results, model):
        r["weak_scaling_efficiency"] = r["mpix_per_s"] / (base * r["shards"])
        own_gpus = args.axis == "rows" and r["devices"] == r["shards"]
        r["model_efficiency"] = m["predicted_efficiency"] if own_gpus else None
    info = card(dev)
    print(json.dumps({
        "device": info["name"],
        "power_limit": info["power_limit"],
        "visible_gpus": n_gpu,
        "axis": args.axis,
        "rows_per_shard": args.rows_per_shard,
        "batch": args.batch,
        "model_exchange_latency_us": model[0]["exchange_latency_us"],
        "results": results,
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
