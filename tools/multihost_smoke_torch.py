#!/usr/bin/env python
"""Multi-process smoke of the port's sharded tier (counterpart of
``tools/multihost_smoke.py``).

Launches ``--procs`` OS processes that start ``torch.distributed``
(``parallel/distributed.initialize`` on a localhost address): on the
card by default, NCCL with one GPU per rank and its shards on it; gloo
with every shard on the CPU only with ``--device cpu``.  Together they run ONE sharded classic step (ghost, exact
rule) over a (data=1, rows=procs x local) mesh on a
``utils.synthetic.blob_scene`` pair.  Each rank builds its inputs shard
by shard (``Sharded.from_callback``, the JAX tool's
``jax.make_array_from_callback``: the callback is asked only for the
shards the rank holds), and checks the output shards it holds
(``addressable_shards``, by their global index) against the port's numpy
oracle (``oracle/pipeline.run_pipeline``); no plane is gathered.
Each rank then times the exchange of one 1024-wide int32 row with its
ring neighbour (``DistComm.shift``, the halo exchange's message), the
measured counterpart of ``bench.roofline.Peaks.exchange_latency_us``.

    python tools/multihost_smoke_torch.py [--procs 2] [--local-shards 2]
        [--device cuda|cpu] [--port P]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Exchanges timed for the latency figure, after as many untimed.
LATENCY_ROUNDS = 200


def _say(line: str) -> None:
    """One line to stdout in one write, so the ranks' lines never mix."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


def _exchange_us(procs: int, rank: int, device) -> float:
    """Mean microseconds of one exchange of a 1024-wide int32 row: every
    rank sends its row to the next rank of the ring and receives the
    previous one's, ``LATENCY_ROUNDS`` times in a row."""
    import torch
    import torch.distributed as dist

    from stereomatching_tpu_torch.parallel.distributed import DistComm

    comm = DistComm((1, procs, 1), (0, rank, 0))
    row = torch.arange(1024, dtype=torch.int32, device=device) + rank

    def rounds(n):
        for _ in range(n):
            got = comm.shift(row, 1, 1, circular=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return got

    got = rounds(LATENCY_ROUNDS)
    want = torch.arange(1024, dtype=torch.int32, device=device) + (rank - 1) % procs
    if not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: the exchanged row is not the neighbour's")
    dist.barrier()
    t0 = time.perf_counter()
    rounds(LATENCY_ROUNDS)
    return (time.perf_counter() - t0) / LATENCY_ROUNDS * 1e6


def worker(port: int, procs: int, pid: int, local: int, device_type: str) -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.oracle import pipeline as oracle
    from stereomatching_tpu_torch.parallel import (
        Sharded, build_sharded_pipeline, distributed, make_mesh)
    from stereomatching_tpu_torch.utils.device import resolve_device
    from stereomatching_tpu_torch.utils.imageio import to_brightness
    from stereomatching_tpu_torch.utils.synthetic import blob_scene

    if device_type == "cuda":
        backend = "nccl"
        device = resolve_device(f"cuda:{pid}")
        torch.cuda.set_device(device)
        devices = [torch.device("cuda", r) for r in range(procs) for _ in range(local)]
    else:
        backend = "gloo"
        device = resolve_device("cpu")
        devices = [device] * (procs * local)
    distributed.initialize(f"tcp://localhost:{port}", world_size=procs, rank=pid,
                           backend=backend)
    n = procs * local
    params = StereoParams(
        square_width=9, times=4, lines=4, num_shifts=8,
        mode=BoundaryMode.GHOST, edge_rule="exact",
    )
    mesh = make_mesh(data=1, rows=n, devices=devices)
    h, w = n * 8, 64
    left_u8, right_u8, _ = blob_scene(h=h, w=w, seed=0)
    left = to_brightness(left_u8, np.float32)[None]
    right = to_brightness(right_u8, np.float32)[None]

    # Global arrays assembled shard by shard: each rank serves the global
    # slices its blocks own (the pod-slice input path).
    asked = []

    def serve(src):
        def cb(index):
            asked.append(index)
            return src[index]
        return cb

    gl = Sharded.from_callback(left.shape, mesh, serve(left))
    gr = Sharded.from_callback(right.shape, mesh, serve(right))
    mine = {(slice(None), slice(s * 8, (s + 1) * 8), slice(None))
            for s in range(pid * local, (pid + 1) * local)}
    if set(asked) != mine or len(asked) != 2 * local:
        raise AssertionError(f"rank {pid}: the callback was asked for {asked}, "
                             f"not its own shards {sorted(mine, key=str)}")
    web = build_sharded_pipeline(params, mesh)(gl, gr)["web-2"]
    # Each rank checks the shards it holds against the oracle.
    want = oracle.run_pipeline(
        to_brightness(left_u8), to_brightness(right_u8), params
    )["web-2"]
    checked = 0
    for index, shard in web.addressable_shards:
        if index not in mine:
            raise AssertionError(f"rank {pid} holds a shard at {index}, not its own")
        np.testing.assert_array_equal(shard.cpu().numpy()[0], want[index[1]])
        checked += 1
    _say(f"proc {pid}: {checked} shards bit-identical to oracle")

    us = _exchange_us(procs, pid, device)
    _say(json.dumps({"proc": pid, "backend": backend, "exchange_row_int32": 1024,
                     "exchange_us": us}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--local-shards", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: NCCL, one GPU per rank; cpu: gloo")
    p.add_argument("--port", type=int, default=None, help="default: a free localhost port")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    port = args.port or _free_port()
    if args.worker is not None:
        return worker(port, args.procs, args.worker, args.local_shards, args.device)
    if args.device == "cuda":
        sys.path.insert(0, REPO)
        from stereomatching_tpu_torch.utils.device import resolve_device

        resolve_device(f"cuda:{args.procs - 1}")  # one GPU per rank, or raise

    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    children = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--procs", str(args.procs), "--local-shards", str(args.local_shards),
             "--device", args.device, "--port", str(port), "--worker", str(i)],
            env={**env, "PYTHONPATH": REPO},
        )
        for i in range(args.procs)
    ]
    rc = 0
    try:
        for c in children:
            rc |= c.wait(timeout=args.timeout)
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                rc |= 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
