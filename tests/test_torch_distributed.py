"""The port's sharded tier across OS processes: two ``torch.distributed``
ranks (gloo, CPU), each holding a block of two shards of a rows-4 mesh,
exchange their halos, the contour's per-image range and the SGM chain's
carries through point-to-point sends and collectives.  Every output
plane must equal the single-device pipeline's bit for bit (classic ghost
with the exact rule, and SGM census with 8 paths): each shard a rank
holds at its global index, and the planes ``to_global`` gathers on every
rank.  Inputs come both as global batches and shard by shard from a
callback (``Sharded.from_callback``), which each rank must ask for its
own shards only.  A pixel out of the box route's SAD range in one
rank's rows makes every rank raise.  On a host with
several GPUs the same check runs with one NCCL rank per GPU, one shard
each (marked ``cuda``; skips with fewer than two GPUs).

The tests run this file as the worker, ``python
tests/test_torch_distributed.py RANK WORLD PORT BACKEND``, one process
per rank on a free localhost port.  The worker imports no jax.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(n, h, w, seed):
    # tests/util.py by its path: a host may have another package named
    # ``tests`` on its path, which would shadow this directory.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_stereo_test_util", os.path.join(ROOT, "tests", "util.py"))
    util = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(util)
    ps = [util.synthetic_pair(h, w, seed=seed + i) for i in range(n)]
    return np.stack([a for a, _ in ps]), np.stack([b for _, b in ps])


def worker(rank: int, world: int, port: int, backend: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.models.classic import classic_forward_batched
    from stereomatching_tpu_torch.models.modern import modern_forward
    from stereomatching_tpu_torch.parallel import (
        Sharded, build_sharded_modern_pipeline, build_sharded_pipeline, distributed, make_mesh)

    if backend == "nccl":  # one shard per rank, on the rank's GPU
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        devices, per_rank = [torch.device("cuda", r) for r in range(world)], 1
    else:  # two shards per rank, on the CPU
        dev = torch.device("cpu")
        devices, per_rank = ["cpu"] * (2 * world), 2
    distributed.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank,
                           backend=backend)
    mesh = make_mesh(data=1, rows=per_rank * world, devices=devices)
    assert mesh.blocks[0] == (1, per_rank, 1), mesh.blocks
    l_u8, r_u8 = _pairs(2, 48, 64, seed=40)

    cparams = StereoParams(square_width=9, times=6, lines=4, num_shifts=12,
                           mode=BoundaryMode.GHOST, edge_rule="exact")
    lf, rf = (torch.from_numpy(x.astype(np.float32) / np.float32(256.0)).to(dev)
              for x in (l_u8, r_u8))
    mparams = ModernParams(num_disparities=8, aggregation="sgm", cost="census",
                           sgm_directions=8, median_filter=True, uniqueness=True)
    lp, rp = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (l_u8, r_u8))
    asked = []

    def placed(x):
        """x laid out on the mesh from a callback that serves its slices."""
        host = x.cpu()

        def cb(index):
            asked.append(index)
            return host[index]
        return Sharded.from_callback(tuple(x.shape), mesh, cb)

    csh, msh = [placed(x) for x in (lf[:1], rf[:1])], [placed(x) for x in (lp, rp)]
    mine = {(slice(None), slice(s * 12, (s + 1) * 12), slice(None))
            for s in range(rank * per_rank, (rank + 1) * per_rank)}
    assert set(asked) == mine and len(asked) == 4 * per_rank, (rank, asked)
    cfn, mfn = build_sharded_pipeline(cparams, mesh), build_sharded_modern_pipeline(mparams, mesh)
    cwant, mwant = classic_forward_batched(lf[:1], rf[:1], cparams), modern_forward(lp, rp, mparams)
    runs = [
        ("classic", cfn(lf[:1], rf[:1]), cwant),
        ("classic from callbacks", cfn(*csh), cwant),
        ("sgm", mfn(lp, rp), mwant),
        ("sgm from callbacks", mfn(*msh), mwant),
    ]
    for name, got, want in runs:
        assert sorted(got) == sorted(want), (name, sorted(got))
        for k, v in want.items():
            for index, shard in got[k].addressable_shards:
                assert len(index) == 1 or index in mine, (name, index)  # per image, or a plane
                assert torch.equal(shard, v[index]), f"rank {rank} {name} {k} at {index}"
            g = got[k].to_global()
            assert g.dtype == v.dtype and torch.equal(g, v), f"rank {rank} {name} {k}"
    # A pixel out of the box route's SAD range in rank 0's rows only:
    # every rank raises, none goes on into the halo exchanges.
    bad = lp.clone()
    bad[0, 0, 0] = 300
    box = build_sharded_modern_pipeline(ModernParams(num_disparities=8, cost="sad"), mesh)
    with pytest.raises(ValueError, match="0..255"):
        box(placed(bad), placed(rp))
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: sharded == single-device")


def _run_ranks(world: int, backend: str) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port), backend],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
        assert f"rank {r}: sharded == single-device" in out


@pytest.mark.multiprocess
def test_two_gloo_ranks_match_single_device():
    _run_ranks(2, "gloo")


@pytest.mark.cuda
@pytest.mark.multiprocess
def test_nccl_ranks_match_single_device():
    import torch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more GPUs (one NCCL rank per GPU)")
    _run_ranks(torch.cuda.device_count(), "nccl")


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
