#!/usr/bin/env python
"""Serving demo on the PyTorch port (the counterpart of
``examples/serving_demo.py``): ``Matcher`` on one device,
``ModernMatcher`` sharded over a device mesh, and ``Matcher`` on the same
mesh fed the loader's mesh-placed batch block by block, all fed by the
prefetching ``BatchLoader`` from PNG pairs that the demo writes to a
temporary directory.

The sharded leg runs on a virtual mesh whose shards all live on the one
device (``--device cuda``: ``cuda:0`` repeated; ``--device cpu``: a
virtual CPU mesh), the counterpart of the JAX demo's emulated CPU mesh;
on a multi-GPU host the same code takes a list of GPUs.

    python examples/torch_serving_demo.py [--devices 4] [--batch 8] [--size 256] [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=4,
                   help="shards of the sharded leg's virtual mesh")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args()

    import numpy as np
    import torch

    from stereomatching_tpu_torch.config import ModernParams, StereoParams
    from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset
    from stereomatching_tpu_torch.parallel import make_mesh
    from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
    from stereomatching_tpu_torch.utils.device import resolve_device
    from stereomatching_tpu_torch.utils.imageio import write_png_gray

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as root:
        for i in range(args.batch):
            for side in ("left", "right"):
                write_png_gray(os.path.join(root, f"pair{i:03d}_{side}.png"),
                               rng.integers(0, 256, (args.size, args.size), dtype=np.uint8))
        ds = StereoPairDataset.from_root(root)

        # --- the loader placing batches on the device ------------------
        host = next(iter(BatchLoader(ds, args.batch, device_put=False)))
        t0 = time.perf_counter()
        lt, rt, kept = next(iter(BatchLoader(ds, args.batch, device=dev)))
        same = torch.equal(lt.cpu(), torch.from_numpy(host[0]))
        print(f"loader: {len(ds)} pairs from PNG, batch {tuple(lt.shape)} {lt.dtype} on "
              f"{lt.device} ({kept} pairs) in {time.perf_counter() - t0:.3f}s; equal to "
              f"the host batch: {same}")

        # --- single-device classic serving ---------------------------
        m = Matcher(StereoParams(num_shifts=16), device=dev)
        lb, rb, kept = host
        t0 = time.perf_counter()
        out = m(lb, rb)
        print(f"classic single-device on {m.device}: contour {out['output-0'].shape} in "
              f"{time.perf_counter() - t0:.2f}s (on a GPU the first call also builds "
              f"and loads the kernels; repeat calls reuse them)")
        t0 = time.perf_counter()
        m(lb, rb)
        print(f"  warm repeat: {time.perf_counter() - t0:.3f}s")

        # --- sharded modern serving ----------------------------------
        n = args.devices
        data = 2 if n % 2 == 0 else 1
        mesh = make_mesh(data=data, rows=n // data, devices=[dev] * n)
        sm = ModernMatcher(
            ModernParams(num_disparities=16, aggregation="sgm", cost="census"),
            mesh=mesh,
        )
        lb, rb, kept = next(iter(BatchLoader(ds, args.batch, mesh=mesh, device_put=False)))
        # Brightness (pixel / 256) back to the 0..255 pixels ModernMatcher takes.
        lp, rp = ((x * 256).astype(np.int32) for x in (lb, rb))
        t0 = time.perf_counter()
        sout = sm(lp, rp)
        print(f"modern SGM sharded over {mesh.shape} on {dev}: disparity "
              f"{sout['disparity'].shape} in {time.perf_counter() - t0:.2f}s")
        # Odd global batches pad to the data axis and slice back — serve
        # a single pair through the same pipeline:
        one = sm(lp[:1], rp[:1])
        print(f"  single pair via pad-and-slice: {one['disparity'].shape}")

        # --- sharded classic serving, fed block by block ---------------
        # With a mesh the loader yields Sharded planes, each block staged
        # on its own device; the matcher takes them as they are.
        sl, sr, kept = next(iter(BatchLoader(ds, args.batch, mesh=mesh)))
        cm = Matcher(StereoParams(num_shifts=16), mesh=mesh)
        t0 = time.perf_counter()
        cout = cm(sl, sr)
        print(f"classic sharded over {mesh.shape}, fed the loader's {sl.layout} blocks "
              f"{[tuple(b.shape) for b in sl.blocks]}: contour {cout['output-0'].shape} in "
              f"{time.perf_counter() - t0:.2f}s; equal to the single-device matcher: "
              f"{np.array_equal(cout['output-0'], out['output-0'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
