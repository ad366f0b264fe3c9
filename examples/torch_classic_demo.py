#!/usr/bin/env python
"""End-to-end classic pipeline demo on the PyTorch port (the counterpart
of ``examples/classic_demo.py``).

Loads a stereo pair (by default the port's synthetic ``blob_scene`` at
135x240, the reference's smallest fixture size), runs ``Matcher`` in both
boundary modes on ``--device`` (``cuda``, the default, runs the CUDA
kernels; ``cpu`` their plain torch versions), writes the contour map,
elevation web and edge map as PPM images, and prints the
reference-compatible timing line for each mode.

    python examples/torch_classic_demo.py [left.png right.png] [--outdir out] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("left", nargs="?", help="left image (default: a synthetic scene)")
    p.add_argument("right", nargs="?")
    p.add_argument("--outdir", default="demo_out")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args()

    import numpy as np

    from stereomatching_tpu_torch import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.serving import Matcher
    from stereomatching_tpu_torch.utils.imageio import (
        artifact_ppm_type,
        read_png_gray,
        write_ppm,
    )
    from stereomatching_tpu_torch.utils.synthetic import blob_scene

    if args.left and args.right:
        left = read_png_gray(args.left)
        right = read_png_gray(args.right)
    elif args.left or args.right:
        p.error("give both images or neither")
    else:
        left, right, _ = blob_scene(135, 240)
    h, w = left.shape
    print(f"pair: {w}x{h}")

    os.makedirs(args.outdir, exist_ok=True)
    for mode in (BoundaryMode.WRAP, BoundaryMode.GHOST):
        params = StereoParams(mode=mode, edge_rule="exact")
        matcher = Matcher(params, device=args.device)
        t1 = time.monotonic()
        arts = matcher(left, right)  # numpy out: the device has finished
        t2 = time.monotonic()
        for name in ("output-0", "web-2", "edges-1"):
            path = os.path.join(args.outdir, f"{mode.value}-{name}.ppm")
            write_ppm(path, np.asarray(arts[name]), artifact_ppm_type(name))
        print(f"{mode.value}: elevations [{int(arts['min_elevation'])}, "
              f"{int(arts['max_elevation'])}] on {matcher.device} (on a GPU the "
              f"first call also builds and loads the kernels); artifacts in {args.outdir}/")
        print(f"width = {w}, height = {h}, t1 = {t1:f}, t2 = {t2:f}, "
              f"elapsed = {t2 - t1:f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
