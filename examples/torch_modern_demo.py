#!/usr/bin/env python
"""Modern pipeline demo on the PyTorch port (the counterpart of
``examples/modern_demo.py``): census cost + SGM vs box aggregation on a
synthetic scene with ground truth, reporting Middlebury-style metrics.

    python examples/torch_modern_demo.py [--disparities 16] [--outdir out] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--disparities", type=int, default=16)
    p.add_argument("--outdir", default="demo_out")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args()

    import numpy as np

    from stereomatching_tpu_torch import ModernParams
    from stereomatching_tpu_torch.serving import ModernMatcher
    from stereomatching_tpu_torch.utils.metrics import disparity_report
    from stereomatching_tpu_torch.utils.synthetic import blob_scene

    left, right, gt = blob_scene(
        h=270, w=480, seed=0, max_disparity=args.disparities // 2
    )
    os.makedirs(args.outdir, exist_ok=True)

    for label, params in {
        "box-sad": ModernParams(num_disparities=args.disparities, window=9),
        "box-census": ModernParams(
            num_disparities=args.disparities, window=9, cost="census"
        ),
        "sgm-census": ModernParams(
            num_disparities=args.disparities, cost="census", aggregation="sgm"
        ),
        # The full quality stack: 8 aggregation paths, median speckle
        # smoothing, uniqueness confidence, background-extension
        # occlusion filling.
        "sgm-8dir-full": ModernParams(
            num_disparities=args.disparities, cost="census",
            aggregation="sgm", sgm_directions=8, median_filter=True,
            uniqueness=True, fill_mode="background",
        ),
    }.items():
        out = ModernMatcher(params, device=args.device)(left, right)
        rep = disparity_report(
            np.asarray(out["subpixel"]), gt.astype(np.float64),
            np.asarray(out["valid"]),
        )
        print(f"{label:12s} {json.dumps(rep)}")
        np.save(os.path.join(args.outdir, f"{label}-disparity.npy"),
                np.asarray(out["filled"]))
    print(f"disparity maps in {args.outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
