#!/usr/bin/env python
"""Disparity quality evaluation on the PyTorch port — the counterpart of
``tools/eval_quality.py`` (the BASELINE.md bad-pixel-rate harness).

Runs the port's modern pipeline (SAD/census, box or SGM aggregation) on a
stereo pair and scores it against a ground-truth disparity map
(Middlebury-style bad-1/bad-2/EPE), with the arguments, scenes,
perturbations and JSON report of ``tools/eval_quality.py``:

    python tools/eval_quality_torch.py left.png right.png gt.pfm \\
        [--disparities 64] [--window 9] [--scales 1] [--gt-scale 1.0] \\
        [--device cuda|cpu]

``gt`` may be a Middlebury .pfm (NaN/inf == unknown), a disparity PNG
(16-bit KITTI value/256 with 0 invalid, or 8-bit integer-scaled — pass
``--gt-scale`` 0.25/0.125 for the quarter/eighth-pixel encodings), or a
.npy float/int array — see stereomatching_tpu_torch/data/formats.py.  With
``--synthetic N`` instead of file arguments, evaluates on the built-in
synthetic scene (exact ground truth) at max disparity N.

``--device cuda`` (the default) runs the pipeline's CUDA kernels and
fails without a GPU; ``--device cpu`` runs their plain torch versions.
Both give the same planes bit for bit, so the same report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("left", nargs="?")
    p.add_argument("right", nargs="?")
    p.add_argument("gt", nargs="?")
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--window", type=int, default=9)
    p.add_argument("--scales", type=int, default=1, choices=[1, 2])
    p.add_argument("--cost", default="sad", choices=["sad", "census"])
    p.add_argument("--aggregation", default="box", choices=["box", "sgm"])
    p.add_argument("--sgm-directions", type=int, default=4, choices=[4, 8])
    p.add_argument("--fill-mode", default="diffusion",
                   choices=["diffusion", "background"])
    p.add_argument("--uniqueness-min", type=float, default=None,
                   metavar="RATIO",
                   help="SGM only: also require the c2/c1 uniqueness "
                        "confidence >= RATIO for a pixel to count as "
                        "valid (OpenCV SGBM uses ~1.1)")
    p.add_argument("--gt-scale", type=float, default=None,
                   help="disparity = PNG value * scale (default: 1/256 "
                        "for 16-bit PNGs, 1.0 for 8-bit; ignored for "
                        ".pfm/.npy)")
    p.add_argument("--synthetic", type=int, default=None, metavar="MAX_D",
                   help="evaluate on a built-in synthetic scene instead")
    p.add_argument("--scene", default="blob",
                   choices=["blob", "slanted", "rds"],
                   help="which synthetic scene (--synthetic): textured "
                        "blobs, a slanted disparity ramp (sub-pixel and "
                        "diagonal-path probe), or a random-dot "
                        "stereogram")
    p.add_argument("--noise", type=float, default=0.0, metavar="SIGMA",
                   help="Gaussian pixel noise sigma added to both views "
                        "(photometric robustness probe)")
    p.add_argument("--gain", type=float, default=1.0,
                   help="exposure gain applied to the RIGHT view only — "
                        "the radiometric asymmetry census is invariant "
                        "to and SAD is not")
    p.add_argument("--bias", type=float, default=0.0,
                   help="intensity bias added to the RIGHT view only")
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA kernels; no GPU is an error) or "
                        "cpu (their plain torch versions)")
    args = p.parse_args()

    import torch

    from stereomatching_tpu_torch.config import ModernParams
    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.models.modern import ModernPipeline
    from stereomatching_tpu_torch.utils.device import resolve_device
    from stereomatching_tpu_torch.utils.imageio import read_png_gray
    from stereomatching_tpu_torch.utils.metrics import disparity_report
    from stereomatching_tpu_torch.utils.synthetic import blob_scene

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 1

    if args.synthetic is not None:
        if args.scene == "slanted":
            from stereomatching_tpu_torch.utils.synthetic import slanted_plane

            left, right, gt = slanted_plane(
                h=270, w=480, seed=0, d_min=1.0,
                d_max=float(args.synthetic),
            )
        elif args.scene == "rds":
            from stereomatching_tpu_torch.utils.synthetic import (
                random_dot_stereogram,
            )

            left, right, gt = random_dot_stereogram(
                h=270, w=480, seed=0, max_disparity=args.synthetic // 2
            )
        else:
            left, right, gt = blob_scene(
                h=270, w=480, seed=0, max_disparity=args.synthetic
            )
        gt = gt.astype(np.float64)
        if args.scene in ("blob", "rds"):
            from stereomatching_tpu_torch.utils.synthetic import occlusion_mask

            occ = occlusion_mask(gt.astype(np.int32))
        else:
            occ = None  # resampled ramp: no inverse-warp occlusion model
    else:
        if not (args.left and args.right and args.gt):
            p.error("need left right gt (or --synthetic)")
        from stereomatching_tpu_torch.data.formats import read_ground_truth

        left = read_png_gray(args.left)
        right = read_png_gray(args.right)
        gt = read_ground_truth(args.gt, scale=args.gt_scale).astype(np.float64)
        occ = None

    if args.noise > 0 or args.gain != 1.0 or args.bias != 0.0:
        from stereomatching_tpu_torch.utils.synthetic import photometric_perturb

        left, right = photometric_perturb(
            left, right, noise_sigma=args.noise, gain=args.gain,
            bias=args.bias, seed=1,
        )

    params = ModernParams(
        num_disparities=args.disparities, window=args.window,
        scales=args.scales, cost=args.cost, aggregation=args.aggregation,
        sgm_directions=args.sgm_directions, fill_mode=args.fill_mode,
        uniqueness=args.uniqueness_min is not None,
    )
    fn = ModernPipeline(params)
    lt, rt = (torch.from_numpy(x.astype(np.int32)).to(device) for x in (left, right))
    out = artifacts_to_numpy(fn(lt, rt))

    valid = np.array(out["valid"])
    if args.uniqueness_min is not None:
        valid &= np.asarray(out["uniqueness"]) >= args.uniqueness_min
    report = disparity_report(np.asarray(out["subpixel"]), gt, valid)
    report_filled = disparity_report(np.asarray(out["filled"]), gt)
    result = {
        "valid_pixels": report,
        "filled_all_pixels": report_filled,
        "params": {"disparities": args.disparities, "window": args.window,
                   "scales": args.scales, "cost": args.cost,
                   "aggregation": args.aggregation,
                   "sgm_directions": args.sgm_directions,
                   "fill_mode": args.fill_mode,
                   "uniqueness_min": args.uniqueness_min,
                   "noise": args.noise, "gain": args.gain,
                   "bias": args.bias},
    }
    if occ is not None and occ.any():
        # Occlusion dimension: score only truly-corresponding pixels,
        # and report how many truly occluded pixels the LR check (plus
        # any uniqueness gate) correctly invalidated.
        result["nonoccluded_valid"] = disparity_report(
            np.asarray(out["subpixel"]), gt, valid & ~occ
        )
        result["occlusion"] = {
            "fraction": float(occ.mean()),
            "lr_recall": float((~valid)[occ].mean()),
        }
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
