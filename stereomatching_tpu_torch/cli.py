"""Command-line entry point of the PyTorch port — the reference's
program surface:

    python -m stereomatching_tpu_torch.cli IMG1 IMG2 [threshold]
        [square_width] [times] [lines] [--mode wrap|ghost]
        [--tier cuda|cpu|sharded|oracle] ...

Positional arguments, flags, validation messages, artifact dumps and the
final timing line (``width = %d, height = %d, t1 = %f, t2 = %f, elapsed =
%f``, src/stereo.c:324; field 15 is what the reference's test/time.sh
extracts) are those of ``stereomatching_tpu/cli.py`` and so of the
reference CLI (src/stereo.c:335-392).

``--tier`` picks the device: ``cuda`` (the default) runs the pipelines on
the GPU through the port's CUDA kernels, ``cpu`` runs their plain torch
versions, ``sharded`` runs the sharded tier over every visible GPU (rows
split over as many shards as the image height and halo reach allow, the
JAX CLI's choice; one row shard on a one-GPU host), ``oracle`` runs the
classic pipeline through the numpy serial oracle (``oracle/``) on float64
brightness, on no device and without importing torch (the role of the
reference's serial ``stereomatch``; refused for ``--pipeline modern``).
``cuda`` and ``sharded`` on a host without a GPU are an error, never a
fallback.  A
config a kernel does not take (a square width above 255, a tile past the
card's shared memory, more than 256 disparities on the box or SGM route)
runs that stage as plain torch ops on the GPU, chosen before any launch,
and one ``note:`` line on stderr names the stage and the reason.
Both pipelines: classic (both boundary modes, both edge
rules, ``--collect``, ``--save-artifacts``, ``--resume``) and modern
(box or SGM, ``--scales 1|2``, census or SAD, 4 or 8 paths, median,
uniqueness, both fills).  ``--resume`` with ``--collect`` is refused: a
resumed run has no per-shift planes to dump.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu_torch.utils.imageio import (
    artifact_ppm_type,
    read_png_gray,
    to_brightness,
    write_ppm,
)


def _parse(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="stereomatch-torch",
        description="stereo matching / contour mapping pipeline (PyTorch + CUDA)",
    )
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("threshold", nargs="?", type=float, default=None)
    p.add_argument("square_width", nargs="?", type=int, default=None)
    p.add_argument("times", nargs="?", type=int, default=None)
    p.add_argument("lines", nargs="?", type=int, default=None)
    p.add_argument("--mode", choices=["wrap", "ghost"], default="wrap")
    p.add_argument(
        "--tier", choices=["cuda", "cpu", "sharded", "oracle"], default="cuda",
        help="cuda = the GPU with the CUDA kernels; cpu = their plain "
        "torch versions on the CPU; sharded = the sharded tier over every "
        "visible GPU; oracle = the numpy serial oracle (classic only)",
    )
    p.add_argument(
        "--pipeline",
        choices=["classic", "modern"],
        default="classic",
        help="classic = the reference's edge-matching contour pipeline; "
        "modern = SAD cost volume + LR consistency + sub-pixel refine "
        "(positional threshold is ignored; square_width maps to the SAD "
        "window, --shifts to num_disparities)",
    )
    p.add_argument("--scales", type=int, default=1, choices=[1, 2],
                   help="modern pipeline: multi-scale cost fusion levels")
    p.add_argument("--cost", choices=["sad", "census"], default="sad",
                   help="modern pipeline: matching cost")
    p.add_argument("--aggregation", choices=["box", "sgm"], default="box",
                   help="modern pipeline: windowed box sum or "
                        "Semi-Global Matching")
    p.add_argument("--sgm-directions", type=int, default=4, choices=[4, 8],
                   help="SGM path count: 4 (axes) or 8 (+diagonals)")
    p.add_argument("--fill-mode", choices=["diffusion", "background"],
                   default="diffusion",
                   help="modern pipeline: hole filling for LR-invalid "
                        "pixels (valid-aware Jacobi diffusion, or "
                        "scanline background extension)")
    p.add_argument("--uniqueness", action="store_true",
                   help="modern SGM: also emit the c2/c1 uniqueness "
                        "confidence plane")
    p.add_argument("--median", action="store_true",
                   help="modern pipeline: 3x3 median speckle filter")
    p.add_argument("--edge-rule", choices=["reference", "exact"], default="reference")
    p.add_argument("--shifts", type=int, default=None, help="number of disparities")
    p.add_argument("--outdir", default=".", help="artifact output directory")
    p.add_argument(
        "--save-artifacts",
        metavar="PATH",
        help="classic pipeline: also checkpoint every artifact (exact "
        "values + params) as one compressed .npz — the reference's "
        "phase dumps as restartable state (src/stereo.c:302-320)",
    )
    p.add_argument(
        "--resume",
        metavar="PATH",
        help="classic pipeline: skip matching and resume the finishing "
        "phases (diffusion, contour) from a --save-artifacts "
        "checkpoint's post-argmax web; bit-identical to the "
        "uninterrupted run (times/lines may differ from the saved run; "
        "upstream params must match)",
    )
    p.add_argument(
        "--no-writes",
        action="store_true",
        help="skip all image writes (the reference's -DNO_WRITES timing build)",
    )
    p.add_argument(
        "--collect",
        action="store_true",
        help="also dump per-shift matches/score_all/scores planes "
        "(the reference's DEBUG build dumps)",
    )
    return p.parse_args(argv)


def _build_params(args: argparse.Namespace) -> StereoParams:
    kw = {"mode": BoundaryMode(args.mode), "edge_rule": args.edge_rule}
    if args.threshold is not None:
        kw["threshold"] = args.threshold
    if args.square_width is not None:
        kw["square_width"] = args.square_width
    if args.times is not None:
        kw["times"] = args.times
    if args.lines is not None:
        kw["lines"] = args.lines
    if args.shifts is not None:
        kw["num_shifts"] = args.shifts
    return StereoParams(**kw)


def sharded_devices():
    """The devices ``--tier sharded`` shards over: every visible CUDA
    device.  Raises ``RuntimeError`` without a GPU (no fallback)."""
    import torch

    from stereomatching_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _row_mesh(devices, h: int, reach: int):
    """A (1, rows) mesh over the first ``rows`` devices: as many row
    shards as divide the height into shards of at least ``reach`` rows."""
    from stereomatching_tpu_torch.parallel import make_mesh

    rows = len(devices)
    while rows > 1 and (h % rows != 0 or h // rows < reach):
        rows -= 1
    return make_mesh(data=1, rows=rows, devices=devices[:rows])


def _run_sharded(left, right, params: StereoParams, devices):
    import torch

    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.parallel import build_sharded_pipeline

    mesh = _row_mesh(devices, left.shape[0], max(params.half, 1))
    lt, rt = (torch.from_numpy(x)[None] for x in (left, right))
    out = artifacts_to_numpy(build_sharded_pipeline(params, mesh)(lt, rt))
    return {k: v[0] for k, v in out.items()}


def _run_oracle(left, right, params: StereoParams, collect: bool):
    from stereomatching_tpu_torch.oracle import pipeline as oracle

    return oracle.run_pipeline(
        left.astype(np.float64), right.astype(np.float64), params, collect=collect
    )


def _run_classic(left, right, params: StereoParams, collect: bool, device):
    import torch

    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.models.classic import (
        build_classic_collect_pipeline,
        build_classic_pipeline,
    )

    fn = (build_classic_collect_pipeline(params) if collect
          else build_classic_pipeline(params))
    lt, rt = (torch.from_numpy(x).to(device) for x in (left, right))
    arts = artifacts_to_numpy(fn(lt, rt))
    if collect:
        for key in ("matches", "score_all", "scores"):
            planes = arts.pop(key)
            for i in range(planes.shape[0]):
                arts[f"{key}-{i}"] = planes[i]
    return arts


# StereoParams fields that determine the post-argmax winner web; a resume
# checkpoint is only valid for a run with the same values (times/lines
# shape only the finishing phases and MAY differ — that is the point).
_UPSTREAM_FIELDS = (
    "threshold", "square_width", "num_shifts", "mode", "edge_rule",
)


def _run_resume(path: str, params: StereoParams, device):
    """Resume the finishing phases from a --save-artifacts checkpoint
    (``device`` None: through the oracle's)."""
    from stereomatching_tpu_torch.utils.artifacts import load_artifacts

    ck = load_artifacts(path)
    if "web-1" not in ck:
        raise ValueError(f"{path}: not a classic checkpoint (no web-1)")
    if "params" in ck:
        saved = json.loads(str(ck["params"]))
        cur = json.loads(params.to_json())
        bad = [f for f in _UPSTREAM_FIELDS if saved.get(f) != cur[f]]
        if bad:
            raise ValueError(
                f"{path}: checkpoint params differ in {bad} — the saved "
                f"web is not valid for this run"
            )
    winner = np.asarray(ck["web-1"]).astype(np.int32)
    if device is None:
        from stereomatching_tpu_torch.oracle import pipeline as oracle

        web = oracle.fill_web_holes(winner, params.times)
        fin = {"web-2": web, "output-0": oracle.draw_contour(web, params.lines)[0]}
    else:
        import torch

        from stereomatching_tpu_torch.interop import artifacts_to_numpy
        from stereomatching_tpu_torch.models.classic import build_classic_finish_pipeline

        fin = artifacts_to_numpy(
            build_classic_finish_pipeline(params)(torch.from_numpy(winner).to(device)))
        fin.pop("min_elevation", None)
        fin.pop("max_elevation", None)
    arts = {
        k: np.asarray(v)
        for k, v in ck.items()
        if k in ("edges-1", "edges-2", "score_best", "web-1")
    }
    arts.update(fin)
    return arts


def _dump(arts: Dict[str, np.ndarray], outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    for name, data in arts.items():
        if name in ("min_elevation", "max_elevation"):
            continue
        # The reference suffixes score_best with -0 (src/stereo.c:314).
        fname = "score_best-0" if name == "score_best" else name
        write_ppm(
            os.path.join(outdir, f"{fname}.ppm"),
            np.asarray(data),
            artifact_ppm_type(fname),
        )


def _run_modern(args, img1, img2, device, devices=None) -> Dict[str, np.ndarray]:
    import torch

    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.models.modern import build_modern_pipeline
    from stereomatching_tpu_torch.parallel import build_sharded_modern_pipeline

    kw = {"scales": args.scales, "cost": args.cost,
          "aggregation": args.aggregation, "median_filter": args.median,
          "sgm_directions": args.sgm_directions,
          "fill_mode": args.fill_mode, "uniqueness": args.uniqueness}
    if args.shifts is not None:
        kw["num_disparities"] = args.shifts
    if args.square_width is not None:
        kw["window"] = args.square_width
    params = ModernParams(**kw)
    from stereomatching_tpu_torch.models.modern import plain_stages

    _note_plain_stages(plain_stages(params), args.tier)
    if devices is not None:
        reach = params.window // 2 + (params.census_window // 2 if params.cost == "census" else 0)
        mesh = _row_mesh(devices, img1.shape[0], max(reach, 1))
        lt, rt = (torch.from_numpy(x.astype(np.int32))[None] for x in (img1, img2))
        out = artifacts_to_numpy(build_sharded_modern_pipeline(params, mesh)(lt, rt))
        return {k: v[0] for k, v in out.items()}
    fn = build_modern_pipeline(params)
    lt, rt = (torch.from_numpy(x.astype(np.int32)).to(device) for x in (img1, img2))
    return artifacts_to_numpy(fn(lt, rt))


def _dump_modern(out: Dict[str, np.ndarray], outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    np.savez_compressed(
        os.path.join(outdir, "disparity.npz"),
        **{k: np.asarray(v) for k, v in out.items()},
    )
    write_ppm(
        os.path.join(outdir, "disparity.ppm"),
        np.asarray(out["disparity"]),
        artifact_ppm_type("web-1"),  # GRAY_INT normalization
    )
    write_ppm(
        os.path.join(outdir, "valid.ppm"),
        np.asarray(out["valid"]).astype(np.int64) ^ 1,  # invalid -> black
        artifact_ppm_type("output-0"),
    )


def _note_plain_stages(stages: Dict[str, str], tier: str) -> None:
    """One ``note:`` line on stderr naming the stages that run as plain
    torch ops on the GPU for this config, and why (nothing on the CPU
    tier, where every stage is plain)."""
    if stages and tier != "cpu":
        print(f"note: plain torch on the GPU for {'; '.join(stages.values())}",
              file=sys.stderr)


def _timing_line(shape, t1: float, t2: float) -> None:
    h, w = shape
    print(
        f"width = {w}, height = {h}, t1 = {t1:f}, t2 = {t2:f}, "
        f"elapsed = {t2 - t1:f}"
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])

    try:
        img1 = read_png_gray(args.image1)
        img2 = read_png_gray(args.image2)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if img1.shape != img2.shape:
        # Same message as the reference (src/stereo.c:350).
        print(
            "error: the two images must have equal width and height",
            file=sys.stderr,
        )
        return 1
    if args.tier == "sharded" and args.collect:
        print(
            "error: --collect is not available on --tier sharded (the sharded "
            "tier has no per-shift planes to dump)",
            file=sys.stderr,
        )
        return 1
    if args.resume and args.collect:
        print(
            "error: --collect cannot be combined with --resume (a resumed "
            "run skips matching, so it has no per-shift planes to dump)",
            file=sys.stderr,
        )
        return 1
    devices = device = None
    try:
        if args.tier == "sharded":
            devices = sharded_devices()
            device = devices[0]
        elif args.tier != "oracle":
            from stereomatching_tpu_torch.utils.device import resolve_device

            device = resolve_device(args.tier)
    except RuntimeError as e:
        print(f"error: --tier {args.tier}: {e}", file=sys.stderr)
        return 1

    if args.pipeline == "modern":
        if args.resume or args.save_artifacts:
            print(
                "error: --save-artifacts/--resume are classic-pipeline "
                "flags (the modern pipeline dumps disparity.npz)",
                file=sys.stderr,
            )
            return 1
        if args.tier == "oracle":
            # The JAX CLI's message (stereomatching_tpu/cli.py:337).
            print("error: --tier oracle is not available for --pipeline modern",
                  file=sys.stderr)
            return 1
        t1 = time.monotonic()
        try:
            out = _run_modern(args, img1, img2, device, devices)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not args.no_writes:
            _dump_modern(out, args.outdir)
        t2 = time.monotonic()
        _timing_line(img1.shape, t1, t2)
        return 0

    try:
        params = _build_params(args)
        params.validate_for_image(img1.shape[1], img1.shape[0])
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if not args.resume and args.tier != "oracle":
        from stereomatching_tpu_torch.models.classic import plain_stages

        _note_plain_stages(plain_stages(params, sharded=devices is not None), args.tier)
    dtype = np.float64 if args.tier == "oracle" else np.float32
    left = to_brightness(img1, dtype)
    right = to_brightness(img2, dtype)

    # Timing mirrors the reference: excludes image load, includes artifact
    # writes unless --no-writes (src/stereo.c:297-324, Makefile:23).
    t1 = time.monotonic()
    try:
        if args.resume:
            arts = _run_resume(args.resume, params, device)
        elif devices is not None:
            arts = _run_sharded(left, right, params, devices)
        else:
            if args.tier == "oracle":
                arts = _run_oracle(left, right, params, args.collect)
            else:
                arts = _run_classic(left, right, params, args.collect, device)
            if args.save_artifacts:
                from stereomatching_tpu_torch.utils.artifacts import save_artifacts

                save_artifacts(
                    args.save_artifacts,
                    {**arts, "params": np.asarray(params.to_json())},
                )
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.no_writes:
        _dump(arts, args.outdir)
    t2 = time.monotonic()
    _timing_line(img1.shape, t1, t2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
