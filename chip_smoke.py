#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereomatching_tpu_torch``) on one
NVIDIA GPU: builds the kernels from ``csrc/``, holds each against its
plain torch version on the card, drives the classic pipeline through
``Matcher`` at 1024x1024 with 64 shifts, and times kernel vs plain paths.

    python3 chip_smoke.py

Phases (one line each): device, build, K1 vs plain, K2 vs plain, the
slice, times.  Then a JSON line describing each kernel, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before ``ok`` is printed; so does a host without CUDA, and a copy of this
script without the package beside it.  Kernel comparisons are bitwise
(tolerance 0: every plane on the path is an integer).

No jax and no module of the JAX package is imported here.  Inputs are
made with numpy from ``SEED``: random pairs, and textured scenes whose
right image is the left one shifted by a known disparity per region, so
the slice's winner plane is also checked against that ground truth.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZE, SHIFTS, BATCH, SEED = 1024, 64, 8, 0


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def u8_to_brightness(x):
    import numpy as np

    return x.astype(np.float32) / np.float32(256.0)


def shifted_pair(rng, size: int, block: int, shifts: int):
    """A ``block``-pixel random texture as the left image; the right image
    is it shifted right by a disparity in [0, shifts) that is constant on
    each of 4x4 regions.  -> (left u8, right u8, disparity int)."""
    import numpy as np

    coarse = rng.integers(0, 256, (size // block + 1,) * 2, dtype=np.uint8)
    left = np.kron(coarse, np.ones((block, block), np.uint8))[:size, :size]
    q = size // 4
    disp = np.kron(rng.integers(0, shifts, (4, 4)), np.ones((q, q), np.int64))
    right = np.take_along_axis(left, (np.arange(size) - disp) % size, axis=1)
    return left, right, disp


def region_interiors(size: int, margin: int):
    """Mask of the pixels at least ``margin`` away from the border of each
    of ``shifted_pair``'s 4x4 regions."""
    import numpy as np

    q = size // 4
    m = np.zeros((size, size), bool)
    for i in range(4):
        for j in range(4):
            m[i * q + margin:(i + 1) * q - margin, j * q + margin:(j + 1) * q - margin] = True
    return m


def plain_artifacts(left, right, params):
    """The slice's artifact dict from the kernels' plain torch versions, on
    the inputs' device: the comparison the kernel path is held to."""
    from stereomatching_tpu_torch.ops.contour import contour_bands
    from stereomatching_tpu_torch.ops.fused import match_score_edges_reference
    from stereomatching_tpu_torch.ops.fused_diffusion import fill_web_holes_range_reference

    best, winner, edges_l, edges_r = match_score_edges_reference(left, right, params)
    web, min_e, max_e = fill_web_holes_range_reference(winner, params.times)
    return {
        "edges-1": edges_l, "edges-2": edges_r, "score_best": best, "web-1": winner,
        "web-2": web, "output-0": contour_bands(web, params.lines, min_e, max_e),
        "min_elevation": min_e, "max_elevation": max_e,
    }


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after one warmup,
    from CUDA events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    import numpy as np
    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    try:
        import stereomatching_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    pkg_dir = Path(stereomatching_tpu_torch.__file__).resolve().parent
    check(pkg_dir.parent == ROOT, f"port imported from {pkg_dir}, not {ROOT}")
    from stereomatching_tpu_torch import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.ops import fused, fused_diffusion
    from stereomatching_tpu_torch.serving import Matcher

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # Phase 2: build both kernels from the checkout's sources.
    t0 = time.perf_counter()
    fused._lib()
    fused_diffusion._lib()
    print(f"[2 build] match_score_edges.cu + fill_web_holes.cu built and "
          f"loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)

    def rand_u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    # Phase 3: K1 against its plain version at the bench shape, both modes.
    k1_err, winners, notes = 0, {}, []
    for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP):
        p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule="exact")
        lt = torch.from_numpy(u8_to_brightness(rand_u8(4, SIZE, SIZE))).to(dev)
        rt = torch.from_numpy(u8_to_brightness(rand_u8(4, SIZE, SIZE))).to(dev)
        got = fused.match_score_edges(lt, rt, p)
        ref = fused.match_score_edges_reference(lt, rt, p)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "winner", "edges_l", "edges_r"), got, ref):
            err = max_abs_diff(a, b)
            k1_err = max(k1_err, err)
            check(err == 0, f"K1 {mode.value} {name} differs from plain (max |d| {err})")
        winners[mode] = got[1]
        notes.append(f"{mode.value}: 4 planes equal")
    print(f"[3 K1] 4x{SIZE}x{SIZE}, D={SHIFTS}, sw=21: kernel == plain bitwise "
          f"({'; '.join(notes)}; max |d| {k1_err})", flush=True)

    # Phase 4: K2 against its plain version on K1's winner planes.
    k2_err = 0
    for mode, win in winners.items():
        got = fused_diffusion.fill_web_holes_range(win, 32)
        ref = fused_diffusion.fill_web_holes_range_reference(win, 32)
        torch.cuda.synchronize()
        for name, a, b in zip(("web", "min", "max"), got, ref):
            err = max_abs_diff(a, b)
            k2_err = max(k2_err, err)
            check(err == 0, f"K2 {mode.value} {name} differs from plain (max |d| {err})")
    print(f"[4 K2] 4x{SIZE}x{SIZE} winner planes, times=32: web, min, max == "
          f"plain bitwise in both modes (max |d| {k2_err})", flush=True)

    # Phase 5: the slice through Matcher, counted from zero.
    params = StereoParams(num_shifts=SHIFTS, mode=BoundaryMode.GHOST, edge_rule="exact")
    scenes = [shifted_pair(rng, SIZE, block, SHIFTS) for block in (2, 4, 2, 4, 8, 16)]
    scenes += [(rand_u8(SIZE, SIZE), rand_u8(SIZE, SIZE), None) for _ in range(2)]
    left_u8 = np.stack([a for a, _, _ in scenes])
    right_u8 = np.stack([b for _, b, _ in scenes])
    matcher = Matcher(params, device="cuda")
    fused.match_score_edges.launches = 0
    fused_diffusion.fill_web_holes_range.launches = 0
    arts = matcher(left_u8, right_u8)
    launches = {
        "match_score_edges": fused.match_score_edges.launches,
        "fill_web_holes_range": fused_diffusion.fill_web_holes_range.launches,
    }
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    lt = torch.from_numpy(u8_to_brightness(left_u8)).to(dev)
    rt = torch.from_numpy(u8_to_brightness(right_u8)).to(dev)
    plain = {k: v.cpu().numpy() for k, v in plain_artifacts(lt, rt, params).items()}
    check(sorted(arts) == sorted(plain), f"artifact keys {sorted(arts)} != {sorted(plain)}")
    for k in plain:
        check(arts[k].dtype == plain[k].dtype and np.array_equal(arts[k], plain[k]),
              f"slice artifact {k} differs from the plain pipeline")
    shape = (BATCH, SIZE, SIZE)
    for k in ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0"):
        check(arts[k].shape == shape and arts[k].dtype == np.int32, f"{k} shape/dtype")
    check(set(np.unique(arts["output-0"])) <= {0, 1}, "contour plane not binary")
    check(arts["web-1"].min() >= 1 and arts["web-1"].max() <= SHIFTS, "winner out of 1..D")
    check(np.array_equal(arts["min_elevation"], arts["web-2"].min(axis=(1, 2)))
          and np.array_equal(arts["max_elevation"], arts["web-2"].max(axis=(1, 2))),
          "min/max elevation disagree with web-2")
    # Ground truth: inside each region of the fine textures (blocks 2 and 4),
    # the winner is the region's disparity + 1 (winner = shift + 1).
    interior = region_interiors(SIZE, params.half + SHIFTS)
    recovered = []
    for i in range(4):
        hit = float((arts["web-1"][i] == scenes[i][2] + 1)[interior].mean())
        recovered.append(hit)
        check(hit >= 0.99, f"scene {i}: true disparity recovered on {hit:.4%} of interiors")
    print(f"[5 slice] Matcher(ghost, exact, D={SHIFTS}) on {BATCH}x{SIZE}x{SIZE} "
          f"(6 shifted textures, 2 random): {len(arts)} artifacts == plain "
          f"pipeline bitwise; true disparity on "
          f"{', '.join(f'{h:.4%}' for h in recovered)} of the region interiors "
          f"of the fine textures; kernel launches {launches}", flush=True)

    # Phase 6: times at the bench shape (ghost, 1024x1024, D=64, batch 8).
    kernels = ClassicPipeline(params)
    pipe_ms = cuda_time_ms(lambda: kernels(lt, rt), 5) / BATCH
    plain_pipe_ms = cuda_time_ms(lambda: plain_artifacts(lt, rt, params), 2) / BATCH
    t0 = time.perf_counter()
    for _ in range(3):
        matcher(left_u8, right_u8)
    matcher_ms = (time.perf_counter() - t0) * 1e3 / (3 * BATCH)
    win = torch.from_numpy(arts["web-1"]).to(dev)
    k1_ms = cuda_time_ms(lambda: fused.match_score_edges(lt, rt, params), 5)
    k1_plain_ms = cuda_time_ms(lambda: fused.match_score_edges_reference(lt, rt, params), 2)
    k2_ms = cuda_time_ms(lambda: fused_diffusion.fill_web_holes_range(win, params.times), 5)
    k2_plain_ms = cuda_time_ms(
        lambda: fused_diffusion.fill_web_holes_range_reference(win, params.times), 2)
    print(f"[6 times] {smi}: pipeline {pipe_ms:.4f} ms/pair with kernels, "
          f"{plain_pipe_ms:.4f} ms/pair plain ({1e3 / pipe_ms:.1f} vs "
          f"{1e3 / plain_pipe_ms:.1f} pairs/s; device-resident batch {BATCH}); "
          f"Matcher u8 in/numpy out {matcher_ms:.4f} ms/pair; "
          f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms; "
          f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms "
          f"(per batch of {BATCH})", flush=True)

    src = "stereomatching_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "match_score_edges", "route": "cuda",
         "source": src + "match_score_edges.cu",
         "replaces": "stereomatching_tpu/ops/fused.py:1044",
         "launches": launches["match_score_edges"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fill_web_holes_range", "route": "cuda",
         "source": src + "fill_web_holes.cu",
         "replaces": "stereomatching_tpu/ops/fused_diffusion.py:344",
         "launches": launches["fill_web_holes_range"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
