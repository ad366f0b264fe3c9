#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereomatching_tpu_torch``) on one
NVIDIA GPU: builds the kernels of the eight ``csrc/`` sources, holds each
against its plain torch version on the card, drives the classic pipeline through
``Matcher`` (exact and reference edge rules) and the CLI, and the modern
pipeline's three routes through ``ModernMatcher`` (4-path SGM, the box
default, the 8-direction quality stack) and ``scales=2`` through the CLI,
at 1024x1024 with 64 shifts / disparities, and times kernel vs plain
paths.

    python3 chip_smoke.py

Phases (one line each): device, build, K1 vs plain, K2 vs plain, the
classic slice, classic times, K3-K6 vs plain, the SGM slice, SGM times,
K7 vs plain, K4's diagonals vs plain, the box slice, the 8-direction
slice, box and 8-direction times, K8 vs plain, K1's sub-pixel plane vs
plain, the reference-rule classic slice, the CLI (classic and modern
``scales=2``), reference-rule and ``scales=2`` times; then the sharded
tier on meshes whose shards all live on ``cuda:0``: K9 vs plain on the
shard blocks, K4's seeded chain vs plain and vs the unsharded launch, the
sharded classic slice (``Matcher(mesh=...)``), the sharded modern slices
(SGM, 8 directions, box), the CLI's ``--tier sharded``, sharded times;
the routes chosen before launch for configs past a kernel's limits
(square width 301, D 320), equal to the CPU route; K4 pass by pass
(each direction, walk and write mode at the bench shape, with its bytes
and their floor at 3.35 TB/s, and the byte floor of the 4- and 8-path
sums: a ``{"k4_passes": ...}`` line); the shared-memory instruction
counts of K1's and of K8's and K9's kernels, which run one shift loop,
and K4's global loads, stores, REDUX, SHFL and instructions per loop in
SASS (``k1_sass``, ``k8_sass``, ``k4_sass`` lines);
K7's shared-memory loads and stores, barriers, shuffles and instructions
per loop in the SASS of its SAD kernels at D=64, with every K7 kernel's
registers (``k7_sass``); K5's segment kernels and K2's fused kernel
(``k5_sass``, ``k2_sass``); K6's fused kernel and K3's staged int8 census
kernels, K3's per element (``k6_sass``, ``k3_sass``); and K7's time over
its sweep of windows, D and costs beside each instance's bound
(``k7_instances``).
Then a JSON line describing each kernel (launches on its slice, error
against its plain version, times, the card's bound for the same work),
the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before ``ok`` is printed; so does a host without CUDA, and a copy of this
script without the package beside it.  Kernel comparisons are bitwise
(tolerance 0 on every plane, the float sub-pixel, filled and uniqueness
planes included).

No jax and no module of the JAX package is imported here.  Inputs are
made with numpy from ``SEED``: random pairs, and textured scenes whose
right image is the left one shifted by a known disparity per region, so
each slice's disparity plane is also checked against that ground truth.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZE, SHIFTS, BATCH, SEED = 1024, 64, 8, 0
SGM_BENCH_BATCH = 32  # bench.py's SGM line runs batch 32
# The share of the fine textures' region interiors on which the SGM slice
# must find the true disparity.  The scenes are fixed by SEED and the
# route is exact, so every run reads the same shares: 99.9882% on the
# worst of the four on an H100, floored here.
SGM_TRUTH_SHARE = 0.9998
# The same for the box route (SAD, window 9; the margin widened by the
# window's half) and the 8-direction quality stack: 100.0000% on all four
# and 99.9935% on the worst of the four on an H100, floored here.
BOX_TRUTH_SHARE = 0.9999
SGM8_TRUTH_SHARE = 0.9999


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs_diff(a, b) -> float:
    """Largest |a - b| (0.0 only where every element is equal; float
    planes are also compared bit for bit by ``same``)."""
    if a.is_floating_point() or b.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


def same(a, b) -> bool:
    """Equal dtype, shape and bits."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def u8_to_brightness(x):
    import numpy as np

    return x.astype(np.float32) / np.float32(256.0)


def shifted_pair(rng, size: int, block: int, shifts: int, sign: int = -1):
    """A ``block``-pixel random texture as the left image; the right image
    is it shifted by a disparity in [0, shifts) that is constant on each
    of 4x4 regions: right(x) = left(x - disp) for ``sign`` -1 (the classic
    pipeline's pairing, left x against right x + s), right(x) =
    left(x + disp) for +1 (SGM's, left x against right x - d).
    -> (left u8, right u8, disparity int)."""
    import numpy as np

    coarse = rng.integers(0, 256, (size // block + 1,) * 2, dtype=np.uint8)
    left = np.kron(coarse, np.ones((block, block), np.uint8))[:size, :size]
    q = size // 4
    disp = np.kron(rng.integers(0, shifts, (4, 4)), np.ones((q, q), np.int64))
    right = np.take_along_axis(left, (np.arange(size) + sign * disp) % size, axis=1)
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
    """The classic slice's artifact dict from the kernels' plain torch
    versions, on the inputs' device: the comparison the kernel path is
    held to (either edge rule)."""
    from stereomatching_tpu_torch.ops.argmax import match_and_score
    from stereomatching_tpu_torch.ops.contour import contour_bands
    from stereomatching_tpu_torch.ops.edges import find_edges
    from stereomatching_tpu_torch.ops.fused import match_score_edges_reference
    from stereomatching_tpu_torch.ops.fused_diffusion import fill_web_holes_range_reference

    if params.edge_rule == "exact":
        best, winner, edges_l, edges_r = match_score_edges_reference(left, right, params)
    else:
        edges_l, edges_r = (find_edges(x, params.threshold, params.mode, "reference")
                            for x in (left, right))
        best, winner = match_and_score(edges_l, edges_r, params)
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
    from stereomatching_tpu_torch import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.models import classic, modern
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.ops import (
        costvolume, fused, fused_diffusion, fused_modern, fused_sgm, sgm)
    from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
    from stereomatching_tpu_torch.utils.bench import (
        HBM_BYTES_PER_S, INT32_OPS_PER_S, K2_BENCH_KERNELS, K3_BENCH_KERNELS, K5_BENCH_KERNELS,
        K7_BENCH_KERNELS, K7_SWEEP, bound, k1_bound_ms,
        k2_bound_ms, k3_bound_ms, k5_bound_ms, k6_bound_ms, k6_filled, k7_bound_ms,
        k8_bound_ms, k9_bound_ms)
    from stereomatching_tpu_torch.utils.build import build_all

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # Phase 2: build all eight kernels from the checkout's sources, one nvcc
    # per source, all started together.
    t0 = time.perf_counter()
    sources = ["match_score_edges", "fill_web_holes", "sgm_volume", "sgm_directional",
               "sgm_tail", "fill_invalid", "disparity", "match_and_score"]
    build_all(sources)
    fused._lib("match_score_edges")
    fused._lib("match_and_score")
    fused_diffusion._lib("fill_web_holes")
    fused_diffusion._lib("fill_invalid")
    for name in ("sgm_volume", "sgm_directional", "sgm_tail"):
        fused_sgm._lib(name)
    fused_modern._lib()
    print(f"[2 build] {', '.join(s + '.cu' for s in sources)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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

    # Phase 4: K2 against its plain version on K1's winner planes: with
    # the pipeline's bound (byte cells), with none (int32 cells, a resumed
    # web's route), and at times 100 (chained launches).
    k2_err, notes = 0, []
    for mode, win in winners.items():
        for times, vb in ((32, SHIFTS + 1), (32, None), (100, SHIFTS + 1)):
            got = fused_diffusion.fill_web_holes_range(win, times, vb)
            ref = fused_diffusion.fill_web_holes_range_reference(win, times)
            torch.cuda.synchronize()
            for name, a, b in zip(("web", "min", "max"), got, ref):
                err = max_abs_diff(a, b)
                k2_err = max(k2_err, err)
                check(err == 0, f"K2 {mode.value} times {times} value_bound {vb} {name} "
                      f"differs from plain (max |d| {err})")
            plan = fused_diffusion.k2_plan(times, vb)
            if mode == BoundaryMode.GHOST:
                notes.append(f"times {times} value_bound {vb}: {plan.storage_bytes}-byte cells, "
                             f"{plan.launches} launch(es)")
    print(f"[4 K2] 4x{SIZE}x{SIZE} winner planes ({'; '.join(notes)}): web, min, max == "
          f"plain bitwise in both modes (max |d| {k2_err})", flush=True)
    del winners

    # Phase 5: the classic slice through Matcher, counted from zero.
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

    # Phase 6: classic times at the bench shape (ghost, 1024x1024, D=64, batch 8).
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
    k2_ms = cuda_time_ms(lambda: fused_diffusion.fill_web_holes_range(
        win, params.times, classic.winner_bound(params)), 5)
    k2_plain_ms = cuda_time_ms(
        lambda: fused_diffusion.fill_web_holes_range_reference(win, params.times), 2)
    print(f"[6 times] {smi}: pipeline {pipe_ms:.4f} ms/pair with kernels, "
          f"{plain_pipe_ms:.4f} ms/pair plain ({1e3 / pipe_ms:.1f} vs "
          f"{1e3 / plain_pipe_ms:.1f} pairs/s; device-resident batch {BATCH}); "
          f"Matcher u8 in/numpy out {matcher_ms:.4f} ms/pair; "
          f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms; "
          f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms "
          f"(per batch of {BATCH})", flush=True)
    npix = BATCH * SIZE * SIZE
    # K1: ``k1_bound_ms`` (the shift loop's count, as K8).  K2:
    # ``k2_bound_ms`` (one int32 plane in and out, 5 int ops per cell and
    # step).
    k1_bound = k1_bound_ms(npix, SHIFTS)
    k2_bound = k2_bound_ms(npix, params.times)
    del kernels, lt, rt, win, arts, plain, matcher

    # Phase 7: K3-K6 against their plain versions at 4x1024x1024, D=64:
    # census (int8) and SAD (int16) volumes, both through the four paths
    # into int16, the tail with the uniqueness pass, and the fill on the
    # tail's sub-pixel plane and LR mask.  Tolerance 0 on every plane.
    errs = {"sgm_volume": 0, "sgm_directional": 0, "sgm_tail": 0, "fill_invalid": 0}

    def hold(name, got, ref, what):
        check(same(got, ref), f"{name} {what} differs from plain "
              f"(max |d| {max_abs_diff(got, ref)})")
        errs[name] = max(errs[name], max_abs_diff(got, ref))

    notes = []
    for cost, vdtype in (("census", torch.int8), ("sad", torch.int16)):
        pix = [torch.from_numpy(rand_u8(4, SIZE, SIZE)).to(dev).to(torch.int32)
               for _ in range(2)]
        codes = [costvolume.census_transform(x) for x in pix] if cost == "census" else pix
        vol = fused_sgm.sgm_volume(*codes, SHIFTS, cost, vdtype)
        hold("sgm_volume", vol, fused_sgm.sgm_volume_reference(*codes, SHIFTS, cost, vdtype),
             f"{cost} volume")
        for along_y, reverse in sgm.PATHS:
            agg = torch.empty(vol.shape, dtype=torch.int16, device=dev)
            fused_sgm.sgm_directional(vol, agg, 8, 96, along_y, reverse, accumulate=False)
            hold("sgm_directional", agg.to(torch.int32),
                 fused_sgm.sgm_directional_reference(vol, 8, 96, along_y, reverse),
                 f"{cost} path (along_y={along_y}, reverse={reverse})")
        agg = fused_sgm.sgm_aggregate_paths(vol, 8, 96, torch.int16)
        hold("sgm_directional", agg, sgm.sgm_aggregate(vol, 8, 96).to(torch.int16),
             f"{cost} 4-path sum")
        del vol
        # K5 on k5_route's route (the segments here) and on the other
        # (wide), with and without the second best.
        check(fused_sgm.k5_route(agg.shape, agg.dtype) == "segments",
              f"K5 route {fused_sgm.k5_route(agg.shape, agg.dtype)} at the bench shape")
        for uniq in (False, True):
            tail_ref = fused_sgm.sgm_tail_reference(agg, uniq)
            for route, tail in (("segments", fused_sgm.sgm_tail(agg, uniq)),
                                ("wide", fused_sgm._tail_on_card(agg, uniq, "wide"))):
                for what, a, b in zip(("disparity", "subpixel", "cost", "disparity_right",
                                       "c2"), tail, tail_ref):
                    hold("sgm_tail", a, b, f"{cost} {route} uniqueness={uniq} {what}")
        tail = fused_sgm.sgm_tail(agg, True)
        valid = costvolume.lr_consistency(tail[0], tail[3], 1, SHIFTS)
        # K6 in one launch (16 sweeps) and chained (100 sweeps: 7 launches).
        for iters in (16, 100):
            hold("fill_invalid", fused_diffusion.fill_invalid(tail[1], valid, iters),
                 fused_diffusion.fill_invalid_reference(tail[1], valid, iters),
                 f"{cost} fill, {iters} sweeps")
        torch.cuda.synchronize()
        notes.append(f"{cost}: {str(vdtype).split('.')[-1]} volume, int16 aggregate, "
                     f"{float(valid.float().mean()):.2%} LR-valid")
        del agg, tail, tail_ref, valid, pix, codes
    # K3 on its other routes: D 37 at int8 and D 100 at int16 (vectors
    # that span pixels) and 2 x 64 x 1021 at D 37 int8 (rows of W * D bytes
    # that are not whole vectors: the element kernel), census codes over
    # all 32 bits.
    k3_routes = {}
    for shape, d, vdtype in (((4, SIZE, SIZE), 37, torch.int8), ((2, 64, 1021), 37, torch.int8),
                             ((2, 64, SIZE), 100, torch.int16)):
        codes = [torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                  .astype(np.int32)).to(dev) for _ in range(2)]
        route = fused_sgm.k3_route((*shape, d), vdtype)
        hold("sgm_volume", fused_sgm.sgm_volume(*codes, d, "census", vdtype),
             fused_sgm.sgm_volume_reference(*codes, d, "census", vdtype),
             f"census volume {shape} D {d} ({route})")
        k3_routes[f"{'x'.join(map(str, shape))} D {d} {str(vdtype).split('.')[-1]}"] = route
    del codes
    notes.append(f"K3 routes {k3_routes}")
    print(f"[7 K3-K6] 4x{SIZE}x{SIZE}, D={SHIFTS}: volume, each path and the 4-path "
          f"sum, tail on both routes with and without the second best, fill at 16 and "
          f"100 sweeps == plain bitwise ({'; '.join(notes)}; "
          f"max |d| {errs})", flush=True)

    # Phase 8: the SGM slice through ModernMatcher (bench.py's SGM params:
    # census, 4 paths, D=64), counted from zero.
    mparams = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census",
                           sgm_directions=4)
    scenes = [shifted_pair(rng, SIZE, block, SHIFTS, sign=1) for block in (2, 4, 2, 4, 8, 16)]
    scenes += [(rand_u8(SIZE, SIZE), rand_u8(SIZE, SIZE), None) for _ in range(2)]
    left_u8 = np.stack([a for a, _, _ in scenes])
    right_u8 = np.stack([b for _, b, _ in scenes])
    mmatcher = ModernMatcher(mparams, device="cuda")
    sgm_wrappers = {"sgm_volume": fused_sgm.sgm_volume,
                    "sgm_directional": fused_sgm.sgm_directional,
                    "sgm_tail": fused_sgm.sgm_tail,
                    "fill_invalid": fused_diffusion.fill_invalid}
    for fn in sgm_wrappers.values():
        fn.launches = 0
    out = mmatcher(left_u8, right_u8)
    launches.update({name: fn.launches for name, fn in sgm_wrappers.items()})
    for name in sgm_wrappers:
        check(launches[name] > 0, f"the SGM path never launched {name}")
    check(launches["fill_invalid"] == fused_diffusion.k6_plan(mparams.fill_iterations).launches,
          f"K6 launches {launches['fill_invalid']} on the SGM slice")
    lt = torch.from_numpy(left_u8).to(dev).to(torch.int32)
    rt = torch.from_numpy(right_u8).to(dev).to(torch.int32)
    plain = {k: v.cpu() for k, v in modern.modern_forward_reference(lt, rt, mparams).items()}
    keys = ["disparity", "subpixel", "disparity_right", "valid", "filled", "cost"]
    check(sorted(out) == sorted(keys), f"SGM output keys {sorted(out)}")
    for k in keys:
        check(same(torch.from_numpy(out[k]), plain[k]),
              f"SGM slice plane {k} differs from the plain pipeline")
        check(out[k].shape == (BATCH, SIZE, SIZE), f"SGM {k} shape {out[k].shape}")
    check(out["disparity"].min() >= 0 and out["disparity"].max() < SHIFTS,
          "SGM disparity out of 0..D-1")
    check(np.isfinite(out["subpixel"]).all() and np.isfinite(out["filled"]).all(),
          "non-finite SGM float plane")
    check(np.array_equal(out["filled"][out["valid"]], out["subpixel"][out["valid"]]),
          "filled differs from subpixel on LR-valid pixels")
    interior = region_interiors(SIZE, SHIFTS)
    truth = []
    for i in range(4):
        hit = float((out["disparity"][i] == scenes[i][2])[interior].mean())
        truth.append(hit)
        check(hit >= SGM_TRUTH_SHARE,
              f"SGM scene {i}: true disparity on {hit:.4%} of interiors")
    print(f"[8 SGM slice] ModernMatcher(census, 4 paths, D={SHIFTS}) on "
          f"{BATCH}x{SIZE}x{SIZE} (6 shifted textures, 2 random): {len(out)} planes "
          f"== plain pipeline bitwise; true disparity on "
          f"{', '.join(f'{h:.4%}' for h in truth)} of the region interiors of the "
          f"fine textures; LR-valid {float(out['valid'].mean()):.2%}; kernel launches "
          f"{ {k: launches[k] for k in sgm_wrappers} }", flush=True)
    del plain, out

    # Phase 9: SGM times.  Kernels at the slice's shapes (batch 8); the
    # pipeline device-resident at bench.py's SGM batch 32 with the kernels
    # and at batch 8 plain; ModernMatcher at batch 8.
    codes = [costvolume.census_transform(x).contiguous() for x in (lt, rt)]
    st, odt = modern._sgm_storage_dtype(mparams), modern._sgm_out_dtype(mparams)
    vol = fused_sgm.sgm_volume(*codes, SHIFTS, "census", st)
    agg = fused_sgm.sgm_aggregate_paths(vol, 8, 96, odt)
    tail = fused_sgm.sgm_tail(agg)
    sub, valid = tail[1], costvolume.lr_consistency(tail[0], tail[3], 1, SHIFTS)
    # The two kernels redesigned last, on the route's own inputs (the
    # slice's census codes, its LR-valid plane), against their plain
    # versions before they are timed.
    hold("sgm_volume", vol, fused_sgm.sgm_volume_reference(*codes, SHIFTS, "census", st),
         "census volume of the SGM slice")
    hold("fill_invalid", fused_diffusion.fill_invalid(sub, valid, mparams.fill_iterations),
         fused_diffusion.fill_invalid_reference(sub, valid, mparams.fill_iterations),
         "fill of the SGM slice")
    k3_route_taken = fused_sgm.k3_route(vol.shape, st)
    k6_plan = fused_diffusion.k6_plan(mparams.fill_iterations)
    ms = {
        "sgm_volume": (cuda_time_ms(lambda: fused_sgm.sgm_volume(*codes, SHIFTS, "census", st), 5),
                       cuda_time_ms(lambda: fused_sgm.sgm_volume_reference(
                           *codes, SHIFTS, "census", st), 2)),
        "sgm_directional": (cuda_time_ms(lambda: fused_sgm.sgm_aggregate_paths(vol, 8, 96, odt), 3),
                            cuda_time_ms(lambda: sgm.sgm_aggregate(vol, 8, 96).to(odt), 1)),
        "sgm_tail": (cuda_time_ms(lambda: fused_sgm.sgm_tail(agg), 5),
                     cuda_time_ms(lambda: fused_sgm.sgm_tail_reference(agg), 2)),
        "fill_invalid": (cuda_time_ms(lambda: fused_diffusion.fill_invalid(sub, valid, 16), 5),
                         cuda_time_ms(lambda: fused_diffusion.fill_invalid_reference(
                             sub, valid, 16), 2)),
    }
    nvox = npix * SHIFTS
    # K3, K5, K6: ``k3_bound_ms``, ``k5_bound_ms``, ``k6_bound_ms``.  K4
    # (the 4 launches of one forward): the volume in, the int16 aggregate
    # out; ~9 int ops per element and path.
    vb, ab = torch.tensor([], dtype=st).element_size(), torch.tensor([], dtype=odt).element_size()
    bounds = {
        "sgm_volume": k3_bound_ms(npix, SHIFTS, vb, "census"),
        "sgm_directional": bound((vb + ab) * nvox, 4 * 9 * nvox, INT32_OPS_PER_S),
        "sgm_tail": k5_bound_ms(npix, SHIFTS, ab),
        "fill_invalid": k6_bound_ms(npix, k6_filled(valid, 16)),
    }
    # K5 with the second best (the 8-direction route's tail).
    k5u_ms = cuda_time_ms(lambda: fused_sgm.sgm_tail(agg, True), 5)
    k5u_bound = k5_bound_ms(npix, SHIFTS, ab, uniqueness=True)
    del vol, agg, tail, sub, valid, codes
    pipe = modern.ModernPipeline(mparams)
    sgm_plain_ms = cuda_time_ms(lambda: modern.modern_forward_reference(lt, rt, mparams), 1) / BATCH
    t0 = time.perf_counter()
    for _ in range(3):
        mmatcher(left_u8, right_u8)
    mmatcher_ms = (time.perf_counter() - t0) * 1e3 / (3 * BATCH)
    big = [torch.from_numpy(rand_u8(SGM_BENCH_BATCH, SIZE, SIZE)).to(dev).to(torch.int32)
           for _ in range(2)]
    torch.cuda.reset_peak_memory_stats(dev)
    sgm_ms = cuda_time_ms(lambda: pipe(*big), 3) / SGM_BENCH_BATCH
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[9 SGM times] {smi}: pipeline {sgm_ms:.4f} ms/pair with kernels "
          f"({1e3 / sgm_ms:.1f} pairs/s; device-resident batch {SGM_BENCH_BATCH}, peak "
          f"{peak:.2f} GiB), plain {sgm_plain_ms:.4f} ms/pair (batch {BATCH}); "
          f"ModernMatcher u8 in/numpy out {mmatcher_ms:.4f} ms/pair (batch {BATCH}); "
          + "; ".join(f"{k} {a:.4f} ms vs plain {b:.4f} ms (bound {bounds[k][0]:.4f})"
                      for k, (a, b) in ms.items())
          + f"; sgm_tail with the second best {k5u_ms:.4f} ms (bound {k5u_bound[0]:.4f})"
          + f" (per batch of {BATCH}); K3 route {k3_route_taken}; K6 plan {tuple(k6_plan)} "
          f"(bytes a staged cell, launches, sweeps a launch)", flush=True)

    del big, pipe

    # Phase 10: K7 against its plain version at 4x1024x1024, D=64: SAD with
    # window 9 and census with window 5, each for both reference views;
    # then on one pair SAD windows 31 and 101 (the warp strips, as the two
    # before), census window 9 at D=256 (the tiles, both views staged in
    # shared memory) and census window 101 (the tiles, read through L1).
    # Disparity, subpixel and cost bitwise.
    k7_err, notes = 0, []
    for cost, window, n, d in (("sad", 9, 4, SHIFTS), ("census", 5, 4, SHIFTS),
                               ("sad", 31, 1, SHIFTS), ("sad", 101, 1, SHIFTS),
                               ("census", 9, 1, 256), ("census", 101, 1, SHIFTS)):
        p = ModernParams(num_disparities=d, cost=cost, window=window)
        pix = [torch.from_numpy(rand_u8(n, SIZE, SIZE)).to(dev).to(torch.int32)
               for _ in range(2)]
        codes = [costvolume.census_transform(x).contiguous() for x in pix] if cost == "census" else pix
        for reference in ("left", "right"):
            got = fused_modern.disparity(*codes, p, reference)
            ref = fused_modern.disparity_reference(*codes, p, reference)
            torch.cuda.synchronize()
            for what, a, b in zip(("disparity", "subpixel", "cost"), got, ref):
                err = max_abs_diff(a, b)
                k7_err = max(k7_err, err)
                check(same(a, b), f"K7 {cost} window {window} {reference} {what} differs "
                      f"from plain (max |d| {err})")
        notes.append(f"{cost} window {window} D {d} x{n} ({fused_modern.route(p)})")
    del pix, codes, got, ref
    print(f"[10 K7] {SIZE}x{SIZE}, both reference views: disparity, subpixel, "
          f"cost == plain bitwise ({'; '.join(notes)}; max |d| {k7_err})", flush=True)

    # Phase 11: K4's four diagonal paths and the 8-path sum against their
    # plain versions at 4x1024x1024, D=64, census (int8) and SAD (int16)
    # volumes into an int16 aggregate.
    notes = []
    for cost, vdtype in (("census", torch.int8), ("sad", torch.int16)):
        pix = [torch.from_numpy(rand_u8(4, SIZE, SIZE)).to(dev).to(torch.int32)
               for _ in range(2)]
        codes = [costvolume.census_transform(x) for x in pix] if cost == "census" else pix
        vol = fused_sgm.sgm_volume(*codes, SHIFTS, cost, vdtype)
        for direction, reverse in sgm.DIAG_PATHS:
            agg = torch.empty(vol.shape, dtype=torch.int16, device=dev)
            fused_sgm.sgm_directional(vol, agg, 8, 96, direction, reverse, accumulate=False)
            hold("sgm_directional", agg.to(torch.int32),
                 fused_sgm.sgm_directional_reference(vol, 8, 96, direction, reverse),
                 f"{cost} diagonal path (direction={direction}, reverse={reverse})")
        agg = fused_sgm.sgm_aggregate_paths(vol, 8, 96, torch.int16, directions=8)
        hold("sgm_directional", agg, sgm.sgm_aggregate(vol, 8, 96, directions=8).to(torch.int16),
             f"{cost} 8-path sum")
        torch.cuda.synchronize()
        notes.append(f"{cost}: {str(vdtype).split('.')[-1]} volume")
        del vol, agg, pix, codes
    print(f"[11 K4 diagonals] 4x{SIZE}x{SIZE}, D={SHIFTS}: each diagonal path and the 8-path "
          f"sum == plain bitwise ({'; '.join(notes)}; int16 aggregate; max |d| "
          f"{errs['sgm_directional']})", flush=True)

    # Phases 12 and 13: the box route (ModernMatcher's default params) and
    # the 8-direction quality stack through ModernMatcher on the SGM slice's
    # batch (6 shifted textures, 2 random), every counter set to 0 before
    # each and read after it.
    all_wrappers = {"disparity": fused_modern.disparity, **sgm_wrappers}

    def drive(matcher, params, keys, truth_floor, margin, label):
        for fn in all_wrappers.values():
            fn.launches = 0
        out = matcher(left_u8, right_u8)
        counts = {name: fn.launches for name, fn in all_wrappers.items()}
        plain = {k: v.cpu() for k, v in modern.modern_forward_reference(lt, rt, params).items()}
        check(sorted(out) == sorted(keys), f"{label} output keys {sorted(out)}")
        for k in keys:
            check(same(torch.from_numpy(out[k]), plain[k]),
                  f"{label} plane {k} differs from the plain pipeline")
            check(out[k].shape == (BATCH, SIZE, SIZE), f"{label} {k} shape {out[k].shape}")
        check(out["disparity"].min() >= 0 and out["disparity"].max() < SHIFTS,
              f"{label} disparity out of 0..D-1")
        check(all(np.isfinite(out[k]).all() for k in keys if out[k].dtype == np.float32),
              f"non-finite {label} float plane")
        check(np.array_equal(out["filled"][out["valid"]], out["subpixel"][out["valid"]]),
              f"{label}: filled differs from subpixel on LR-valid pixels")
        interior = region_interiors(SIZE, margin)
        truth = [float((out["disparity"][i] == scenes[i][2])[interior].mean()) for i in range(4)]
        for i, hit in enumerate(truth):
            check(hit >= truth_floor, f"{label} scene {i}: true disparity on {hit:.4%} of interiors")
        return out, counts, truth

    bparams = ModernParams(num_disparities=SHIFTS)
    bmatcher = ModernMatcher(device="cuda")
    check(bmatcher.params == bparams, f"ModernMatcher() params {bmatcher.params}")
    out, box_counts, truth = drive(bmatcher, bparams, keys, BOX_TRUTH_SHARE,
                                   SHIFTS + bparams.window // 2, "box slice")
    want = {"disparity": 2, "sgm_volume": 0, "sgm_directional": 0, "sgm_tail": 0,
            "fill_invalid": fused_diffusion.k6_plan(16).launches}
    check(box_counts == want, f"box slice kernel launches {box_counts}, want {want}")
    launches["disparity"] = box_counts["disparity"]
    print(f"[12 box slice] ModernMatcher() = (SAD, window 9, D={SHIFTS}, diffusion fill) on "
          f"{BATCH}x{SIZE}x{SIZE} (6 shifted textures, 2 random): {len(out)} planes == plain "
          f"pipeline bitwise; true disparity on {', '.join(f'{h:.4%}' for h in truth)} of the "
          f"region interiors of the fine textures; LR-valid {float(out['valid'].mean()):.2%}; "
          f"kernel launches {box_counts}", flush=True)

    qparams = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census",
                           sgm_directions=8, median_filter=True, uniqueness=True)
    qmatcher = ModernMatcher(qparams, device="cuda")
    out, q_counts, truth = drive(qmatcher, qparams, keys + ["uniqueness"], SGM8_TRUTH_SHARE,
                                 SHIFTS, "8-direction slice")
    want = {"disparity": 0, "sgm_volume": 1, "sgm_directional": 8, "sgm_tail": 1,
            "fill_invalid": fused_diffusion.k6_plan(16).launches}
    check(q_counts == want, f"8-direction slice kernel launches {q_counts}, want {want}")
    check((out["uniqueness"] >= 1.0).all(), "uniqueness below 1")
    print(f"[13 8-direction slice] ModernMatcher(census, 8 paths, median, uniqueness, "
          f"D={SHIFTS}) on {BATCH}x{SIZE}x{SIZE} (same batch): {len(out)} planes == plain "
          f"pipeline bitwise; true disparity on {', '.join(f'{h:.4%}' for h in truth)} of the "
          f"region interiors of the fine textures; LR-valid {float(out['valid'].mean()):.2%}; "
          f"kernel launches {q_counts}", flush=True)
    del out

    # Phase 14: box and 8-direction times.  K7 per launch (one reference
    # view of the batch of 8) and K4's 8-launch forward on the quality
    # stack's batch-8 volume, each against its plain version; the box
    # pipeline device-resident at batch 8 and 32, the 8-direction pipeline
    # at batch 32 with its peak memory, both plain at batch 8.
    k7_ms = cuda_time_ms(lambda: fused_modern.disparity(lt, rt, bparams, "left"), 5)
    k7_plain_ms = cuda_time_ms(lambda: fused_modern.disparity_reference(lt, rt, bparams, "left"), 1)
    codes = [costvolume.census_transform(x).contiguous() for x in (lt, rt)]
    qst, qodt = modern._sgm_storage_dtype(qparams), modern._sgm_out_dtype(qparams)
    vol = fused_sgm.sgm_volume(*codes, SHIFTS, "census", qst)
    k4_8_ms = cuda_time_ms(lambda: fused_sgm.sgm_aggregate_paths(vol, 8, 96, qodt, 8), 3)
    k4_8_plain_ms = cuda_time_ms(lambda: sgm.sgm_aggregate(vol, 8, 96, 8).to(qodt), 1)
    del vol, codes
    bpipe, qpipe = modern.ModernPipeline(bparams), modern.ModernPipeline(qparams)
    box8_ms = cuda_time_ms(lambda: bpipe(lt, rt), 5) / BATCH
    box_plain_ms = cuda_time_ms(lambda: modern.modern_forward_reference(lt, rt, bparams), 1) / BATCH
    sgm8_plain_ms = cuda_time_ms(
        lambda: modern.modern_forward_reference(lt, rt, qparams), 1) / BATCH
    big = [torch.from_numpy(rand_u8(SGM_BENCH_BATCH, SIZE, SIZE)).to(dev).to(torch.int32)
           for _ in range(2)]
    torch.cuda.reset_peak_memory_stats(dev)
    box32_ms = cuda_time_ms(lambda: bpipe(*big), 3) / SGM_BENCH_BATCH
    box_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    sgm8_ms = cuda_time_ms(lambda: qpipe(*big), 3) / SGM_BENCH_BATCH
    sgm8_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # K7 (one launch, one view of 8 pairs): ``k7_bound_ms``.  K4 x 8: the
    # int8 volume in, the int16 aggregate out; ~9 int ops per element and
    # path.
    k7_bound = k7_bound_ms("sad", npix, SHIFTS)
    qvb = torch.tensor([], dtype=qst).element_size()
    qab = torch.tensor([], dtype=qodt).element_size()
    k4_8_bound = bound((qvb + qab) * nvox, 8 * 9 * nvox, INT32_OPS_PER_S)
    print(f"[14 box and 8-direction times] {smi}: box pipeline {box8_ms:.4f} ms/pair with "
          f"kernels at batch {BATCH}, {box32_ms:.4f} at batch {SGM_BENCH_BATCH} "
          f"({1e3 / box32_ms:.1f} pairs/s, peak {box_peak:.2f} GiB), plain {box_plain_ms:.4f} "
          f"ms/pair (batch {BATCH}); 8-direction pipeline {sgm8_ms:.4f} ms/pair with kernels at "
          f"batch {SGM_BENCH_BATCH} ({1e3 / sgm8_ms:.1f} pairs/s, peak {sgm8_peak:.2f} GiB), plain "
          f"{sgm8_plain_ms:.4f} ms/pair (batch {BATCH}); disparity {k7_ms:.4f} ms vs plain "
          f"{k7_plain_ms:.4f} ms (bound {k7_bound[0]:.4f}, one view of {BATCH} pairs); "
          f"sgm_directional x 8 {k4_8_ms:.4f} ms vs plain {k4_8_plain_ms:.4f} ms (bound "
          f"{k4_8_bound[0]:.4f}, per batch of {BATCH})", flush=True)

    del big, bpipe, qpipe

    # Phase 15: K8 against its plain version at 8x1024x1024, D=64, sw=21 on
    # the reference rule's edge maps of the slice's pairs (six textures
    # shifted by a known disparity per region, whose edges are sparse and
    # match at the true shift, and two random pairs), both modes, with and
    # without the sub-pixel plane.  Bitwise.
    from stereomatching_tpu_torch.ops import argmax
    from stereomatching_tpu_torch.ops.edges import find_edges

    scenes = [shifted_pair(rng, SIZE, block, SHIFTS) for block in (2, 4, 2, 4, 8, 16)]
    scenes += [(rand_u8(SIZE, SIZE), rand_u8(SIZE, SIZE), None) for _ in range(2)]
    left_u8 = np.stack([a for a, _, _ in scenes])
    right_u8 = np.stack([b for _, b, _ in scenes])
    lt = torch.from_numpy(u8_to_brightness(left_u8)).to(dev)
    rt = torch.from_numpy(u8_to_brightness(right_u8)).to(dev)
    k8_err, notes = 0, []
    for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP):
        p = StereoParams(num_shifts=SHIFTS, mode=mode)
        el, er = (find_edges(x, p.threshold, mode, "reference") for x in (lt, rt))
        for sub in (False, True):
            got = fused.match_and_score(el, er, p, sub)
            ref = (argmax.match_and_score_subpixel if sub else argmax.match_and_score)(el, er, p)
            torch.cuda.synchronize()
            for name, a, b in zip(("best", "winner", "subpixel"), got, ref):
                err = max_abs_diff(a, b)
                k8_err = max(k8_err, err)
                check(same(a, b), f"K8 {mode.value} {name} (subpixel={sub}) differs from "
                      f"plain (max |d| {err})")
        density = el.float().mean(dim=(1, 2))
        notes.append(f"{mode.value}: edge density {float(density[:6].mean()):.2%} on the "
                     f"textures, {float(density[6:].mean()):.2%} on the random pairs")
    # sw 255 with D 300 (the wide window's row-sum word loop, and a right
    # bit row of 12 words) on a small random pair's reference-rule edge maps (two 128-row tiles, three
    # 128-column ones), both modes, with and without the sub-pixel plane.
    srng = np.random.default_rng(SEED + 15)
    small = [torch.from_numpy(u8_to_brightness(srng.integers(0, 256, (2, 200, 333),
                                                             dtype=np.uint8))).to(dev)
             for _ in range(2)]
    for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP):
        p = StereoParams(num_shifts=300, square_width=255, mode=mode)
        el, er = (find_edges(x, p.threshold, mode, "reference") for x in small)
        for sub in (False, True):
            got = fused.match_and_score(el, er, p, sub)
            ref = (argmax.match_and_score_subpixel if sub else argmax.match_and_score)(el, er, p)
            torch.cuda.synchronize()
            for name, a, b in zip(("best", "winner", "subpixel"), got, ref):
                err = max_abs_diff(a, b)
                k8_err = max(k8_err, err)
                check(same(a, b), f"K8 sw 255 D 300 {mode.value} {name} (subpixel={sub}) "
                      f"differs from plain (max |d| {err})")
    del el, er, got, ref
    print(f"[15 K8] {BATCH}x{SIZE}x{SIZE} reference-rule edge maps of the slice's pairs, "
          f"D={SHIFTS}, sw=21, and 2x200x333 random pairs' at D=300, sw=255: best, winner and "
          f"the sub-pixel plane == plain bitwise ({'; '.join(notes)}; max |d| {k8_err})",
          flush=True)

    # Phase 16: K1's sub-pixel plane against its plain version, both modes,
    # on the same pairs.
    k1s_err = 0
    for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP):
        p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule="exact")
        got = fused.match_score_edges(lt, rt, p, subpixel=True)
        ref = fused.match_score_edges_reference(lt, rt, p, subpixel=True)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "winner", "edges_l", "edges_r", "subpixel"), got, ref):
            err = max_abs_diff(a, b)
            k1s_err = max(k1s_err, err)
            check(same(a, b), f"K1 {mode.value} {name} with subpixel differs from plain "
                  f"(max |d| {err})")
    k1_err = max(k1_err, k1s_err)
    del got, ref
    print(f"[16 K1 sub-pixel] {BATCH}x{SIZE}x{SIZE}, D={SHIFTS}, sw=21: five planes == plain "
          f"bitwise in both modes (max |d| {k1s_err})", flush=True)

    # Phase 17: the reference-rule classic slice through Matcher (wrap mode,
    # the reference edge rule: the CLI's default run), counted from zero.
    rparams = StereoParams(num_shifts=SHIFTS)
    check(rparams.mode == BoundaryMode.WRAP and rparams.edge_rule == "reference",
          f"StereoParams defaults {rparams}")
    rmatcher = Matcher(rparams, device="cuda")
    classic_wrappers = {"match_score_edges": fused.match_score_edges,
                        "match_and_score": fused.match_and_score,
                        "fill_web_holes_range": fused_diffusion.fill_web_holes_range}
    for fn in classic_wrappers.values():
        fn.launches = 0
    arts = rmatcher(left_u8, right_u8)
    ref_counts = {name: fn.launches for name, fn in classic_wrappers.items()}
    want = {"match_score_edges": 0, "match_and_score": 1,
            "fill_web_holes_range": fused_diffusion.k2_plan(
                rparams.times, classic.winner_bound(rparams)).launches}
    check(ref_counts == want, f"reference-rule slice kernel launches {ref_counts}, want {want}")
    launches["match_and_score"] = ref_counts["match_and_score"]
    plain = {k: v.cpu().numpy() for k, v in plain_artifacts(lt, rt, rparams).items()}
    check(sorted(arts) == sorted(plain), f"artifact keys {sorted(arts)} != {sorted(plain)}")
    for k in plain:
        check(arts[k].dtype == plain[k].dtype and np.array_equal(arts[k], plain[k]),
              f"reference-rule slice artifact {k} differs from the plain pipeline")
    check(arts["web-1"].min() >= 1 and arts["web-1"].max() <= SHIFTS, "winner out of 1..D")
    interior = region_interiors(SIZE, rparams.half + SHIFTS)
    recovered = []
    for i in range(4):
        hit = float((arts["web-1"][i] == scenes[i][2] + 1)[interior].mean())
        recovered.append(hit)
        check(hit >= 0.99, f"reference-rule scene {i}: true disparity on {hit:.4%} of interiors")
    print(f"[17 reference-rule slice] Matcher(wrap, reference rule, D={SHIFTS}) on "
          f"{BATCH}x{SIZE}x{SIZE} (6 shifted textures, 2 random): {len(arts)} artifacts == "
          f"plain pipeline bitwise; true disparity on "
          f"{', '.join(f'{h:.4%}' for h in recovered)} of the region interiors of the fine "
          f"textures; kernel launches {ref_counts}", flush=True)

    # Phase 18: the CLI on the card, in a subprocess: the default classic run
    # (wrap, reference rule) on a shifted-texture pair written as PNGs, its
    # PPMs against the plain pipeline's rendering; then the modern pipeline's
    # SGM route at scales=2, its disparity.npz against the plain route.
    import tempfile

    from stereomatching_tpu_torch.utils.imageio import (
        artifact_ppm_type, ppm_bytes, write_png_gray)

    timing_re = re.compile(r"^width = 1024, height = 1024, t1 = [\d.]+, t2 = [\d.]+, "
                           r"elapsed = ([\d.]+)$")

    def run_cli(*args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "stereomatching_tpu_torch.cli", *args],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"CLI {args[2:]} exited {res.returncode}: {res.stderr[-2000:]}")
        line = res.stdout.strip().splitlines()[-1]
        m = timing_re.match(line)
        check(m is not None, f"CLI timing line {line!r}")
        return wall, float(m.group(1))

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        lpng, rpng = str(tmp / "L.png"), str(tmp / "R.png")
        write_png_gray(lpng, left_u8[0])
        write_png_gray(rpng, right_u8[0])
        cli_wall, cli_elapsed = run_cli(lpng, rpng, "--shifts", str(SHIFTS),
                                        "--outdir", str(tmp / "classic"))
        ppms = sorted(f.name for f in (tmp / "classic").iterdir())
        cli_ppms = {f: (tmp / "classic" / f).read_bytes() for f in ppms}
        want_ppms = {"edges-1", "edges-2", "score_best-0", "web-1", "web-2", "output-0"}
        check(ppms == sorted(f"{n}.ppm" for n in want_ppms), f"CLI wrote {ppms}")
        for name, v in plain.items():
            if name in ("min_elevation", "max_elevation"):
                continue
            fname = "score_best-0" if name == "score_best" else name
            check((tmp / "classic" / f"{fname}.ppm").read_bytes()
                  == ppm_bytes(v[0], artifact_ppm_type(fname)),
                  f"CLI {fname}.ppm differs from the plain pipeline's rendering")
        s2params = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census",
                                scales=2)
        cli2_wall, cli2_elapsed = run_cli(
            lpng, rpng, "--pipeline", "modern", "--aggregation", "sgm", "--cost", "census",
            "--scales", "2", "--shifts", str(SHIFTS), "--outdir", str(tmp / "modern"))
        want = modern.modern_forward_reference(
            *(torch.from_numpy(x[0]).to(dev).to(torch.int32) for x in (left_u8, right_u8)),
            s2params)
        with np.load(tmp / "modern" / "disparity.npz") as z:
            check(sorted(z.files) == sorted(want), f"disparity.npz keys {z.files}")
            for k, v in want.items():
                check(same(torch.from_numpy(z[k]), v.cpu()),
                      f"CLI scales=2 {k} differs from the plain route")
    print(f"[18 CLI] python -m stereomatching_tpu_torch.cli L.png R.png --shifts {SHIFTS} "
          f"(1024x1024, wrap, reference rule): rc 0, timing line, six PPMs == the plain "
          f"pipeline's rendering, {cli_wall:.3f} s wall ({cli_elapsed:.3f} s elapsed "
          f"field); --pipeline modern --aggregation sgm --cost census --scales 2: "
          f"disparity.npz == the plain route, {cli2_wall:.3f} s wall ({cli2_elapsed:.3f} s "
          f"elapsed field)", flush=True)

    # Phase 19: times.  K8 and K1 with the sub-pixel plane per batch of 8
    # (the slice's pairs), each against its plain version and beside K1
    # without it on the same inputs; the reference-rule pipeline
    # device-resident at batch 8 with the kernels and plain; the scales=2 SGM
    # pipeline at batch 8, its launches counted from zero.
    el, er = (find_edges(x, rparams.threshold, rparams.mode, "reference") for x in (lt, rt))
    k8_ms = cuda_time_ms(lambda: fused.match_and_score(el, er, rparams), 5)
    k8_plain_ms = cuda_time_ms(lambda: argmax.match_and_score(el, er, rparams), 2)
    k8s_ms = cuda_time_ms(lambda: fused.match_and_score(el, er, rparams, True), 5)
    xparams = StereoParams(num_shifts=SHIFTS, mode=BoundaryMode.GHOST, edge_rule="exact")
    k1_same_ms = cuda_time_ms(lambda: fused.match_score_edges(lt, rt, xparams), 5)
    k1s_ms = cuda_time_ms(lambda: fused.match_score_edges(lt, rt, xparams, True), 5)
    k1s_plain_ms = cuda_time_ms(
        lambda: fused.match_score_edges_reference(lt, rt, xparams, True), 2)
    edges_ms = cuda_time_ms(
        lambda: [find_edges(x, rparams.threshold, rparams.mode, "reference") for x in (lt, rt)], 5)
    rpipe = ClassicPipeline(rparams)
    ref_pipe_ms = cuda_time_ms(lambda: rpipe(lt, rt), 5) / BATCH
    ref_plain_ms = cuda_time_ms(lambda: plain_artifacts(lt, rt, rparams), 2) / BATCH
    del el, er
    pix = [torch.from_numpy(x).to(dev).to(torch.int32) for x in (left_u8, right_u8)]
    s2pipe = modern.ModernPipeline(s2params)
    for fn in all_wrappers.values():
        fn.launches = 0
    s2pipe(*pix)
    s2_counts = {name: fn.launches for name, fn in all_wrappers.items()}
    want = {"disparity": 0, "sgm_volume": 0, "sgm_directional": 4, "sgm_tail": 1,
            "fill_invalid": fused_diffusion.k6_plan(16).launches}
    check(s2_counts == want, f"scales=2 SGM kernel launches {s2_counts}, want {want}")
    s2_ms = cuda_time_ms(lambda: s2pipe(*pix), 3) / BATCH
    s2_plain_ms = cuda_time_ms(lambda: modern.modern_forward_reference(*pix, s2params), 1) / BATCH
    # K8 and K1 with the sub-pixel plane: ``k8_bound_ms``, ``k1_bound_ms``
    # (the shift loop's count, with the sub-pixel carries where taken).
    k8_bound = k8_bound_ms(npix, SHIFTS)
    k8s_bound = k8_bound_ms(npix, SHIFTS, subpixel=True)
    k1s_bound = k1_bound_ms(npix, SHIFTS, subpixel=True)
    print(f"[19 reference-rule and scales=2 times] {smi}: match_and_score {k8_ms:.4f} ms vs "
          f"plain {k8_plain_ms:.4f} ms (bound {k8_bound[0]:.4f}), with sub-pixel "
          f"{k8s_ms:.4f} ms (bound {k8s_bound[0]:.4f}); match_score_edges {k1_same_ms:.4f} ms, "
          f"with sub-pixel {k1s_ms:.4f} ms ({k1s_ms / k1_same_ms:.3f}x) vs plain "
          f"{k1s_plain_ms:.4f} ms (bound {k1s_bound[0]:.4f}); reference-rule edges (torch) "
          f"{edges_ms:.4f} ms (per batch of {BATCH}); reference-rule pipeline {ref_pipe_ms:.4f} "
          f"ms/pair with kernels, {ref_plain_ms:.4f} plain (batch {BATCH}); scales=2 SGM "
          f"(census, 4 paths) {s2_ms:.4f} ms/pair with kernels, {s2_plain_ms:.4f} plain "
          f"(batch {BATCH}; launches {s2_counts}); CLI {cli_wall:.3f} s wall (classic), "
          f"{cli2_wall:.3f} s (scales=2 SGM)", flush=True)

    # ------------------------------------------------ the sharded tier
    # Meshes whose shards all live on cuda:0: every shard of a block is
    # stacked, so each stage is one launch over all of them, and the halo
    # exchanges, the ghost masks, K9 on real halo blocks and the seeded K4
    # chain run on the card at full size.
    from stereomatching_tpu_torch.parallel import (
        build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh)
    from stereomatching_tpu_torch.parallel.mesh import run as run_blocks
    from stereomatching_tpu_torch.parallel.pipeline import prehalo_blocks, shard_extent

    def card_mesh(data, rows, cols=None):
        return make_mesh(data=data, rows=rows, cols=cols,
                         devices=[dev] * (data * rows * (cols or 1)))

    def k9_inputs(mesh, left, right, params):
        """K9's keyword arguments on the blocks the sharded classic
        slice gives it (one block: every shard on cuda:0)."""
        bl, hs, ws = shard_extent(tuple(left.shape), mesh)
        return run_blocks(mesh, bl, hs, ws, lambda sh: prehalo_blocks(
            sh, sh.scatter(left), sh.scatter(right), params)[2])[0]

    # Phase 20: K9 against its plain version on the shard blocks of a data
    # 2 x rows 4 mesh (batch 8: 32 blocks of 256 + 2 * 10 rows), both modes
    # and both edge rules, on the classic slice's pairs (shifted textures
    # and two random pairs), then a rows 2 x cols 2 mesh (pre-extended
    # blocks).  Bitwise.
    k9_err, notes = 0, []
    k9_cases = [((2, 4, None), mode, rule, 21, SHIFTS)
                for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)
                for rule in ("exact", "reference")]
    k9_cases += [((2, 2, 2), mode, "exact", 21, SHIFTS)
                 for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)]
    # sw 255 with D 300 (halos of 127 rows, a right bit row of 12 words) on
    # the data 2 x rows 2 blocks of a small pair (shards of 160 rows), and
    # on the data 2 x rows 2 x cols 2 blocks of a wider one, where the halo
    # rows meet the pre-extended blocks' column padding (a column shard
    # must hold the 127 + 300 columns of the right map's halo: 428 wide).
    k9_cases += [(shape, mode, "reference", 255, 300)
                 for shape in ((2, 2, None), (2, 2, 2))
                 for mode in (BoundaryMode.GHOST, BoundaryMode.WRAP)]
    small, wide = ([torch.from_numpy(u8_to_brightness(srng.integers(0, 256, (2, 320, w),
                                                                   dtype=np.uint8))).to(dev)
                    for _ in range(2)] for w in (333, 856))
    for shape, mode, rule, sw, d in k9_cases:
        p = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule=rule)
        pair = (lt, rt) if sw == 21 else wide if shape[2] else small
        kw = k9_inputs(card_mesh(*shape), *pair, p)
        got = fused.match_and_score_prehalo(params=p, **kw)
        ref = fused.match_and_score_prehalo_reference(params=p, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "winner"), got, ref):
            err = max_abs_diff(a, b)
            k9_err = max(k9_err, err)
            check(same(a, b), f"K9 {shape} {mode.value} {rule} sw {sw} D {d} {name} differs "
                  f"from plain (max |d| {err})")
        notes.append(f"{'x'.join(str(x) for x in shape if x)} {mode.value} {rule} sw {sw} "
                     f"D {d}: {tuple(kw['l_blk'].shape)}")
    del small, wide
    print(f"[20 K9] shard blocks of the classic slice's {BATCH}x{SIZE}x{SIZE} pairs (D={SHIFTS}, "
          f"sw=21) and of 2x320x333 and 2x320x856 random pairs (D=300, sw=255): best and "
          f"winner == plain bitwise ({'; '.join(notes)}; max |d| {k9_err})", flush=True)

    # Phase 21: K4's seeded chain at rows 4 (4 x 256-row shards) on a
    # census int8 volume of 4 random 1024x1024 pairs, D=64, into int16:
    # each shard's launch against the plain seeded pass (L and carry), and
    # the stitched chain against one unsharded launch, for the column
    # paths and both diagonal families, both walks.
    pix = [torch.from_numpy(rand_u8(4, SIZE, SIZE)).to(dev).to(torch.int32) for _ in range(2)]
    codes = [costvolume.census_transform(x).contiguous() for x in pix]
    vol = fused_sgm.sgm_volume(*codes, SHIFTS, "census", torch.int8)
    del pix, codes
    hs4 = SIZE // 4
    chain_err, n_seeded = 0, 0
    for direction in (sgm.Y, sgm.DIAG_PLUS, sgm.DIAG_MINUS):
        for reverse in (False, True):
            full = torch.empty(vol.shape, dtype=torch.int16, device=dev)
            fused_sgm.sgm_directional(vol, full, 8, 96, direction, reverse, accumulate=False)
            agg = torch.empty_like(full)
            seed = seed_ref = None
            for j in (reversed(range(4)) if reverse else range(4)):
                rows_j = slice(j * hs4, (j + 1) * hs4)
                part = vol[:, rows_j].contiguous()
                a, seed = fused_sgm.sgm_directional(
                    part, torch.empty(part.shape, dtype=torch.int16, device=dev), 8, 96,
                    direction, reverse, False, seed=seed, with_carry=True)
                n_seeded += 1
                ref, seed_ref = fused_sgm.sgm_directional_reference(
                    part, 8, 96, direction, reverse, seed=seed_ref, with_carry=True)
                for what, x, y in (("L", a.to(torch.int32), ref), ("carry", seed, seed_ref)):
                    err = max_abs_diff(x, y)
                    chain_err = max(chain_err, err)
                    check(same(x, y), f"seeded K4 direction {direction} reverse {reverse} "
                          f"shard {j} {what} differs from plain (max |d| {err})")
                agg[:, rows_j] = a
                del part, ref
            err = max_abs_diff(agg, full)
            chain_err = max(chain_err, err)
            check(same(agg, full), f"seeded K4 chain (direction {direction}, reverse {reverse}) "
                  f"differs from the unsharded launch (max |d| {err})")
            del full, agg
    torch.cuda.synchronize()
    errs["sgm_directional"] = max(errs["sgm_directional"], chain_err)
    print(f"[21 K4 seeded chain] 4x{SIZE}x{SIZE}, D={SHIFTS}, census int8 volume, int16 "
          f"aggregate, rows 4: {n_seeded} seeded launches (columns and both diagonal families, "
          f"both walks) == the plain seeded passes (L and carry) and, stitched, == the "
          f"unsharded launch bitwise (max |d| {chain_err})", flush=True)
    del vol

    # Phase 22: the sharded classic slice through Matcher(mesh=...), data 2
    # x rows 4 on cuda:0, batch 8 (the classic slice's pairs), ghost/exact
    # and wrap/reference; every artifact against the single-device
    # ClassicPipeline on the card, the counters set to 0 before each run.
    cl_left_u8, cl_right_u8 = left_u8, right_u8  # the classic pairs (phase 18's first)
    scenes_cli = (cl_left_u8[0], cl_right_u8[0])
    sharded_wrappers = {"match_and_score_prehalo": fused.match_and_score_prehalo,
                        "fill_web_holes_step": fused_diffusion.fill_web_holes_step,
                        **classic_wrappers}
    sh_counts, notes = {}, []
    for mode, rule in ((BoundaryMode.GHOST, "exact"), (BoundaryMode.WRAP, "reference")):
        p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule=rule)
        smatcher = Matcher(p, mesh=card_mesh(2, 4))
        for fn in sharded_wrappers.values():
            fn.launches = 0
        arts = smatcher(left_u8, right_u8)
        counts = {name: fn.launches for name, fn in sharded_wrappers.items()}
        want = {"match_and_score_prehalo": 1, "fill_web_holes_step": p.times - 1,
                "match_score_edges": 0, "match_and_score": 0, "fill_web_holes_range": 0}
        check(counts == want, f"sharded classic {mode.value} launches {counts}, want {want}")
        single = {k: v.cpu().numpy() for k, v in ClassicPipeline(p)(lt, rt).items()}
        check(sorted(arts) == sorted(single), f"sharded artifact keys {sorted(arts)}")
        for k in single:
            check(arts[k].dtype == single[k].dtype and np.array_equal(arts[k], single[k]),
                  f"sharded classic {mode.value} {k} differs from the single-device pipeline")
        hit = [float((arts["web-1"][i] == scenes[i][2] + 1)[region_interiors(
            SIZE, p.half + SHIFTS)].mean()) for i in range(4)]
        check(min(hit) >= 0.99, f"sharded classic true disparity on {hit}")
        sh_counts.setdefault("classic", counts)
        notes.append(f"{mode.value}/{rule}: true disparity on "
                     f"{', '.join(f'{h:.4%}' for h in hit)}")
    launches["match_and_score_prehalo"] = sh_counts["classic"]["match_and_score_prehalo"]
    print(f"[22 sharded classic slice] Matcher(mesh=make_mesh(data=2, rows=4, devices="
          f"['cuda:0'] * 8)) on {BATCH}x{SIZE}x{SIZE}: {len(arts)} artifacts == the "
          f"single-device ClassicPipeline bitwise ({'; '.join(notes)}); kernel launches "
          f"{sh_counts['classic']}", flush=True)
    del arts, single

    # Phase 23: the sharded modern slices through ModernMatcher(mesh=...) at
    # rows 4 on the SGM slice's batch: bench.py's SGM params, the
    # 8-direction quality stack, the box default; each against the
    # single-device ModernPipeline on the card, with the launch counters.
    scenes = [shifted_pair(rng, SIZE, block, SHIFTS, sign=1) for block in (2, 4, 2, 4, 8, 16)]
    scenes += [(rand_u8(SIZE, SIZE), rand_u8(SIZE, SIZE), None) for _ in range(2)]
    left_u8 = np.stack([a for a, _, _ in scenes])
    right_u8 = np.stack([b for _, b, _ in scenes])
    pix = [torch.from_numpy(x).to(dev).to(torch.int32) for x in (left_u8, right_u8)]
    modern_wrappers = {**all_wrappers, "fill_invalid_step": fused_diffusion.fill_invalid_step}
    mod_counts, notes = {}, []
    for label, p, floor, margin, want in (
        ("SGM", mparams, SGM_TRUTH_SHARE, SHIFTS,
         {"disparity": 0, "sgm_volume": 1, "sgm_directional": 2 + 2 * 4, "sgm_tail": 1,
          "fill_invalid": 0, "fill_invalid_step": 16}),
        ("8-direction", qparams, SGM8_TRUTH_SHARE, SHIFTS,
         {"disparity": 0, "sgm_volume": 1, "sgm_directional": 2 + 3 * 2 * 4, "sgm_tail": 1,
          "fill_invalid": 0, "fill_invalid_step": 16}),
        ("box", bparams, BOX_TRUTH_SHARE, SHIFTS + bparams.window // 2,
         {"disparity": 2, "sgm_volume": 0, "sgm_directional": 0, "sgm_tail": 0,
          "fill_invalid": 0, "fill_invalid_step": 16}),
    ):
        mm = ModernMatcher(p, mesh=card_mesh(1, 4))
        for fn in modern_wrappers.values():
            fn.launches = 0
        out = mm(left_u8, right_u8)
        counts = {name: fn.launches for name, fn in modern_wrappers.items()}
        check(counts == want, f"sharded {label} launches {counts}, want {want}")
        single = {k: v.cpu() for k, v in modern.ModernPipeline(p)(*pix).items()}
        check(sorted(out) == sorted(single), f"sharded {label} keys {sorted(out)}")
        for k, v in single.items():
            check(same(torch.from_numpy(out[k]), v),
                  f"sharded {label} plane {k} differs from the single-device pipeline")
        truth = [float((out["disparity"][i] == scenes[i][2])[region_interiors(SIZE, margin)]
                       .mean()) for i in range(4)]
        check(min(truth) >= floor, f"sharded {label}: true disparity on {truth}")
        mod_counts[label] = counts
        notes.append(f"{label}: {len(out)} planes, true disparity on "
                     f"{', '.join(f'{h:.4%}' for h in truth)}, launches {counts}")
    print(f"[23 sharded modern slices] ModernMatcher(mesh=make_mesh(data=1, rows=4, devices="
          f"['cuda:0'] * 4)) on {BATCH}x{SIZE}x{SIZE} (6 shifted textures, 2 random) == the "
          f"single-device ModernPipeline bitwise; {'; '.join(notes)}", flush=True)
    del out, single

    # Phase 24: the CLI's --tier sharded in a subprocess on the phase-18
    # pair (one GPU: one row shard): the default classic run's PPMs byte
    # for byte against phase 18's, the modern SGM run's disparity.npz
    # against the single-device pipeline.
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        write_png_gray(str(tmp / "L.png"), scenes_cli[0])
        write_png_gray(str(tmp / "R.png"), scenes_cli[1])
        lpng, rpng = str(tmp / "L.png"), str(tmp / "R.png")
        cli3_wall, _ = run_cli(lpng, rpng, "--shifts", str(SHIFTS), "--tier", "sharded",
                               "--outdir", str(tmp / "classic"))
        got_ppms = {f.name: f.read_bytes() for f in sorted((tmp / "classic").iterdir())}
        check(got_ppms == cli_ppms, "CLI --tier sharded PPMs differ from phase 18's")
        cli4_wall, _ = run_cli(lpng, rpng, "--pipeline", "modern", "--aggregation", "sgm",
                               "--cost", "census", "--shifts", str(SHIFTS), "--tier", "sharded",
                               "--outdir", str(tmp / "modern"))
        want = modern.ModernPipeline(mparams)(
            *(torch.from_numpy(x).to(dev).to(torch.int32) for x in scenes_cli))
        with np.load(tmp / "modern" / "disparity.npz") as z:
            check(sorted(z.files) == sorted(want), f"sharded disparity.npz keys {z.files}")
            for k, v in want.items():
                check(same(torch.from_numpy(z[k]), v.cpu()),
                      f"CLI --tier sharded modern {k} differs from the single-device pipeline")
    print(f"[24 CLI sharded] --tier sharded (1 visible GPU: rows 1): classic default run, six "
          f"PPMs == phase 18's byte for byte, {cli3_wall:.3f} s wall; --pipeline modern "
          f"--aggregation sgm --cost census: disparity.npz == the single-device pipeline, "
          f"{cli4_wall:.3f} s wall", flush=True)

    # Phase 25: sharded times (CUDA events).  K9 per batch of 8 (the data 2
    # x rows 4 ghost/exact blocks of the classic slice) against its plain
    # version; the seeded 4-path SGM route's K4 launches (2 horizontal over
    # the block + the rows-4 column chain) against the unsharded 4-path
    # forward on the same int8 volume; the sharded classic, SGM and
    # 8-direction pipelines per pair at batch 8 beside the single-device
    # ones on the same device-resident inputs.
    from stereomatching_tpu_torch.parallel.modern import _sgm_chain

    cl_lt = torch.from_numpy(u8_to_brightness(cl_left_u8)).to(dev)
    cl_rt = torch.from_numpy(u8_to_brightness(cl_right_u8)).to(dev)
    xp = StereoParams(num_shifts=SHIFTS, mode=BoundaryMode.GHOST, edge_rule="exact")
    mesh24 = card_mesh(2, 4)
    kw = k9_inputs(mesh24, cl_lt, cl_rt, xp)
    k9_ms = cuda_time_ms(lambda: fused.match_and_score_prehalo(params=xp, **kw), 5)
    k9_plain_ms = cuda_time_ms(lambda: fused.match_and_score_prehalo_reference(params=xp, **kw), 1)
    blk_px = kw["l_blk"].shape[0] * (kw["l_blk"].shape[1] - 2 * kw["halo"]) * SIZE
    halo_px = kw["l_blk"].shape[0] * 2 * xp.half * SIZE
    # K9: ``k9_bound_ms`` (both halo blocks in, best and winner out; the
    # shift loop's count per kept pixel, the match and row sum per cell of
    # the halo rows the windows reach).
    k9_bound = k9_bound_ms(kw["l_blk"].numel() + kw["r_blk"].numel(), blk_px, halo_px, SHIFTS)
    del kw
    codes = [costvolume.census_transform(x).contiguous() for x in pix]
    vol = fused_sgm.sgm_volume(*codes, SHIFTS, "census", torch.int8)
    del codes
    sgm_mesh = card_mesh(1, 4)
    blk_vol = vol.reshape(BATCH, 4, hs4, SIZE, SHIFTS).transpose(0, 1).contiguous().reshape(
        4 * BATCH, hs4, SIZE, SHIFTS)
    sh4 = run_blocks(sgm_mesh, BATCH, hs4, SIZE, lambda sh: sh)[0]

    def chain_4path():
        agg = torch.empty(blk_vol.shape, dtype=torch.int16, device=dev)
        fused_sgm.sgm_directional(blk_vol, agg, 8, 96, sgm.X, False, accumulate=False)
        fused_sgm.sgm_directional(blk_vol, agg, 8, 96, sgm.X, True, accumulate=True)
        _sgm_chain(sh4, blk_vol, agg, sgm.Y, 8, 96)
        return agg

    chain_ms = cuda_time_ms(chain_4path, 3)
    unsharded_ms = cuda_time_ms(lambda: fused_sgm.sgm_aggregate_paths(vol, 8, 96, torch.int16), 3)
    got = chain_4path().reshape(4, BATCH, hs4, SIZE, SHIFTS).transpose(0, 1).reshape(vol.shape)
    check(same(got, fused_sgm.sgm_aggregate_paths(vol, 8, 96, torch.int16)),
          "the sharded 4-path K4 route differs from the unsharded 4-path forward")
    del got, blk_vol, vol
    sc_pipe = build_sharded_pipeline(xp, mesh24)
    sc_ms = cuda_time_ms(lambda: sc_pipe(cl_lt, cl_rt), 3) / BATCH
    c_ms = cuda_time_ms(lambda: ClassicPipeline(xp)(cl_lt, cl_rt), 3) / BATCH
    ssgm, s8 = (build_sharded_modern_pipeline(p, sgm_mesh) for p in (mparams, qparams))
    ssgm_ms = cuda_time_ms(lambda: ssgm(*pix), 3) / BATCH
    sgm1_ms = cuda_time_ms(lambda: modern.ModernPipeline(mparams)(*pix), 3) / BATCH
    s8_ms = cuda_time_ms(lambda: s8(*pix), 3) / BATCH
    sgm8_1_ms = cuda_time_ms(lambda: modern.ModernPipeline(qparams)(*pix), 3) / BATCH
    print(f"[25 sharded times] {smi}: match_and_score_prehalo {k9_ms:.4f} ms vs plain "
          f"{k9_plain_ms:.4f} ms (bound {k9_bound[0]:.4f}, {k9_bound[1]}; per batch of {BATCH}, "
          f"data 2 x rows 4 blocks); sharded 4-path K4 route (2 horizontal + rows-4 seeded "
          f"column chain, {2 + 2 * 4} launches) {chain_ms:.4f} ms vs the unsharded 4-path "
          f"forward {unsharded_ms:.4f} ms ({chain_ms / unsharded_ms:.3f}x); sharded classic "
          f"(ghost, exact, data 2 x rows 4) {sc_ms:.4f} ms/pair vs single device {c_ms:.4f}; "
          f"sharded SGM (rows 4) {ssgm_ms:.4f} ms/pair vs {sgm1_ms:.4f}; sharded 8-direction "
          f"(rows 4) {s8_ms:.4f} ms/pair vs {sgm8_1_ms:.4f} (batch {BATCH}, device-resident)",
          flush=True)

    # Phase 26: the routes chosen before launch for configs past a kernel's
    # limits (square width 301 past K1's and K8's 255; D 320 past K7's and
    # K4's 256): the stage runs its plain version on the card, every other
    # kernel as usual, and the planes equal the CPU route's bit for bit, on
    # small pairs; then the box route at D 320 on a rows-2 mesh of cuda:0,
    # equal to the single-device route.
    f5_wrappers = {"match_score_edges": fused.match_score_edges,
                   "match_and_score": fused.match_and_score,
                   "match_and_score_prehalo": fused.match_and_score_prehalo,
                   "disparity": fused_modern.disparity,
                   "sgm_directional": fused_sgm.sgm_directional}
    f5_notes = []
    frng = np.random.default_rng(SEED + 26)
    fl_u8, fr_u8 = (frng.integers(0, 256, (320, 320), dtype=np.uint8) for _ in range(2))
    for rule in ("reference", "exact"):
        fp = StereoParams(num_shifts=8, square_width=301, edge_rule=rule, times=4)
        gm = Matcher(fp, device="cuda")
        check(gm.plain_stages == classic.plain_stages(fp) and len(gm.plain_stages) == 1,
              f"sw 301 {rule}: plain_stages {gm.plain_stages}")
        for fn in f5_wrappers.values():
            fn.launches = 0
        got = gm(fl_u8, fr_u8)
        check(all(fn.launches == 0 for fn in f5_wrappers.values()),
              f"sw 301 {rule}: a refused kernel launched")
        want = Matcher(fp, device="cpu")(fl_u8, fr_u8)
        for k in want:
            check(np.array_equal(got[k], want[k]), f"sw 301 {rule}: {k} differs from the CPU route")
        f5_notes.append(f"classic {rule} sw 301 ({list(gm.plain_stages)[0]} plain)")
    fl_u8, fr_u8 = (frng.integers(0, 256, (2, 40, 352), dtype=np.uint8) for _ in range(2))
    for agg in ("box", "sgm"):
        fp = ModernParams(num_disparities=320, aggregation=agg, cost="census")
        gm = ModernMatcher(fp, device="cuda")
        for fn in f5_wrappers.values():
            fn.launches = 0
        got = gm(fl_u8, fr_u8)
        check(all(fn.launches == 0 for fn in f5_wrappers.values()),
              f"D 320 {agg}: a refused kernel launched")
        want = ModernMatcher(fp, device="cpu")(fl_u8, fr_u8)
        for k in want:
            check(got[k].dtype == want[k].dtype
                  and np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)),
                  f"D 320 {agg}: {k} differs from the CPU route")
        f5_notes.append(f"{agg} D 320 ({list(gm.plain_stages)[0]} plain)")
    fp = ModernParams(num_disparities=320)
    got = ModernMatcher(fp, mesh=card_mesh(1, 2))(fl_u8, fr_u8)
    want = ModernMatcher(fp, device="cuda")(fl_u8, fr_u8)
    for k in want:
        check(np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)),
              f"sharded box D 320: {k} differs from the single-device route")
    f5_notes.append("sharded box D 320 on rows 2 == single device")
    print(f"[26 F5 routes] {'; '.join(f5_notes)}: planes == the CPU route bitwise, no "
          f"refused kernel launched", flush=True)

    # Phase 27: K4 pass by pass at the bench shape (census int8 volume of 8
    # random 1024x1024 pairs, D=64, int16 aggregate): each (direction,
    # reverse, accumulate) timed alone, beside the bytes it must move (the
    # volume in and the aggregate out, plus the aggregate in when it
    # accumulates) and that byte count's floor at 3.35 TB/s.
    pix = [torch.from_numpy(rand_u8(BATCH, SIZE, SIZE)).to(dev).to(torch.int32) for _ in range(2)]
    vol = fused_sgm.sgm_volume(*[costvolume.census_transform(x).contiguous() for x in pix],
                               SHIFTS, "census", torch.int8)
    agg = fused_sgm.sgm_aggregate_paths(vol, 8, 96, torch.int16)
    del pix
    k4_passes = []
    for direction, reverse in sgm.PATHS + sgm.DIAG_PATHS:
        for acc in (False, True):
            nbytes = (vol.element_size() + agg.element_size() * (2 if acc else 1)) * nvox
            pms = cuda_time_ms(lambda: fused_sgm.sgm_directional(
                vol, agg, 8, 96, direction, reverse, accumulate=acc), 5)
            k4_passes.append({"direction": direction, "reverse": reverse, "accumulate": acc,
                              "ms": pms, "bytes": nbytes, "GB_per_s": nbytes / pms / 1e6,
                              "floor_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    del vol, agg
    # The byte floor of one pass per path, 4 and 8 paths: the first pass
    # written, the rest added (k4_passes[2 i] is path i written, [2 i + 1]
    # added).
    k4_floors = {f"floor_ms_{n}path": k4_passes[0]["floor_ms"] + sum(
        k4_passes[2 * i + 1]["floor_ms"] for i in range(1, n)) for n in (4, 8)}
    print(f"[27 K4 passes] {smi}: 8x{SIZE}x{SIZE}, D={SHIFTS}, int8 volume, int16 aggregate: "
          + ", ".join(f"dir {p['direction']} rev {int(p['reverse'])} acc {int(p['accumulate'])} "
                      f"{p['ms']:.4f} ms ({p['GB_per_s']:.0f} GB/s, floor {p['floor_ms']:.4f})"
                      for p in k4_passes), flush=True)
    print(json.dumps({"k4_passes": k4_passes, **k4_floors}), flush=True)

    # The bit-row shift loop in SASS (K1's instances, then K8's and K9's):
    # shared-memory loads, stores and barriers in each kernel instance, in
    # total and per loop (cuobjdump -sass).  K4's
    # step loop: global loads and stores, REDUX, SHFL and all instructions
    # in the bench instances (int8 costs, int16 aggregate, 2 disparities per
    # lane), each loop's in address order, and their registers.
    from stereomatching_tpu_torch.utils.build import _target, resource_usage, sass_counts

    def kernel_name(name):
        return re.search(r"\w+_kernel(<[^>]*>)?", name).group(0)

    # K8's and K9's instances run K1's loop on staged edge maps.
    for key, target in (("k1_sass", "match_score_edges"), ("k8_sass", "match_and_score")):
        print(json.dumps({key: {kernel_name(name): {"total": c["total"], "loops": [
            {"start": a, "end": b, **cnt} for a, b, cnt in c["loops"]]}
            for name, c in sass_counts(_target(target)).items()}}), flush=True)
    k4_lib = _target("sgm_directional")
    k4_regs = [r["REG"] for m, r in resource_usage(k4_lib).items() if "IasLi2E" in m]
    k4_sass = {kernel_name(name): {"total": c["total"], "loops": [
        {"start": a, "end": b, **cnt} for a, b, cnt in c["loops"]]}
        for name, c in sass_counts(k4_lib, ("LDG", "STG", "LDGSTS", "REDUX", "SHFL", "ALL"),
                                   order=True).items()
        if "signed char, short, (int)2," in name}
    check(len(k4_sass) == len(k4_regs) > 0, f"K4's bench instances: {list(k4_sass)}, {k4_regs}")
    print(json.dumps({"k4_sass": k4_sass, "k4_registers": sorted(k4_regs)}), flush=True)

    # K7's SAD kernels at D=64 (the warp strips, ND 2, which the bench
    # instance runs, and the staged tiles): shared-memory loads and stores,
    # barriers, shuffles, REDUX and all instructions per loop, and every
    # kernel's registers.  The strips keep their one block barrier out of
    # every loop.
    k7_lib = _target("disparity")
    k7_sass = {kernel_name(name): {"total": c["total"], "loops": [
        {"start": a, "end": b, **cnt} for a, b, cnt in c["loops"]]}
        for name, c in sass_counts(k7_lib, ("LDS", "STS", "BAR", "SHFL", "REDUX", "ALL")).items()
        if K7_BENCH_KERNELS.search(name)}
    check(len(k7_sass) == 2, f"K7's bench kernels in SASS: {list(k7_sass)}")
    for name, c in k7_sass.items():
        if name.startswith("strips"):
            check(c["total"]["BAR"] == 1 and all(loop["BAR"] == 0 for loop in c["loops"]),
                  f"K7 strips: a block barrier inside a loop ({c})")
    k7_regs = {re.sub(r".*?(strips|disparity)_kernelI(\w+?)EE.*", r"\1 \2", m): r["REG"]
               for m, r in resource_usage(k7_lib).items()}
    print(json.dumps({"k7_sass": k7_sass, "k7_registers": k7_regs}), flush=True)

    # K5's segment kernels at the bench instance (int16, a pixel's run in
    # one word a lane) with and without the second best, and K2's fused
    # kernel on byte cells in one launch: shared loads and stores,
    # barriers, cp.async copies, REDUX and all instructions per loop, and
    # their registers.  K5 reads the aggregate in one pass: one block
    # barrier, after its copies, and no loop with a barrier.
    for key, target, kernels in (("k5_sass", "sgm_tail", K5_BENCH_KERNELS),
                                 ("k2_sass", "fill_web_holes", K2_BENCH_KERNELS)):
        lib = _target(target)
        counts = {kernel_name(name): {"total": c["total"], "loops": [
            {"start": a, "end": b, **cnt} for a, b, cnt in c["loops"]]}
            for name, c in sass_counts(lib, ("LDS", "STS", "BAR", "LDGSTS", "REDUX",
                                             "ALL")).items() if kernels.search(name)}
        regs = {m: r["REG"] for m, r in resource_usage(lib).items() if kernels.search(m)}
        check(len(counts) == (2 if key == "k5_sass" else 1) and len(regs) == len(counts),
              f"{key}: bench kernels in SASS {list(counts)}, registers {regs}")
        if key == "k5_sass":
            for name, c in counts.items():
                check(c["total"]["BAR"] == 1 and c["total"]["LDGSTS"] > 0
                      and all(loop["BAR"] == 0 for loop in c["loops"]),
                      f"K5 {name}: not one staged pass ({c['total']})")
        print(json.dumps({key: counts, key.replace("sass", "registers"): regs}), flush=True)

    # K6's fused kernel and K3's staged kernels at int8 census (the SGM
    # bench instance's pixels route and the vectors route): shared loads
    # and stores, global stores, population counts, MUFU (the reciprocal of
    # an integer division) and all instructions per kernel and loop, and
    # their registers; K3's per element in each loop with a store (its
    # STG count x 16 elements).  K3's pixel loop divides nothing, and its
    # vector loop at most once a vector.
    k6_lib = _target("fill_invalid")
    k6_sass = {kernel_name(name): {"total": c["total"], "loops": [
        {"start": a, "end": b, **cnt} for a, b, cnt in c["loops"]]}
        for name, c in sass_counts(k6_lib, ("LDS", "STS", "BAR", "LDG", "STG", "ALL")).items()
        if "fused_kernel" in name}
    k6_regs = {m: r["REG"] for m, r in resource_usage(k6_lib).items()}
    check(len(k6_sass) == 1, f"K6's fused kernel in SASS: {list(k6_sass)}")
    print(json.dumps({"k6_sass": k6_sass, "k6_registers": k6_regs}), flush=True)
    k3_lib = _target("sgm_volume")
    k3_sass = {}
    for name, c in sass_counts(k3_lib, ("LDS", "STS", "STG", "POPC", "MUFU", "ALL")).items():
        if not K3_BENCH_KERNELS.search(name):
            continue
        loops = [{"start": a, "end": b, **cnt,
                  "per_element": {op: cnt[op] / (16 * cnt["STG"]) for op in cnt} if cnt["STG"]
                  else None} for a, b, cnt in c["loops"]]
        k3_sass[kernel_name(name)] = {"total": c["total"], "loops": loops}
        for loop in loops:
            if loop["STG"]:
                most = 0 if "pixel_kernel" in name else loop["STG"]
                check(loop["MUFU"] <= most, f"K3 {name}: {loop['MUFU']} MUFU in a loop of "
                      f"{loop['STG']} vector stores")
    k3_regs = {m: r["REG"] for m, r in resource_usage(k3_lib).items()
               if K3_BENCH_KERNELS.search(m)}
    check(len(k3_sass) == 2 and all(any(loop["STG"] for loop in c["loops"])
                                    for c in k3_sass.values()),
          f"K3's staged int8 census kernels in SASS: {list(k3_sass)}")
    print(json.dumps({"k3_sass": k3_sass, "k3_registers": k3_regs}), flush=True)

    # K7 over the sweep of tools/profile_torch_pipeline.py (8 random
    # 1024x1024 pairs, the left view): each instance's kernel, time and
    # bound.  Census codes are those of the 5x5 transform (24 bits).
    pix = [torch.from_numpy(rand_u8(BATCH, SIZE, SIZE)).to(dev).to(torch.int32) for _ in range(2)]
    codes = [costvolume.census_transform(x).contiguous() for x in pix]
    k7_instances = []
    for cost, window, d in K7_SWEEP:
        p = ModernParams(num_disparities=d, cost=cost, window=window)
        a, b = codes if cost == "census" else pix
        kms = cuda_time_ms(lambda: fused_modern.disparity(a, b, p, "left"),
                           10 if window < 50 else 2)
        kb = k7_bound_ms(cost, npix, d)
        k7_instances.append({"cost": cost, "window": window, "D": d,
                             "route": fused_modern.route(p), "ms": kms,
                             "bound_ms": kb[0], "bound_by": kb[1]})
    del pix, codes
    print(json.dumps({"k7_instances": k7_instances, "card": smi}), flush=True)

    src = "stereomatching_tpu_torch/csrc/"
    rows = [
        ("match_score_edges", "match_score_edges.cu", "stereomatching_tpu/ops/fused.py:1044",
         k1_err, k1_ms, k1_plain_ms, k1_bound),
        ("fill_web_holes_range", "fill_web_holes.cu",
         "stereomatching_tpu/ops/fused_diffusion.py:344", k2_err, k2_ms, k2_plain_ms, k2_bound),
        ("sgm_volume", "sgm_volume.cu",
         "stereomatching_tpu/ops/fused_sgm.py:784, stereomatching_tpu/ops/fused_sgm.py:884",
         errs["sgm_volume"], *ms["sgm_volume"], bounds["sgm_volume"]),
        ("sgm_directional", "sgm_directional.cu", "stereomatching_tpu/ops/fused_sgm.py:337",
         errs["sgm_directional"], *ms["sgm_directional"], bounds["sgm_directional"]),
        ("sgm_tail", "sgm_tail.cu", "stereomatching_tpu/ops/fused_sgm.py:1065",
         errs["sgm_tail"], *ms["sgm_tail"], bounds["sgm_tail"]),
        ("fill_invalid", "fill_invalid.cu", "stereomatching_tpu/ops/fused_diffusion.py:286",
         errs["fill_invalid"], *ms["fill_invalid"], bounds["fill_invalid"]),
        ("disparity", "disparity.cu", "stereomatching_tpu/ops/fused_modern.py:232",
         k7_err, k7_ms, k7_plain_ms, k7_bound),
        ("match_and_score", "match_and_score.cu", "stereomatching_tpu/ops/fused.py:696",
         k8_err, k8_ms, k8_plain_ms, k8_bound),
        ("match_and_score_prehalo", "match_and_score.cu", "stereomatching_tpu/ops/fused.py:757",
         k9_err, k9_ms, k9_plain_ms, k9_bound),
    ]
    table = [
        {"name": name, "route": "cuda", "source": src + cu, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err, "ms": kms, "plain_ms": pms,
         "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        for name, cu, replaces, err, kms, pms, b in rows
    ]
    # The 4-path forward's numbers above; the 8-path forward's beside them.
    table[3].update({"launches_8dir": q_counts["sgm_directional"], "ms_8dir": k4_8_ms,
                     "plain_ms_8dir": k4_8_plain_ms, "bound_ms_8dir": k4_8_bound[0],
                     "bound_by_8dir": k4_8_bound[1]})
    # The sub-pixel variants of K1 and K8 (timed on the reference-rule
    # slice's batch; K1 beside its own time without the plane there).
    table[0].update({"ms_same_inputs": k1_same_ms, "ms_subpixel": k1s_ms,
                     "plain_ms_subpixel": k1s_plain_ms, "bound_ms_subpixel": k1s_bound[0],
                     "bound_by_subpixel": k1s_bound[1]})
    table[7].update({"ms_subpixel": k8s_ms, "bound_ms_subpixel": k8s_bound[0],
                     "bound_by_subpixel": k8s_bound[1]})
    # The sharded tier: K4's seeded launches on the sharded SGM and
    # 8-direction slices and the sharded 4-path route's time; the K2 and
    # K6 step kernels' launches on the sharded slices.
    table[3].update({"launches_sharded": mod_counts["SGM"]["sgm_directional"],
                     "launches_sharded_8dir": mod_counts["8-direction"]["sgm_directional"],
                     "ms_sharded_4path": chain_ms, "ms_unsharded_4path_same_inputs": unsharded_ms})
    table[1].update({"launches_sharded_step": sh_counts["classic"]["fill_web_holes_step"]})
    table[5].update({"launches_sharded_step": mod_counts["SGM"]["fill_invalid_step"]})
    # K5 with the second best (the 8-direction route's tail), and the
    # route the bench instance takes.
    table[4].update({"route_taken": "segments", "ms_uniqueness": k5u_ms,
                     "bound_ms_uniqueness": k5u_bound[0], "bound_by_uniqueness": k5u_bound[1]})
    # K3's route at the SGM slice's shapes.
    table[2].update({"route_taken": k3_route_taken})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
