#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereomatching_tpu_torch``) on one
NVIDIA GPU: builds the kernels of the eight ``csrc/`` CUDA sources and
the host codec (``csrc/stereo_io.cpp``), holds each kernel
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
(``k7_instances``).  Then the input and quality side: ``BatchLoader`` on
17 PNG pairs feeding the classic and SGM pipelines on the card, with its
decode + H2D pace beside the device's (a ``{"loader": ...}`` line), and
the host codec (``csrc/stereo_io.cpp``) on those pairs written again as
adaptive-filter PNGs: its decode bitwise the plain decoder's on every
image of both sets, the classic and SGM planes fed from the adaptive set
bitwise the matchers', and its decode, thread, loader, PPM-render and
PNG-write times beside the plain versions' (a ``{"codec": ...}`` line
with the host's CPU); the
numpy oracle against the card's classic artifacts, and the CLI's
``--tier oracle``; ``tools/eval_quality_torch.py`` on the card against
the CPU.  Then the measurement and cross-check side, in this process:
``python -m stereomatching_tpu_torch.bench`` at its defaults and the
roofline of the classic (batch 8) and SGM (batch 32) routes at 1024²,
every share of the bound at most 100% (a ``{"roofline": ...}`` line with
the card's name and power limit); ``tools/scaling_bench_torch.py`` at 1,
2 and 4 row shards stacked on ``cuda:0``; and ``tools/knife_edge_torch.py``'s
gate on the CLI's exact-rule dumps (K1, K2) against the oracle's
reference-rule ones, both modes.  Then phase 34, random routes: seeded
random shapes and params (seed ``RANDOM_ROUTES_SEED``, printed) drawn so
that every kernel takes every route it has, each held bitwise against its
plain version on the card, and random classic and modern configs (past a
kernel's limits among them) through the pipelines, and of the sharded tier
on meshes of the card (half of them fed block by block), against the CPU;
a route drawn zero times fails the run.  Then phase 35, the sharded tier
fed and read block by block (``parallel.Sharded``): the classic, SGM and
box slices fed global batches, batches placed by ``Sharded.from_global``
and ``BatchLoader(mesh=...)`` batches, every output block bitwise the
global-fed route's and every output after ``to_global`` the single
device's, with the ms/pair of the three routes (a ``{"sharded_io": ...}``
line); with several GPUs visible, the classic case over all of them.
Then phase 36, the sizes the JAX package runs: the classic pipeline at
7680x4320, batch 4, in both modes and rules, and K9 on its rows 4
blocks; ``tools/size_sweep_torch.py`` over its ladder, its 8K checksum
against the plain route's; box, SGM and the 8-direction stack at
1110x1390 x 256 disparities, batch 8 (an SGM volume past 2^31
elements), each image against the plain route; K1, K8 and K9 at D up to
1952; every kernel's time there beside its bound (a ``{"full_sizes":
...}`` line).  Then phase 37, K10 (the census of both views in one
launch) at 1110x1390, batch 8 and 1, bitwise its plain version, its time
beside the plain version's and its bound (a ``{"k10": ...}`` line).
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
# Phase 34 draws its random configurations from this seed.
RANDOM_ROUTES_SEED = SEED + 34


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


def bits(x):
    """A numpy plane with its float32 values as their int32 bit patterns
    (so that equality is bitwise, NaN included)."""
    import numpy as np

    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


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


# PNG filter types by number (PNG spec 9.2).
PNG_FILTERS = ("none", "sub", "up", "average", "paeth")


def adaptive_png(pixels, force=None):
    """uint8 [H, W] -> (8-bit grayscale PNG bytes as common encoders write
    them, rows per filter type): each row's filter type 0-4 is the one
    whose bytes, taken as signed, have the least sum of absolute values
    (libpng's adaptive heuristic), or ``force`` on every row; zlib level
    6, IDAT chunks of 8 KiB.  The package's writer keeps filter 0."""
    import struct
    import zlib

    import numpy as np

    h, w = pixels.shape
    x = pixels.astype(np.int16)
    up, left, upleft = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    up[1:] = x[:-1]
    left[:, 1:] = x[:, :-1]
    upleft[:, 1:] = up[:, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]) & 0xFF
    if force is None:
        kind = np.minimum(cands, 256 - cands).sum(axis=2, dtype=np.int64).argmin(axis=0)
    else:
        kind = np.full(h, force)
    raw = np.concatenate([kind[:, None], cands[kind, np.arange(h)]], axis=1).astype(np.uint8)
    comp = zlib.compress(raw.tobytes(), 6)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    out = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))]
    out += [chunk(b"IDAT", comp[i:i + 8192]) for i in range(0, len(comp), 8192)]
    out.append(chunk(b"IEND", b""))
    return b"".join(out), np.bincount(kind, minlength=5)


def host_cpu():
    """-> (the host's CPU from /proc/cpuinfo: its model name, else its
    vendor, family and model numbers; the CPUs this process may run on)."""
    import os

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break  # the first processor's block ends
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name")
    if model in (None, "", "unknown"):
        model = (f"{fields.get('vendor_id', 'unknown vendor')} family "
                 f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}")
    return model, len(os.sched_getaffinity(0))


def idat_stream(png: bytes) -> bytes:
    """The zlib stream of a PNG: its IDAT payloads in order."""
    import struct

    pos, parts = 8, []
    while pos + 8 <= len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            parts.append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    return b"".join(parts)


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
    from stereomatching_tpu_torch.models.classic import classic_forward_reference

    return classic_forward_reference(left, right, params)


def cuda_time_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after one warmup
    (none without ``warmup``), from CUDA events around the whole run."""
    import torch

    if warmup:
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


def load_tool(name: str):
    """The module of ``tools/<name>.py``, imported in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the gate's dataclass resolves through sys.modules
    spec.loader.exec_module(mod)
    return mod


def start_jobs(pool, jobs):
    """Start each ``{label: argv}`` job (``python argv...`` from the root of
    the checkout, one intra-op thread each, as several run at once) on a
    thread of ``pool`` -> {label: future of (CompletedProcess, wall s)}."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def one(argv):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True,
                             text=True, timeout=600, env=env)
        return res, time.perf_counter() - t0

    return {label: pool.submit(one, argv) for label, argv in jobs.items()}


def finished(futures):
    """-> {label: (stdout, wall s)} of ``start_jobs``' futures; fails on a
    non-zero exit."""
    out = {}
    for label, fut in futures.items():
        res, wall = fut.result()
        check(res.returncode == 0, f"{label} exited {res.returncode}: {res.stderr[-2000:]}")
        out[label] = (res.stdout, wall)
    return out


def input_and_quality_phases(dev, smi: str, cli_pair) -> None:
    """Phases 28-30: the loader feeding the classic and SGM pipelines (and
    the host codec on adaptive-filter PNGs), the
    numpy oracle against the card (and the CLI's ``--tier oracle``), and
    the quality tool on the card against the CPU, at 1024², D=64.
    ``cli_pair``: phase 18's (left, right) uint8 pair."""
    import multiprocessing
    import tempfile
    import zlib
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset
    from stereomatching_tpu_torch.data.formats import (
        read_ground_truth, write_disparity_png, write_pfm)
    from stereomatching_tpu_torch.interop import artifacts_to_numpy
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.models.modern import ModernPipeline
    from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_modern, fused_sgm
    from stereomatching_tpu_torch.oracle import pipeline as oracle
    from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
    from stereomatching_tpu_torch.utils import native
    from stereomatching_tpu_torch.utils.imageio import (
        ImageType, artifact_ppm_type, png_bytes_plain, png_read_gray_plain, ppm_bytes,
        ppm_bytes_plain, write_png_gray)
    from stereomatching_tpu_torch.utils.metrics import disparity_report
    from stereomatching_tpu_torch.utils.synthetic import blob_scene

    wrappers = {"match_score_edges": fused.match_score_edges,
                "match_and_score": fused.match_and_score,
                "fill_web_holes_range": fused_diffusion.fill_web_holes_range,
                "disparity": fused_modern.disparity,
                "sgm_volume": fused_sgm.sgm_volume,
                "sgm_directional": fused_sgm.sgm_directional,
                "sgm_tail": fused_sgm.sgm_tail,
                "fill_invalid": fused_diffusion.fill_invalid}

    def counted(fn):
        """-> (fn(), {wrapper: launches during it}), counted from zero."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return out, {k: w.launches for k, w in wrappers.items() if w.launches}

    params = StereoParams(num_shifts=SHIFTS, mode=BoundaryMode.GHOST, edge_rule="exact")
    mparams = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census",
                           sgm_directions=4)
    (ROOT / "build").mkdir(exist_ok=True)

    # Phase 28: the loader on the card.  17 shifted textures (blocks 2 and
    # 4; right(x) = left(x - d) and left(x + d) in turn, the classic and SGM
    # pairings) as PNGs in both layouts (<stem>_left/_right.png and a/b.png
    # directories); BatchLoader(batch 8, device cuda, drop_last False)
    # yields 8, 8 and 1 real pairs padded to 8, bitwise the numpy batches;
    # each batch through the classic pipeline (bench params) and the SGM
    # pipeline (bench.py's SGM params), every plane bitwise Matcher's /
    # ModernMatcher's on the same decoded pairs; the known shifts.
    prng = np.random.default_rng(SEED + 28)
    n_pairs = 17
    scenes = [shifted_pair(prng, SIZE, (2, 4)[i % 4 // 2], SHIFTS, sign=(-1, 1)[i % 2])
              for i in range(n_pairs)]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ThreadPoolExecutor(8) as pool:
        tmp = Path(tmp)
        index, writes = {}, []
        for i, (left, right, _) in enumerate(scenes):
            if i % 2:
                (tmp / f"s{i:02d}").mkdir()
                paths = (tmp / f"s{i:02d}" / "a.png", tmp / f"s{i:02d}" / "b.png")
            else:
                paths = (tmp / f"p{i:02d}_left.png", tmp / f"p{i:02d}_right.png")
            index[str(paths[0])] = i
            writes += [pool.submit(write_png_gray, str(paths[0]), left),
                       pool.submit(write_png_gray, str(paths[1]), right)]
        for w in writes:
            w.result()
        ds = StereoPairDataset.from_root(str(tmp))
        order = [index[a] for a, _ in ds.pairs]
        check(sorted(order) == list(range(n_pairs)), f"discovered {order}")
        host = list(BatchLoader(ds, batch_size=BATCH, device_put=False))
        loader = BatchLoader(ds, batch_size=BATCH)
        check(loader.device == torch.device("cuda"), f"loader device {loader.device}")
        t0 = time.perf_counter()
        batches = list(loader)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check([k for _, _, k in batches] == [8, 8, 1], f"kept {[k for _, _, k in batches]}")
        for (lb, rb, kept), (hl, hr, hk) in zip(batches, host):
            check(kept == hk, "kept differs from the numpy batches'")
            for a, b in ((lb, hl), (rb, hr)):
                check(a.device == dev and a.shape == (BATCH, SIZE, SIZE)
                      and same(a, torch.from_numpy(b).to(dev)),
                      "a loader batch differs from its numpy batch")
        # Timed alone: decode + H2D with the device idle (pool warm).
        t0 = time.perf_counter()
        for _ in loader:
            pass
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0

        left_u8 = np.stack([scenes[i][0] for i in order])
        right_u8 = np.stack([scenes[i][1] for i in order])
        pipe, mpipe = ClassicPipeline(params), ModernPipeline(mparams)

        def pixels(x):
            return (x * 256).to(torch.int32)

        arts = Matcher(params)(left_u8, right_u8)
        mout = ModernMatcher(mparams)(left_u8, right_u8)

        def hold_fed(tag, fed):
            """The classic and SGM pipelines on each of the loader's
            batches ``fed``, every plane bitwise the matchers' (padding
            the last pair's) -> the launches of each."""
            outs, c_counts = counted(lambda: [artifacts_to_numpy(pipe(lb, rb))
                                              for lb, rb, _ in fed])
            mouts, m_counts = counted(lambda: [artifacts_to_numpy(mpipe(pixels(lb), pixels(rb)))
                                               for lb, rb, _ in fed])
            check(set(c_counts) == {"match_score_edges", "fill_web_holes_range"},
                  f"{tag} classic launches {c_counts}")
            check(set(m_counts) == {"sgm_volume", "sgm_directional", "sgm_tail", "fill_invalid"},
                  f"{tag} SGM launches {m_counts}")
            for label, got, want in (("classic", outs, arts), ("SGM", mouts, mout)):
                for b, (_, _, kept) in enumerate(fed):
                    for k, v in want.items():
                        g, ref = bits(got[b][k]), bits(v[b * BATCH:b * BATCH + kept])
                        check(g.dtype == ref.dtype and np.array_equal(g[:kept], ref),
                              f"{tag} {label} batch {b} {k} differs from the matcher's")
                        check(all(np.array_equal(g[j], g[kept - 1]) for j in range(kept, BATCH)),
                              f"{tag} {label} batch {b} {k}: padding differs from the last pair")
            return c_counts, m_counts

        c_counts, m_counts = hold_fed("loader-fed", batches)
        interior = region_interiors(SIZE, params.half + SHIFTS)
        c_hits = [float((arts["web-1"][j] == scenes[i][2] + 1)[interior].mean())
                  for j, i in enumerate(order) if i % 2 == 0]
        check(min(c_hits) >= 0.99, f"loader-fed classic true disparity on {c_hits}")
        interior = region_interiors(SIZE, SHIFTS)
        s_hits = [float((mout["disparity"][j] == scenes[i][2])[interior].mean())
                  for j, i in enumerate(order) if i % 2]
        check(min(s_hits) >= SGM_TRUTH_SHARE, f"loader-fed SGM true disparity on {s_hits}")

        lb0, rb0, _ = batches[0]
        pl0, pr0 = pixels(lb0), pixels(rb0)
        dev_ms = {"classic": cuda_time_ms(lambda: pipe(lb0, rb0), 5) / BATCH,
                  "sgm": cuda_time_ms(lambda: mpipe(pl0, pr0), 3) / BATCH}
        del batches, pl0, pr0
        fed_ms = {}
        for label, run in (("classic", lambda lb, rb: pipe(lb, rb)),
                           ("sgm", lambda lb, rb: mpipe(pixels(lb), pixels(rb)))):
            t0 = time.perf_counter()
            for lb, rb, _ in loader:
                run(lb, rb)
            torch.cuda.synchronize()
            fed_ms[label] = (time.perf_counter() - t0) * 1e3 / n_pairs

        # Phase 28, the host codec (csrc/stereo_io.cpp): the same 17 pairs
        # written again as adaptive-filter PNGs (adaptive_png, as common
        # encoders write them) in the same layout; the codec's decode
        # bitwise the plain decoder's (one process per CPU) and the pixels
        # on every image of both sets; decode ms per 1 MP image, codec
        # against plain, on the first 2 adaptive pairs and on one image with
        # every row Average or Paeth; the codec's decode of the adaptive set
        # on 1-8 threads; the loader's decode + H2D on both sets in turns
        # (filter 0, adaptive, adaptive, filter 0); the classic and SGM
        # planes fed from the adaptive set == the matchers'; PPM render ms
        # per 1024² plane, codec against plain, bytes equal.
        adir = tmp / "adaptive"
        f0_files, ad_files, pix = [], [], []
        for a, b in ds.pairs:
            for path, px in zip((a, b), scenes[index[a]][:2]):
                f0_files.append(Path(path))
                ad_files.append(adir / Path(path).relative_to(tmp))
                pix.append(px)
        encoded = list(pool.map(adaptive_png, pix))
        for f, (data, _) in zip(ad_files, encoded):
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(data)
        filter_rows = sum(k for _, k in encoded)
        ads = StereoPairDataset.from_root(str(adir))
        check([Path(a).relative_to(adir) for a, _ in ads.pairs]
              == [Path(a).relative_to(tmp) for a, _ in ds.pairs],
              "the adaptive set's pairs differ from the filter-0 set's")
        blobs = {"filter 0": [f.read_bytes() for f in f0_files],
                 "adaptive": [data for data, _ in encoded]}
        cpu_model, n_cpus = host_cpu()
        with ProcessPoolExecutor(n_cpus, mp_context=multiprocessing.get_context("spawn")) as procs:
            plain_out = {k: procs.map(png_read_gray_plain, v) for k, v in blobs.items()}
            for k, v in blobs.items():
                for j, (got, want) in enumerate(zip(pool.map(native.png_read_gray, v),
                                                    plain_out[k])):
                    check(got.dtype == np.uint8 and np.array_equal(got, want)
                          and np.array_equal(got, pix[j]),
                          f"codec decode of {k} image {j} differs from the plain decoder's")

        def best_ms(fn, reps):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            return min(times) * 1e3

        for j in range(4):
            check(blobs["filter 0"][j] == png_bytes_plain(pix[j]),
                  f"codec PNG encode of image {j} differs from the plain writer's")
        write_ms = {"codec": best_ms(lambda: native.png_write_gray(pix[0]), 3),
                    "plain": best_ms(lambda: png_bytes_plain(pix[0]), 3)}
        timed = blobs["adaptive"][:4]
        decode_ms = {"codec": float(np.mean([best_ms(lambda: native.png_read_gray(d), 5)
                                             for d in timed])),
                     "plain": float(np.mean([best_ms(lambda: png_read_gray_plain(d), 1)
                                             for d in timed])),
                     "inflate": float(np.mean([best_ms(lambda: zlib.decompress(idat_stream(d)),
                                                       5) for d in timed])),
                     "filter_rows": dict(zip(PNG_FILTERS, map(int, sum(
                         k for _, k in encoded[:4]))))}
        forced_ms = {}
        for kind in (3, 4):
            data = adaptive_png(pix[0], force=kind)[0]
            check(np.array_equal(native.png_read_gray(data), pix[0]),
                  f"codec decode of every-row {PNG_FILTERS[kind]} differs from the pixels")
            forced_ms[PNG_FILTERS[kind]] = {
                "codec": best_ms(lambda: native.png_read_gray(data), 5),
                "plain": best_ms(lambda: png_read_gray_plain(data), 1)}
        threads_ms = {}
        for k in (1, 2, 4, 8):
            with ThreadPoolExecutor(k) as tp:
                t0 = time.perf_counter()
                list(tp.map(native.png_read_gray, blobs["adaptive"]))
                threads_ms[k] = (time.perf_counter() - t0) * 1e3 / len(blobs["adaptive"])

        aloader = BatchLoader(ads, batch_size=BATCH)
        abatches = list(aloader)
        a_counts = hold_fed("adaptive-fed", abatches)
        del abatches

        def pace(ld):
            t0 = time.perf_counter()
            for _ in ld:
                pass
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n_pairs

        paces = {"filter 0": [], "adaptive": []}
        for label, ld in (("filter 0", loader), ("adaptive", aloader), ("adaptive", aloader),
                          ("filter 0", loader)):
            paces[label].append(pace(ld))
        ppm_ms = {}
        for name, plane, imtype in (("gray_int", arts["web-1"][0], ImageType.GRAY_INT),
                                    ("binary", arts["edges-1"][0], ImageType.BINARY),
                                    ("gray_float", pix[0] / 256.0, ImageType.GRAY_FLOAT)):
            want = ppm_bytes_plain(plane, imtype)
            check(ppm_bytes(plane, imtype) == want,
                  f"codec PPM render ({name}) differs from the plain renderer's")
            ppm_ms[name] = {"codec": best_ms(lambda: ppm_bytes(plane, imtype), 5),
                            "plain": best_ms(lambda: ppm_bytes_plain(plane, imtype), 2),
                            "bytes": len(want)}
        del aloader
    loader_ms = loader_s * 1e3 / n_pairs
    print(f"[28 loader] BatchLoader(StereoPairDataset.from_root(<{n_pairs} PNG pairs, both "
          f"layouts>), batch_size={BATCH}) on {dev}: 3 batches (kept 8, 8, 1, padded by the "
          f"last pair) == the numpy batches bitwise; classic (ghost, exact, D={SHIFTS}) and "
          f"SGM (census, 4 paths) on each == Matcher / ModernMatcher bitwise; true disparity "
          f"on {', '.join(f'{h:.4%}' for h in c_hits)} (classic) and "
          f"{', '.join(f'{h:.4%}' for h in s_hits)} (SGM) of the region interiors; launches "
          f"{c_counts}, {m_counts}; {smi}: decode + H2D {loader_ms:.3f} ms/pair "
          f"({1e3 / loader_ms:.1f} pairs/s; first pass {first_s * 1e3 / n_pairs:.3f}), "
          f"device-resident classic {dev_ms['classic']:.4f} / SGM {dev_ms['sgm']:.4f} ms/pair, "
          f"loader-fed wall classic {fed_ms['classic']:.3f} / SGM {fed_ms['sgm']:.3f} ms/pair",
          flush=True)
    print(json.dumps({"loader": {
        "pairs": n_pairs, "batch": BATCH, "size": SIZE, "num_threads": loader.num_threads,
        "prefetch": loader.prefetch, "decode_h2d_ms_per_pair": loader_ms,
        "decode_h2d_pairs_per_s": 1e3 / loader_ms,
        "first_pass_ms_per_pair": first_s * 1e3 / n_pairs,
        "device_resident_ms_per_pair": dev_ms, "loader_fed_wall_ms_per_pair": fed_ms,
        "loader_over_device": {k: loader_ms / v for k, v in dev_ms.items()},
        "card": smi}}), flush=True)
    host = f"host CPU {cpu_model} x {n_cpus}"
    print(f"[28 codec] the host codec ({native.library_name()}): decode == the plain decoder "
          f"== the pixels on all {len(blobs['filter 0'])} filter-0 and "
          f"{len(blobs['adaptive'])} adaptive-filter PNGs (rows "
          + ", ".join(f"{n} {int(c)}" for n, c in zip(PNG_FILTERS, filter_rows))
          + f"); classic and SGM fed from the adaptive set == Matcher / ModernMatcher bitwise "
          f"(launches {a_counts[0]}, {a_counts[1]}); {smi}; {host}: decode ms per 1 MP image "
          f"on 2 adaptive pairs codec {decode_ms['codec']:.3f} / plain {decode_ms['plain']:.3f}"
          f" (zlib.decompress of the stream alone {decode_ms['inflate']:.3f})"
          + "".join(f", every row {k} codec {v['codec']:.3f} / plain {v['plain']:.3f}"
                    for k, v in forced_ms.items())
          + "; codec decode on 1/2/4/8 threads "
          + " / ".join(f"{v:.3f}" for v in threads_ms.values())
          + " ms per image; loader decode + H2D ms/pair filter 0 "
          + " / ".join(f"{v:.3f}" for v in paces["filter 0"]) + ", adaptive "
          + " / ".join(f"{v:.3f}" for v in paces["adaptive"])
          + "; PPM render ms per 1024² plane "
          + ", ".join(f"{k} codec {v['codec']:.3f} / plain {v['plain']:.3f}"
                      for k, v in ppm_ms.items()) + " (bytes equal); PNG write ms per 1 MP "
          f"image codec {write_ms['codec']:.3f} / plain {write_ms['plain']:.3f} (bytes equal)",
          flush=True)
    print(json.dumps({"codec": {
        "library": native.library_name(), "images_bitwise": {k: len(v) for k, v in blobs.items()},
        "adaptive_filter_rows": dict(zip(PNG_FILTERS, map(int, filter_rows))),
        "decode_ms_per_image": decode_ms, "decode_ms_per_image_every_row": forced_ms,
        "codec_decode_ms_per_image_by_threads": threads_ms,
        "loader_decode_h2d_ms_per_pair": paces, "loader_num_threads": loader.num_threads,
        "ppm_render_ms_per_plane": ppm_ms, "png_write_ms_per_image": write_ms, "card": smi,
        "host_cpu": cpu_model, "host_cpus": n_cpus}}), flush=True)
    del pipe, mpipe, loader

    # Phase 29: the numpy oracle (float64) against the card on one 1024²
    # blob_scene pair at D=64, sw 21, times 32, lines 10: Matcher with the
    # exact rule in ghost and wrap mode (K1, K2), and the reference rule on
    # float64 brightness through ClassicPipeline (K8, K2), every artifact
    # equal; meanwhile the CLI's --tier oracle in a subprocess on phase
    # 18's pair, its PPMs against the card's reference rule on float64.
    left, right, _ = blob_scene(SIZE, SIZE, seed=SEED)
    l64, r64 = left / 256.0, right / 256.0
    rparams = StereoParams(num_shifts=SHIFTS)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ThreadPoolExecutor(1) as pool:
        tmp = Path(tmp)
        lpng, rpng = str(tmp / "L.png"), str(tmp / "R.png")
        write_png_gray(lpng, cli_pair[0])
        write_png_gray(rpng, cli_pair[1])
        cli_job = start_jobs(pool, {"CLI --tier oracle": [
            "-m", "stereomatching_tpu_torch.cli", lpng, rpng, "--shifts", str(SHIFTS),
            "--tier", "oracle", "--outdir", str(tmp / "oracle")]})
        notes, oracle_s, card_ms = [], [], []
        for mode, rule in ((BoundaryMode.GHOST, "exact"), (BoundaryMode.WRAP, "exact"),
                           (BoundaryMode.GHOST, "reference"), (BoundaryMode.WRAP, "reference")):
            p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule=rule)
            t0 = time.perf_counter()
            want = oracle.run_pipeline(l64, r64, p)
            oracle_s.append(time.perf_counter() - t0)
            if rule == "exact":
                got, counts = counted(lambda: Matcher(p)(left, right))
                lt, rt = (torch.from_numpy(x.astype(np.float32) / np.float32(256)).to(dev)
                          for x in (left, right))
            else:
                lt, rt = (torch.from_numpy(x).to(dev) for x in (l64, r64))
                got, counts = counted(lambda: artifacts_to_numpy(ClassicPipeline(p)(lt, rt)))
            kernel = "match_score_edges" if rule == "exact" else "match_and_score"
            check(set(counts) == {kernel, "fill_web_holes_range"},
                  f"oracle phase {mode.value}/{rule} launches {counts}")
            for k, v in want.items():
                check(np.array_equal(got[k], v),
                      f"card {mode.value}/{rule} {k} differs from the oracle")
            check(int(got["min_elevation"]) == int(want["web-2"].min())
                  and int(got["max_elevation"]) == int(want["web-2"].max()),
                  f"card {mode.value}/{rule} elevations differ from the oracle's web")
            card_ms.append(cuda_time_ms(lambda: ClassicPipeline(p)(lt, rt), 3))
            notes.append(f"{mode.value}/{rule} ({lt.dtype}; {counts}): oracle "
                         f"{oracle_s[-1]:.2f} s, card {card_ms[-1]:.4f} ms")
        del lt, rt
        (cli_out, cli_wall), = finished(cli_job).values()
        ppms = {f.name: f.read_bytes() for f in sorted((tmp / "oracle").iterdir())}
        check(sorted(ppms) == sorted(f"{n}.ppm" for n in (
            "edges-1", "edges-2", "score_best-0", "web-1", "web-2", "output-0")),
            f"CLI --tier oracle wrote {sorted(ppms)}")
        check(timing_line(cli_out) is not None, f"CLI --tier oracle timing line {cli_out!r}")
        card = artifacts_to_numpy(ClassicPipeline(rparams)(
            *(torch.from_numpy(x / 256.0).to(dev) for x in cli_pair)))
        for name, data in ppms.items():
            key = "score_best" if name == "score_best-0.ppm" else name[:-4]
            check(data == ppm_bytes(card[key], artifact_ppm_type(name[:-4])),
                  f"CLI --tier oracle {name} differs from the card's reference rule on float64")
    print(f"[29 oracle] oracle.run_pipeline (numpy, float64) on a {SIZE}x{SIZE} blob_scene pair, "
          f"D={SHIFTS}, sw 21, times 32, lines 10 == the card's six artifacts and elevations "
          f"({'; '.join(notes)}; card ms per pair, device-resident); python -m "
          f"stereomatching_tpu_torch.cli --tier oracle on phase 18's pair: rc 0, timing line, "
          f"six PPMs ({', '.join(f'{k} {len(v)} B' for k, v in ppms.items())}) == the card's "
          f"reference rule on float64 brightness, {cli_wall:.3f} s wall; {smi}", flush=True)

    # Phase 30: the quality tool on the card.  A 1024² blob_scene (max
    # disparity 48) as PNGs, its ground truth as PFM and as a 16-bit
    # disparity PNG (port's data.formats); tools/eval_quality_torch.py
    # on them with --device cuda (box; SGM census with the PNG truth) and
    # --device cpu (box), and at --synthetic 32 (270x480) on both devices
    # for both routes, all seven started together; cuda == cpu key for
    # key, and the card's reports == the same pipelines and metrics in
    # this process, launches counted.
    left, right, gt = blob_scene(SIZE, SIZE, seed=SEED, max_disparity=48)
    bparams = ModernParams(num_disparities=SHIFTS)
    sparams = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ThreadPoolExecutor(7) as pool:
        tmp = Path(tmp)
        files = {n: str(tmp / n) for n in ("L.png", "R.png", "gt.pfm", "gt.png")}
        write_png_gray(files["L.png"], left)
        write_png_gray(files["R.png"], right)
        write_pfm(files["gt.pfm"], gt.astype(np.float32))
        write_disparity_png(files["gt.png"], gt)
        truth = {"pfm": read_ground_truth(files["gt.pfm"]).astype(np.float64),
                 "png": read_ground_truth(files["gt.png"]).astype(np.float64)}
        check(np.array_equal(truth["pfm"], gt), "PFM ground truth does not read back")
        check(np.array_equal(np.isnan(truth["png"]), gt == 0)
              and np.array_equal(truth["png"][gt > 0], gt[gt > 0]),
              "16-bit PNG ground truth does not read back (0 == invalid)")
        tool = "tools/eval_quality_torch.py"
        sgm_flags = ["--aggregation", "sgm", "--cost", "census"]
        pair = [files["L.png"], files["R.png"], "--disparities", str(SHIFTS)]
        jobs = start_jobs(pool, {
            "box cuda": [tool, *pair[:2], files["gt.pfm"], *pair[2:], "--device", "cuda"],
            "box cpu": [tool, *pair[:2], files["gt.pfm"], *pair[2:], "--device", "cpu"],
            "sgm cuda": [tool, *pair[:2], files["gt.png"], *pair[2:], *sgm_flags,
                         "--device", "cuda"],
            "box synthetic cuda": [tool, "--synthetic", "32", "--device", "cuda"],
            "box synthetic cpu": [tool, "--synthetic", "32", "--device", "cpu"],
            "sgm synthetic cuda": [tool, "--synthetic", "32", *sgm_flags, "--device", "cuda"],
            "sgm synthetic cpu": [tool, "--synthetic", "32", *sgm_flags, "--device", "cpu"],
        })
        lt, rt = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (left, right))
        expect, q_counts = {}, {}
        for label, p, g in (("box", bparams, truth["pfm"]), ("sgm", sparams, truth["png"])):
            out, q_counts[label] = counted(lambda: artifacts_to_numpy(ModernPipeline(p)(lt, rt)))
            expect[label] = {"valid_pixels": disparity_report(out["subpixel"], g, out["valid"]),
                             "filled_all_pixels": disparity_report(out["filled"], g)}
        check(set(q_counts["box"]) == {"disparity", "fill_invalid"}
              and set(q_counts["sgm"]) == {"sgm_volume", "sgm_directional", "sgm_tail",
                                           "fill_invalid"}, f"quality routes' launches {q_counts}")
        done = finished(jobs)
    reports = {k: json.loads(v[0]) for k, v in done.items()}
    for label in ("box", "box synthetic", "sgm synthetic"):
        check(reports[f"{label} cuda"] == reports[f"{label} cpu"],
              f"eval_quality_torch {label}: --device cuda report != --device cpu")
    for label in ("box", "sgm"):
        got = {k: reports[f"{label} cuda"][k] for k in expect[label]}
        check(got == expect[label], f"eval_quality_torch {label} on the card != in process")
    for label, rep in reports.items():
        v = rep["valid_pixels"]
        check(all(np.isfinite(x) for x in v.values()) and 0 < v["coverage"] <= 1
              and 0 <= v["bad2"] <= v["bad1"] <= 1, f"{label} report {v}")

    def summary(label):
        v = reports[label]["valid_pixels"]
        return (f"{label}: bad-1 {v['bad1']:.4f}, bad-2 {v['bad2']:.4f}, EPE {v['epe']:.4f}, "
                f"coverage {v['coverage']:.4f}, {done[label][1]:.2f} s wall")

    print(f"[30 quality tool] tools/eval_quality_torch.py on a {SIZE}x{SIZE} blob_scene (max "
          f"disparity 48; PFM and 16-bit PNG truth) and --synthetic 32 (270x480): --device cuda "
          f"reports == --device cpu key for key (box on the files; box and SGM on the synthetic "
          f"scene), and == the same pipelines and metrics in process (launches {q_counts}); "
          + "; ".join(summary(k) for k in reports) + f" (seven processes at once); {smi}",
          flush=True)


def measurement_phases(dev, smi: str, cli_pair) -> None:
    """Phases 31-33: the measurement library on the card (``python -m
    stereomatching_tpu_torch.bench`` at its defaults, the roofline of the
    classic and SGM routes), the weak-scaling tool on ``cuda:0``, and the
    knife-edge gate on the card's exact-rule CLI dumps against the
    oracle's reference-rule ones, all in this process.  ``cli_pair``:
    phase 18's (left, right) uint8 pair."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from stereomatching_tpu_torch import cli
    from stereomatching_tpu_torch.bench import __main__ as bench_main
    from stereomatching_tpu_torch.bench import roofline
    from stereomatching_tpu_torch.config import BoundaryMode, StereoParams
    from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_sgm
    from stereomatching_tpu_torch.utils.imageio import write_png_gray

    wrappers = {"match_score_edges": fused.match_score_edges,
                "match_and_score": fused.match_and_score,
                "match_and_score_prehalo": fused.match_and_score_prehalo,
                "fill_web_holes_range": fused_diffusion.fill_web_holes_range,
                "fill_web_holes_step": fused_diffusion.fill_web_holes_step,
                "sgm_volume": fused_sgm.sgm_volume,
                "sgm_directional": fused_sgm.sgm_directional,
                "sgm_tail": fused_sgm.sgm_tail,
                "fill_invalid": fused_diffusion.fill_invalid}

    def counted(fn):
        """-> (fn(), its stdout, {wrapper: launches during it}), counted from zero."""
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue(), {k: w.launches for k, w in wrappers.items() if w.launches}

    def json_lines(text):
        return [json.loads(line) for line in text.splitlines() if line.startswith("{")]

    # Phase 31: the bench CLI at its defaults (phases at 1080x1920, the
    # reference's five sizes, D=30, ghost, exact rule, 3 iterations), then
    # the roofline of the classic routes (batch 8) and of the SGM route
    # (batch 32) at 1024², D=64.  ``verdict`` raises on a share above 100%.
    t0 = time.perf_counter()
    rc, out, b_counts = counted(lambda: bench_main.main(["--json"]))
    check(rc == 0, f"python -m stereomatching_tpu_torch.bench exited {rc}")
    bench = json_lines(out)
    sizes = [r for r in bench if "size" in r]
    check([r["size"] for r in sizes] == ["240x135", "480x270", "960x540", "1920x1080", "3840x2160"]
          and all(r["tier"] == "kernels" and r["mean_s"] > 0 for r in sizes),
          f"bench size lines {sizes}")
    check(set(b_counts) == {"match_score_edges", "match_and_score", "fill_web_holes_range"},
          f"bench launches {b_counts}")
    classic_rows, _, c_counts = counted(lambda: roofline.measure(
        SIZE, SIZE, SHIFTS, BATCH, device=dev))
    sgm_rows, _, s_counts = counted(lambda: roofline.measure_sgm(
        SIZE, SIZE, SHIFTS, SGM_BENCH_BATCH, device=dev))
    check(set(c_counts) == {"match_score_edges", "match_and_score", "fill_web_holes_range"},
          f"roofline classic launches {c_counts}")
    check(set(s_counts) == {"sgm_volume", "sgm_directional", "sgm_tail", "fill_invalid"},
          f"roofline SGM launches {s_counts}")
    info = roofline.card(dev)
    print(f"[31 bench and roofline] {smi}: python -m stereomatching_tpu_torch.bench --json: "
          + ", ".join(f"{r['size']} {r['mean_s'] * 1e3:.4f} ms ({r['gpixel_passes_per_s']:.1f} "
                      f"Gpixel-passes/s)" for r in sizes)
          + "; roofline ms/pair (share of bound): "
          + ", ".join(f"{r['phase']} {r['ms_per_pair']:.4f} ({r['share_of_bound_pct']:.1f}%)"
                      for r in classic_rows + sgm_rows)
          + f"; launches bench {b_counts}, classic {c_counts}, SGM {s_counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"roofline": {"card": info["name"], "power_limit": info["power_limit"],
                                   "classic": classic_rows, "sgm": sgm_rows, "bench": bench}}),
          flush=True)

    # Phase 32: the weak-scaling tool on cuda:0 at 1, 2 and 4 row shards
    # (256 rows x 1024 a shard, batch 2), the shards stacked on the card.
    t0 = time.perf_counter()
    rc, out, w_counts = counted(lambda: load_tool("scaling_bench_torch").main(["--max-shards", "4"]))
    scaling = json.loads(out)
    check(rc == 0 and [r["shards"] for r in scaling["results"]] == [1, 2, 4]
          and all(r["devices"] == 1 and np.isfinite(r["checksum"]) for r in scaling["results"]),
          f"scaling tool: {scaling}")
    check(set(w_counts) == {"match_and_score_prehalo", "fill_web_holes_step"},
          f"scaling tool launches {w_counts}")
    print(f"[32 scaling tool] {smi}: tools/scaling_bench_torch.py on cuda:0: "
          + ", ".join(f"{r['shards']} shards {r['ms_per_batch']:.3f} ms/batch "
                      f"({r['mpix_per_s']:.1f} Mpix/s, efficiency "
                      f"{r['weak_scaling_efficiency']:.3f}; block-fed "
                      f"{r['block_fed_ms_per_batch']:.3f}, "
                      f"{r['block_fed_weak_scaling_efficiency']:.3f})"
                      for r in scaling["results"])
          + f"; launches {w_counts}; {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"scaling_one_card": scaling}), flush=True)

    # Phase 33: the knife-edge gate at 1024² on phase 18's pair, both
    # modes: the CLI's --tier cuda --edge-rule exact dumps (K1, K2) against
    # its --tier oracle --edge-rule reference ones (the CLI's defaults
    # otherwise: D=30, sw 21, times 32, lines 10).
    t0 = time.perf_counter()
    gate = load_tool("knife_edge_torch")
    notes = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        a, b = str(tmp / "a.png"), str(tmp / "b.png")
        write_png_gray(a, cli_pair[0])
        write_png_gray(b, cli_pair[1])
        for mode in ("ghost", "wrap"):
            ours, ref = str(tmp / f"ours_{mode}"), str(tmp / f"ref_{mode}")
            rc, _, k_counts = counted(lambda: cli.main(
                [a, b, "--tier", "cuda", "--edge-rule", "exact", "--mode", mode,
                 "--outdir", ours]))
            check(rc == 0 and set(k_counts) == {"match_score_edges", "fill_web_holes_range"},
                  f"CLI --tier cuda {mode}: rc {rc}, launches {k_counts}")
            rc, _, _ = counted(lambda: cli.main(
                [a, b, "--tier", "oracle", "--edge-rule", "reference", "--mode", mode,
                 "--outdir", ref]))
            check(rc == 0, f"CLI --tier oracle {mode}: rc {rc}")
            params = StereoParams(mode=BoundaryMode(mode), edge_rule="exact")
            n_tie, n_ok = gate.gate_pair(ref, ours, a, b, "0.15", params, 2e-4, verbose=False)
            check(n_ok == len(gate.DOWNSTREAM), f"knife-edge {mode}: {n_ok} downstream equal")
            notes.append(f"{mode}: {n_tie} edge diff(s), all proven ties, {n_ok}/"
                         f"{len(gate.DOWNSTREAM)} downstream byte-identical (launches {k_counts})")
    print(f"[33 knife-edge gate] {SIZE}x{SIZE}, the card's exact-rule CLI dumps against the "
          f"oracle's reference-rule ones: {'; '.join(notes)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def random_routes_phase(dev, smi: str) -> None:
    """Phase 34: seeded random configurations for every kernel, drawn so
    that across the phase each kernel takes every route it has (K1 and
    K8 with and without the sub-pixel plane, K9 on uneven row shards in
    both modes, rows-only and pre-extended, K2 on 1-, 2- and 4-byte cells
    and its step entry, K3's pixels, vectors and elements, K4's ring and
    element paths in all eight directions, seeded or not, K5's segments
    and wide kernels, K6 in none, one and chained launches and its sweep
    entry, K7's strips, staged and L1 tiles for both costs and both
    reference views).  Each kernel against its plain version on the same
    CUDA tensors, bitwise, its launch count checked; then whole random
    configs through ``ClassicPipeline`` and ``ModernPipeline`` on the card
    against the same on the CPU, configs past a kernel's limits (the
    plain routes chosen before launch) among them, and the sharded tier on
    meshes of the card (half of its configs fed ``Sharded.from_global``
    blocks, half global batches) against the single-device route on the
    CPU.  A
    mismatch fails the run naming the kernel, route and config; so does a
    route drawn zero times.  Prints one line and a ``{"random_routes": ...}`` line."""
    import numpy as np
    import torch

    from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.models import classic, modern
    from stereomatching_tpu_torch.ops import (
        costvolume, fused, fused_diffusion, fused_modern, fused_sgm, sgm)
    from stereomatching_tpu_torch.parallel import (
        Sharded, build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh,
        outputs_to_global)

    seed = RANDOM_ROUTES_SEED
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    hits = {}  # kernel -> {route: configs drawn}

    def pick(*options):
        return options[int(rng.integers(len(options)))]

    def between(lo, hi):
        """An int in [lo, hi]."""
        return int(rng.integers(lo, hi + 1))

    def length(tile):
        """A side below one 32-row strip, below ``tile``, or across a few
        tiles; never a multiple of ``tile``."""
        n = pick(between(1, 31), between(32, tile - 1), between(tile + 1, 3 * tile))
        return n + 1 if n % tile == 0 else n

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def hold(kernel, route, cfg, wrapper, launches, kernel_call, plain_call):
        """The kernel (``launches`` launches of ``wrapper``) against its
        plain version on the same tensors, every output bitwise."""
        before = wrapper.launches
        got = kernel_call()
        n = wrapper.launches - before
        check(n == launches, f"[34] {kernel} {route} {cfg}: {n} launches, expected {launches}")
        ref = plain_call()
        got, ref = ((x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, ref))
        check(len(got) == len(ref), f"[34] {kernel} {route} {cfg}: {len(got)} outputs, plain "
              f"{len(ref)}")
        for i, (a, b) in enumerate(zip(got, ref)):
            check(same(a, b), f"[34 random routes] {kernel} route {route} {cfg}: output {i} "
                  f"differs from plain (max |d| {max_abs_diff(a, b)})")
        hits.setdefault(kernel, {}).setdefault(route, 0)
        hits[kernel][route] += 1

    def hold_planes(group, route, cfg, got, want):
        """Every plane of ``got`` (on the card) bitwise equal to ``want``
        (the same route on the CPU)."""
        check(sorted(got) == sorted(want), f"[34] {group} {route} {cfg}: keys")
        for k in want:
            check(same(got[k].cpu(), want[k]), f"[34 random routes] {group} {route} {cfg}: "
                  f"{k} differs from the CPU route")
        hits.setdefault(group, {}).setdefault(route, 0)
        hits[group][route] += 1

    def brightness(*shape):
        return on_card(u8_to_brightness(rng.integers(0, 256, shape, dtype=np.uint8)))

    def edge_maps(*shape):
        """int32 maps, a non-zero cell an edge (0/1, or any int)."""
        hi = pick(2, 2, 9)
        return [on_card(rng.integers(-hi // 2, hi, shape).astype(np.int32)) for _ in range(2)]

    # K1 and K8: shapes under one strip, one tile and across tiles, sw 1-255
    # up to the image's sides, D 1-200, both modes, sub-pixel on and off.
    for kernel, n in (("K1", 32), ("K8", 32)):
        for i in range(n):
            subpixel = i % 2 == 1
            b, h, w = between(1, 3), length(128), length(128)
            if i % 5 == 4:
                h, w = between(256, 330), between(256, 330)
            sw = between(0, (min(h, w, 255) - 1) // 2) * 2 + 1
            p = StereoParams(num_shifts=between(1, 200), square_width=sw,
                             threshold=float(rng.uniform(0.05, 0.5)), edge_rule="exact",
                             mode=pick(BoundaryMode.GHOST, BoundaryMode.WRAP))
            cfg = f"{b}x{h}x{w} sw {sw} D {p.num_shifts} {p.mode.value} subpixel {subpixel}"
            route = "sub-pixel" if subpixel else "no sub-pixel"
            if kernel == "K1":
                lt, rt = brightness(b, h, w), brightness(b, h, w)
                hold(kernel, route, cfg, fused.match_score_edges, 1,
                     lambda: fused.match_score_edges(lt, rt, p, subpixel),
                     lambda: fused.match_score_edges_reference(lt, rt, p, subpixel))
            else:
                el, er = edge_maps(b, h, w)
                hold(kernel, route, cfg, fused.match_and_score, 1,
                     lambda: fused.match_and_score(el, er, p, subpixel),
                     lambda: fused.match_and_score_reference(el, er, p, subpixel))

    # K9: stacked halo blocks of row shards whose interior is no multiple
    # of a strip or a tile, halos of square_width // 2 and more, global
    # first rows and columns anywhere around the image; rows-only blocks
    # (the right map extended by D, or read modulo W in wrap mode) and
    # pre-extended ones (a 2-D mesh's: column halos inside the blocks).
    for i in range(24):
        mode = pick(BoundaryMode.GHOST, BoundaryMode.WRAP)
        pre_extended = i % 2 == 1
        sw = between(0, 31) * 2 + 1
        p = StereoParams(num_shifts=between(1, 100), square_width=sw, mode=mode)
        half, d = p.half, p.num_shifts
        halo = half + between(0, 3)
        b, hs, w = between(1, 4), length(128), between(1, 300)
        wrap = mode == BoundaryMode.WRAP and not pre_extended
        wr = w if wrap and rng.random() < 0.5 else w + d + between(0, 2)
        h_global = between(hs, 4 * hs)
        kw = dict(l_blk=edge_maps(b, hs + 2 * halo, w)[0],
                  r_blk=edge_maps(b, hs + 2 * halo, wr)[0], halo=halo,
                  row0=torch.from_numpy(rng.integers(-halo, h_global, b).astype(np.int32)),
                  h_global=h_global, pre_extended=pre_extended)
        if pre_extended:
            kw.update(col0=torch.from_numpy(rng.integers(-half - 2, w, b).astype(np.int32)),
                      w_global=between(max(w - 2 * half, 1), 2 * w))
        cfg = (f"{b} blocks of {hs}+2x{halo} rows x {w} (right {wr}) sw {sw} D {d} "
               f"{mode.value} row0 {kw['row0'].tolist()} h_global {h_global}"
               + (f" col0 {kw['col0'].tolist()} w_global {kw['w_global']}" if pre_extended else ""))
        route = f"{mode.value} {'pre-extended' if pre_extended else 'rows'}"
        hold("K9", route, cfg, fused.match_and_score_prehalo, 1,
             lambda: fused.match_and_score_prehalo(params=p, **kw),
             lambda: fused.match_and_score_prehalo_reference(params=p, **kw))

    # K2: times 0-100; value bounds for 1-byte cells (up to 256, 255 and
    # 256 among them), 2-byte cells (257 to 65536) and int32 cells (None:
    # any value, negative ones too); widths across the tile edges of each
    # storage; batch 1 included.  Its step entry on halo blocks.
    for i in range(36):
        nbytes = (1, 2, 4)[i % 3]
        vb = {1: pick(between(2, 256), 255, 256), 2: pick(257, 65536, between(258, 65535)),
              4: None}[nbytes]
        th, tw = fused_diffusion.K2_TILES[nbytes]
        b = pick(1, 1, 2, 3)
        h = pick(between(1, 4), between(th - 2, th + 2), between(1, 2 * th + 9))
        w = pick(between(1, 4), tw * between(1, 3) + between(-1, 1), between(1, 700))
        lo, hi = (0, vb) if vb is not None else pick((0, 1 << 24), (-(1 << 20), 1 << 20))
        web = rng.integers(lo, hi, (b, h, w))
        web[rng.random((b, h, w)) < rng.uniform(0, 0.9)] = 0
        web = on_card(web.astype(np.int32))
        times = pick(0, 1, 2, 17, 18, 32, 33, 100, between(0, 100))
        plan = fused_diffusion.k2_plan(times, vb)
        check(plan.storage_bytes == nbytes, f"K2 value_bound {vb}: {plan.storage_bytes} bytes")
        cfg = f"{b}x{h}x{w} times {times} value_bound {vb} values [{lo}, {hi})"
        hold("K2", f"{nbytes}-byte cells", cfg, fused_diffusion.fill_web_holes_range,
             plan.launches, lambda: fused_diffusion.fill_web_holes_range(web, times, vb),
             lambda: fused_diffusion.fill_web_holes_range_reference(web, times))
    for i in range(8):
        x_off, b, hs, ws = i % 2, between(1, 3), between(1, 100), between(1, 200)
        prev = on_card(rng.integers(0, 70, (b, hs, ws)).astype(np.int32))
        ext = rng.integers(0, 70, (b, hs + 2, ws + 2 * x_off))
        ext[rng.random(ext.shape) < 0.5] = 0
        ext = on_card(ext.astype(np.int32))
        hold("K2 step", "rows and columns halo" if x_off else "rows halo",
             f"{b}x{hs}x{ws} x_off {x_off}", fused_diffusion.fill_web_holes_step, 1,
             lambda: fused_diffusion.fill_web_holes_step(prev, ext, x_off),
             lambda: fused_diffusion.fill_web_holes_step_reference(prev, ext, x_off))

    # K3: census (codes over all 32 bits) and SAD (pixels; 0..127 into
    # int8) at int8, int16 and int32, D and W drawn for each route: D a
    # multiple of 32 (pixels), rows of whole 16-byte vectors that span
    # pixels (vectors), the rest (elements).
    for i in range(36):
        route = fused_sgm.K3_ROUTES[i % 3]
        vdtype = (torch.int8, torch.int16, torch.int32)[i // 3 % 3]
        cost = pick("census", "sad")
        esz = torch.empty((), dtype=vdtype).element_size()
        while True:
            d = 32 * between(1, 8) if route == "pixels" else between(1, 255)
            w = between(1, 300)
            if route == "vectors":
                g = 16 // np.gcd(d * esz, 16)
                w = g * between(1, max(300 // g, 1))
            if fused_sgm.k3_route((w, d), vdtype) == route:
                break
        b, h = between(1, 3), between(1, 64)
        if cost == "census":
            ins = [rng.integers(-2**31, 2**31, (b, h, w)) for _ in range(2)]
        else:
            ins = [rng.integers(0, 128 if vdtype == torch.int8 else 256, (b, h, w))
                   for _ in range(2)]
        ref_t, oth_t = (on_card(x.astype(np.int32)) for x in ins)
        cfg = f"{b}x{h}x{w} D {d} {cost} {str(vdtype).split('.')[-1]}"
        hold("K3", route, cfg, fused_sgm.sgm_volume, 1,
             lambda: fused_sgm.sgm_volume(ref_t, oth_t, d, cost, vdtype),
             lambda: fused_sgm.sgm_volume_reference(ref_t, oth_t, d, cost, vdtype))

    # K4: the eight directions in turn, the ring (a step's runs whole
    # 16-byte chunks, D % ND == 0) and the element path (D = 11, 37, 40,
    # 100 at int8 among others), written or added, seeded chains with their
    # carry, random P1 and P2 >= P1, lines shorter than the ring of 8.
    def k4_ring(d, vdtype, adtype):
        """The ring's condition of ``csrc/sgm_directional.cu``
        ``launch_nd`` (torch allocations are 16-byte aligned)."""
        nd = 1 << max(-(-d // 32) - 1, 0).bit_length()
        sizes = (torch.empty((), dtype=t).element_size() for t in (vdtype, adtype))
        return all(d * s % 16 == 0 for s in sizes) and d % nd == 0

    k4_directions = set()
    paths = sgm.PATHS + sgm.DIAG_PATHS
    for i in range(64):
        direction, reverse = paths[i % 8]
        ring = i // 8 % 2 == 0
        vdtype, adtype = pick((torch.int8, torch.int16), (torch.int8, torch.int32),
                              (torch.int16, torch.int16), (torch.int16, torch.int32),
                              (torch.int32, torch.int32))
        while True:
            d = pick(between(1, 256), 16 * between(1, 16),
                     *(() if ring else (11, 37, 40, 100)))
            if k4_ring(d, vdtype, adtype) == ring:
                break
        cmax = {torch.int8: 100, torch.int16: 1000, torch.int32: 10**6}[vdtype]
        p1 = between(0, 50)
        p2 = p1 + between(0, 2000 if adtype == torch.int16 else 10**6)
        b = between(1, 2)
        h, w = pick((between(1, 7), between(1, 160)), (between(1, 160), between(1, 7)),
                    (between(8, 160), between(8, 160)))
        vol = on_card(rng.integers(0, cmax + 1, (b, h, w, d)).astype(
            str(vdtype).split('.')[-1]))
        agg0 = on_card(rng.integers(0, 1001, (b, h, w, d)).astype(str(adtype).split('.')[-1]))
        accumulate = bool(rng.integers(0, 2))
        seeded = direction != sgm.X and rng.random() < 0.4
        kw = {}
        if seeded:
            kw = dict(seed=on_card(rng.integers(0, cmax + p2, (b, w, d)).astype(np.int32)),
                      with_carry=True)
        agg_k, agg_p = agg0.clone(), agg0.clone()
        cfg = (f"{b}x{h}x{w} D {d} vol {vdtype} agg {adtype} P1 {p1} P2 {p2} direction "
               f"{direction} reverse {reverse} accumulate {accumulate} seeded {seeded}")
        hold("K4", ("seeded " if seeded else "") + ("ring" if ring else "elements"), cfg,
             fused_sgm.sgm_directional, 1,
             lambda: fused_sgm.sgm_directional(vol, agg_k, p1, p2, direction, reverse,
                                               accumulate, **kw),
             lambda: fused_sgm.sgm_directional_plain(vol, agg_p, p1, p2, direction, reverse,
                                                     accumulate, **kw))
        k4_directions.add((direction, reverse))
    check(len(k4_directions) == 8, f"K4 directions drawn: {sorted(k4_directions)}")

    # K5: each route by its rule (segments; wide: int32 at D 256 on rows past
    # 226 columns, or a run past 8 words a lane), with and without the
    # second best, values with ties, near the dtype's top and, at int32,
    # near the right view's sentinel 2^28; the wide kernel also on every
    # segment shape.
    def k5_widest(esz, d):
        """The widest row whose segment still fits K5's shared memory."""
        w = fused_sgm.K5_SEG_PX + d - 1
        while fused_sgm.k5_smem_bytes(esz, d, w) > fused_sgm.K5_SMEM_LIMIT:
            w -= 1
        return w

    for i in range(36):
        route = ("segments", "wide")[i % 2]
        uniq = i // 2 % 2 == 1
        while True:
            adtype = pick(torch.int16, torch.int32)
            if i % 3 == 0:  # either side of the segment's shared-memory limit
                adtype, d = torch.int32, between(200, 256)
                w = k5_widest(4, d) + (route == "wide")
            elif route == "segments":
                d, w = between(1, 256), between(1, 300)
            elif adtype == torch.int32:
                d, w = pick((256, between(227, 400)), (between(257, 300), between(1, 200)))
            else:
                d, w = between(513, 600), between(1, 100)
            if fused_sgm.k5_route((w, d), adtype) == route:
                break
        b, h = between(1, 2), between(1, 24)
        top = 32767 if adtype == torch.int16 else 1 << 28
        lo, hi = pick((0, 8), (0, top // 8), (top - 600, top + 1 if adtype == torch.int16
                                               else top + 600))
        agg = on_card(rng.integers(lo, hi, (b, h, w, d)).astype(str(adtype).split('.')[-1]))
        cfg = f"{b}x{h}x{w} D {d} {adtype} values [{lo}, {hi}) second best {uniq}"
        hold("K5", route, cfg, fused_sgm.sgm_tail, 1, lambda: fused_sgm.sgm_tail(agg, uniq),
             lambda: fused_sgm.sgm_tail_reference(agg, uniq))
        if route == "segments":
            hold("K5", "wide (forced)", cfg, fused_sgm.sgm_tail, 1,
                 lambda: fused_sgm._tail_on_card(agg, uniq, "wide"),
                 lambda: fused_sgm.sgm_tail_reference(agg, uniq))

    # K6: sweeps 0-33 and 100 (no launch, one, chained), images smaller
    # than one 64 x 64 tile and across tiles, validity from none to all
    # (blocks whose cells all stay invalid stop early), planes seeded with
    # -0.0 and NaN.  Its sweep entry on halo blocks.
    k6_seeded = 0
    for i in range(40):
        it = pick(0, between(1, 16), between(17, 33), 100)
        b = between(1, 3)
        h, w = pick((between(1, 63), between(1, 63)), (between(1, 300), between(1, 300)))
        d = rng.uniform(0, 64, (b, h, w)).astype(np.float32)
        special = rng.random() < 0.5
        if special:
            d[rng.random((b, h, w)) < 0.05] = -0.0
            d[rng.random((b, h, w)) < 0.02] = np.nan
            k6_seeded += 1
        valid = rng.random((b, h, w)) < pick(0.0, 0.002, 0.05, 0.5, 1.0)
        dt, vt = on_card(d), on_card(valid)
        launches = fused_diffusion.k6_plan(it).launches
        route = {0: "no launch", 1: "one launch"}.get(launches, "chained launches")
        cfg = f"{b}x{h}x{w} sweeps {it} valid {valid.mean():.4f} -0.0/NaN seeded {special}"
        hold("K6", route, cfg, fused_diffusion.fill_invalid, launches,
             lambda: fused_diffusion.fill_invalid(dt, vt, it),
             lambda: fused_diffusion.fill_invalid_reference(dt, vt, it))
    check(k6_seeded > 0, "K6: no plane seeded with -0.0 and NaN")
    for i in range(8):
        x_off, b, hs, ws = i % 2, between(1, 3), between(1, 100), between(1, 200)
        d = rng.uniform(0, 64, (b, hs + 2, ws + 2 * x_off)).astype(np.float32)
        d[rng.random(d.shape) < 0.05] = np.nan
        de = on_card(d)
        ve = on_card((rng.random(d.shape) < 0.3).astype(np.uint8))
        hold("K6 step", "rows and columns halo" if x_off else "rows halo",
             f"{b}x{hs}x{ws} x_off {x_off}", fused_diffusion.fill_invalid_step, 1,
             lambda: fused_diffusion.fill_invalid_step(de, ve, x_off),
             lambda: fused_diffusion.fill_invalid_step_reference(de, ve, x_off))

    # K7: windows and D drawn until ``fused_modern.route`` takes each of
    # its kernels for each cost that reaches it (SAD never stages its
    # tiles), both reference views; census codes of the 3x3 or 5x5
    # transform, SAD pixels 0..255.
    k7_targets = [(r, c, ref) for r, c in (("strips", "sad"), ("strips", "census"),
                                          ("tiles staged", "census"),
                                          ("tiles through L1", "sad"),
                                          ("tiles through L1", "census"))
                  for ref in ("left", "right")]
    for i in range(40):
        route, cost, reference = k7_targets[i % len(k7_targets)]
        for _ in range(1000):
            if route == "strips":
                window, d = between(0, 49 if cost == "census" else 120) * 2 + 1, between(2, 256)
            elif route == "tiles staged":
                window, d = between(0, 20) * 2 + 1, between(100, 256)
            else:
                window, d = between(25, 127) * 2 + 1, between(100, 256)
            p = ModernParams(num_disparities=d, window=window, cost=cost,
                             census_window=pick(3, 5))
            if fused_modern.route(p) == route:
                break
        else:
            fail(f"K7: no draw reached {route} for {cost}")
        b, h, w = between(1, 2), between(1, 150), between(1, 200)
        pix = [on_card(rng.integers(0, 256, (b, h, w)).astype(np.int32)) for _ in range(2)]
        ins = ([costvolume.census_transform(x, p.census_window).contiguous() for x in pix]
               if cost == "census" else pix)
        cfg = f"{b}x{h}x{w} {cost} window {window} D {d} reference {reference}"
        hold("K7", f"{route} {cost} {reference}", cfg, fused_modern.disparity, 1,
             lambda: fused_modern.disparity(*ins, p, reference),
             lambda: fused_modern.disparity_reference(*ins, p, reference))

    # Pipelines: random classic and modern configs through ClassicPipeline
    # and ModernPipeline on the card against the same on the CPU, every
    # plane bitwise; a quarter of them past a kernel's limits (square
    # width 257-301, D 257-320, box window 257-301), which run that stage's
    # plain version on the card.
    for i in range(16):
        past = i % 4 == 3
        b, h, w = (1, 320, 320) if past else (between(1, 2), between(9, 200), between(13, 300))
        sw = between(128, 150) * 2 + 1 if past else between(0, (min(h, w, 63) - 1) // 2) * 2 + 1
        p = StereoParams(num_shifts=between(1, 16 if past else w + 10), square_width=sw,
                         threshold=float(rng.uniform(0.05, 0.5)), times=between(0, 40),
                         lines=between(1, 12), mode=pick(BoundaryMode.GHOST, BoundaryMode.WRAP),
                         edge_rule=pick("exact", "reference"))
        subpixel = bool(rng.integers(0, 2))
        lu, ru = (u8_to_brightness(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
                  for _ in range(2))
        route = "classic plain stage" if classic.plain_stages(p) else "classic kernels"
        cfg = f"{b}x{h}x{w} {p} subpixel {subpixel}"
        pipe = classic.ClassicPipeline(p, subpixel)
        got = pipe(on_card(lu), on_card(ru))
        want = pipe(torch.from_numpy(lu), torch.from_numpy(ru))
        hold_planes("pipelines", route, cfg, got, want)
    for i in range(16):
        agg = ("box", "sgm")[i % 2]
        past = i % 4 >= 2
        kw = dict(aggregation=agg, cost=pick("sad", "census"), census_window=pick(3, 5),
                  scales=pick(1, 2), lr_max_diff=between(0, 2),
                  median_filter=bool(rng.integers(0, 2)),
                  fill_mode=pick("diffusion", "background"), fill_iterations=between(0, 20),
                  num_disparities=between(257, 320) if past else between(2, 64))
        if agg == "box" and past and i % 8 >= 6:  # past K7's window instead of its D
            kw.update(window=between(128, 150) * 2 + 1, num_disparities=between(2, 64))
        elif agg == "box":
            kw["window"] = between(0, 15) * 2 + 1
        else:
            p1 = between(0, 20)
            kw.update(sgm_p1=p1, sgm_p2=p1 + between(0, 200), sgm_directions=pick(4, 8),
                      uniqueness=bool(rng.integers(0, 2)))
        p = ModernParams(**kw)
        b, h, w = between(1, 2), between(8, 64), between(16, 160)
        lu, ru = (rng.integers(0, 256, (b, h, w), dtype=np.uint8) for _ in range(2))
        route = f"{agg} {'plain stage' if modern.plain_stages(p) else 'kernels'}"
        cfg = f"{b}x{h}x{w} {p}"
        pipe = modern.ModernPipeline(p)
        got = pipe(on_card(lu).to(torch.int32), on_card(ru).to(torch.int32))
        want = pipe(torch.from_numpy(lu).to(torch.int32), torch.from_numpy(ru).to(torch.int32))
        hold_planes("pipelines", route, cfg, got, want)

    # The sharded tier on meshes of cuda:0 (every shard stacked, each stage
    # one launch over them: K9, K2's and K6's step entries, K4's seeded
    # chain) against the single-device pipeline on the CPU: classic on
    # data x rows (x cols), the box route on rows x cols, SGM on rows, at
    # random shard sides down to each halo's reach.
    for i in range(12):
        kind = ("classic", "box", "sgm")[i % 3]
        cols = (2 if i % 6 == 3 else None) if kind == "classic" else 2 if kind == "box" else None
        data, rows = (pick(1, 2), pick(2, 4)) if kind == "classic" else (1, pick(2, 4))
        b = data * between(1, 2)
        if kind == "classic":
            p = StereoParams(num_shifts=between(1, 24), square_width=between(0, 4) * 2 + 1,
                             threshold=float(rng.uniform(0.05, 0.5)), times=between(0, 12),
                             lines=between(1, 12), mode=pick(BoundaryMode.GHOST, BoundaryMode.WRAP),
                             edge_rule=pick("exact", "reference"))
            y_reach, x_reach = max(p.half, 1), p.num_shifts + p.half
        else:
            p = ModernParams(aggregation=kind, cost=pick("sad", "census"),
                             census_window=pick(3, 5), window=between(0, 3) * 2 + 1,
                             num_disparities=between(2, 24), lr_max_diff=between(0, 2),
                             median_filter=bool(rng.integers(0, 2)),
                             fill_mode="diffusion" if cols else pick("diffusion", "background"),
                             fill_iterations=between(0, 20),
                             **({"sgm_directions": pick(4, 8), "sgm_p1": 8,
                                 "sgm_p2": between(8, 200), "uniqueness": bool(rng.integers(0, 2))}
                                if kind == "sgm" else {}))
            ch = p.census_window // 2 if p.cost == "census" else 0
            y_reach = max(ch if kind == "sgm" else p.window // 2 + ch, 1)
            x_reach = p.num_disparities + p.window // 2 + ch
        h = rows * between(y_reach, y_reach + 20)
        w = cols * between(x_reach, x_reach + 24) if cols else between(13, 160)
        lu, ru = (rng.integers(0, 256, (b, h, w), dtype=np.uint8) for _ in range(2))
        mesh = make_mesh(data=data, rows=rows, cols=cols,
                         devices=[dev] * (data * rows * (cols or 1)))
        # Half of them block-fed: inputs placed on the mesh before the call.
        feed = "block-fed" if i % 2 else "global-fed"

        def fed(x):
            return Sharded.from_global(on_card(x), mesh) if i % 2 else on_card(x)

        if kind == "classic":
            lf, rf = u8_to_brightness(lu), u8_to_brightness(ru)
            got = build_sharded_pipeline(p, mesh)(fed(lf), fed(rf))
            want = classic.classic_forward_batched(torch.from_numpy(lf), torch.from_numpy(rf), p)
        else:
            li, ri = lu.astype(np.int32), ru.astype(np.int32)
            got = build_sharded_modern_pipeline(p, mesh)(fed(li), fed(ri))
            want = modern.modern_forward(torch.from_numpy(li), torch.from_numpy(ri), p)
        route = f"sharded {kind} {'rows x cols' if cols else 'rows'}"
        cfg = f"{b}x{h}x{w} mesh {data}x{rows}x{cols or 1} {feed} {p}"
        hold_planes("sharded", route, cfg, outputs_to_global(got), want)
        hits.setdefault("sharded feeds", {}).setdefault(feed, 0)
        hits["sharded feeds"][feed] += 1

    want_routes = {
        "K1": {"no sub-pixel", "sub-pixel"}, "K8": {"no sub-pixel", "sub-pixel"},
        "K9": {f"{m} {s}" for m in ("ghost", "wrap") for s in ("rows", "pre-extended")},
        "K2": {"1-byte cells", "2-byte cells", "4-byte cells"},
        "K2 step": {"rows halo", "rows and columns halo"},
        "K3": set(fused_sgm.K3_ROUTES),
        "K4": {"ring", "elements", "seeded ring", "seeded elements"},
        "K5": {"segments", "wide", "wide (forced)"},
        "K6": {"no launch", "one launch", "chained launches"},
        "K6 step": {"rows halo", "rows and columns halo"},
        "K7": {f"{r} {c} {ref}" for r, c, ref in k7_targets},
        "pipelines": {f"{a} {s}" for a in ("classic", "box", "sgm")
                      for s in ("kernels", "plain stage")},
        "sharded": {"sharded classic rows", "sharded classic rows x cols",
                    "sharded box rows x cols", "sharded sgm rows"},
        "sharded feeds": {"block-fed", "global-fed"},
    }
    for kernel, routes in want_routes.items():
        missing = routes - set(hits.get(kernel, {}))
        check(not missing, f"[34 random routes] seed {seed}: {kernel} never drew {sorted(missing)}")
    seconds = time.perf_counter() - t0
    print(f"[34 random routes] seed {seed}: "
          + ", ".join(f"{k} {sum(r.values())} ("
                      + ", ".join(f"{n} {c}" for n, c in sorted(r.items())) + ")"
                      for k, r in hits.items())
          + f"; K4 in all 8 directions; every output == plain bitwise (pipelines == the CPU "
          f"route); {seconds:.1f} s", flush=True)
    print(json.dumps({"random_routes": {"seed": seed, "seconds": seconds, "configs": hits}}),
          flush=True)


def sharded_io_phase(dev, smi: str) -> None:
    """Phase 35: the sharded tier fed and read block by block.  On a data
    2 x rows 4 mesh of ``dev`` (classic, ghost/exact and wrap/reference)
    and a rows 4 one (bench.py's SGM params, the box default), at
    1024², D=64, batch 8: the pipelines fed global batches, batches
    placed by ``Sharded.from_global`` and the ``BatchLoader(mesh=...)``
    batch of phase 28's first 8 PNG pairs; every output block of the
    block-fed routes bitwise the global-fed route's, every output after
    ``to_global`` bitwise the single-device pipeline's, the launch counts
    those of phases 22-23; CUDA-event ms/pair of the block-fed route
    (outputs left on their shards), the global-fed route with
    ``to_global`` and the single-device pipeline.  With more than one GPU
    visible, the classic case again on a mesh over all of them."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from stereomatching_tpu_torch import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset
    from stereomatching_tpu_torch.models.classic import ClassicPipeline
    from stereomatching_tpu_torch.models.modern import ModernPipeline
    from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_modern, fused_sgm
    from stereomatching_tpu_torch.parallel import (
        PLANE, Sharded, build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh,
        outputs_to_global)
    from stereomatching_tpu_torch.utils.imageio import write_png_gray

    t0 = time.perf_counter()
    wrappers = {"match_score_edges": fused.match_score_edges,
                "match_and_score": fused.match_and_score,
                "match_and_score_prehalo": fused.match_and_score_prehalo,
                "fill_web_holes_range": fused_diffusion.fill_web_holes_range,
                "fill_web_holes_step": fused_diffusion.fill_web_holes_step,
                "disparity": fused_modern.disparity,
                "sgm_volume": fused_sgm.sgm_volume,
                "sgm_directional": fused_sgm.sgm_directional,
                "sgm_tail": fused_sgm.sgm_tail,
                "fill_invalid": fused_diffusion.fill_invalid,
                "fill_invalid_step": fused_diffusion.fill_invalid_step}

    def counted(fn):
        """-> (fn(), {wrapper: launches during it} of those launched)."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items() if w.launches}

    # Phase 28's first 8 pairs (the same seed and draws), as PNGs.
    prng = np.random.default_rng(SEED + 28)
    scenes = [shifted_pair(prng, SIZE, (2, 4)[i % 4 // 2], SHIFTS, sign=(-1, 1)[i % 2])
              for i in range(BATCH)]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ThreadPoolExecutor(8) as pool:
        tmp = Path(tmp)
        for w in [pool.submit(write_png_gray, str(tmp / f"p{i}_{side}.png"), img)
                  for i, (left, right, _) in enumerate(scenes)
                  for side, img in (("left", left), ("right", right))]:
            w.result()
        ds = StereoPairDataset.from_root(str(tmp))
        check(len(ds) == BATCH, f"phase 35 found {len(ds)} pairs")
        order = [int(Path(a).name[1:].split("_")[0]) for a, _ in ds.pairs]
        left_u8 = np.stack([scenes[i][0] for i in order])
        right_u8 = np.stack([scenes[i][1] for i in order])
        loaded = {shape: next(iter(BatchLoader(ds, BATCH, mesh=make_mesh(
            *shape, devices=[dev] * (shape[0] * shape[1]))))) for shape in ((2, 4), (1, 4))}
    lt, rt = (torch.from_numpy(u8_to_brightness(x)).to(dev) for x in (left_u8, right_u8))
    lp, rp = (torch.from_numpy(x).to(dev).to(torch.int32) for x in (left_u8, right_u8))

    def as_pixels(x):
        """A loader batch (brightness) -> its 0..255 int32 pixel blocks."""
        return Sharded(x.mesh, x.shape, PLANE, [(b * 256).to(torch.int32) for b in x.blocks])

    mparams = ModernParams(num_disparities=SHIFTS, aggregation="sgm", cost="census",
                           sgm_directions=4)
    bparams = ModernParams(num_disparities=SHIFTS)
    cases = [("classic ghost/exact", (2, 4), StereoParams(num_shifts=SHIFTS,
              mode=BoundaryMode.GHOST, edge_rule="exact"), build_sharded_pipeline, ClassicPipeline),
             ("classic wrap/reference", (2, 4), StereoParams(num_shifts=SHIFTS,
              mode=BoundaryMode.WRAP, edge_rule="reference"), build_sharded_pipeline,
              ClassicPipeline),
             ("SGM", (1, 4), mparams, build_sharded_modern_pipeline, ModernPipeline),
             ("box", (1, 4), bparams, build_sharded_modern_pipeline, ModernPipeline)]
    wants = {"classic": lambda p: {"match_and_score_prehalo": 1,
                                   "fill_web_holes_step": p.times - 1},
             "SGM": lambda p: {"sgm_volume": 1, "sgm_directional": 2 + 2 * 4, "sgm_tail": 1,
                               "fill_invalid_step": 16},
             "box": lambda p: {"disparity": 2, "fill_invalid_step": 16}}

    def hold_blocks(label, route, got, ref):
        check(sorted(got) == sorted(ref), f"[35] {label} {route}: keys {sorted(got)}")
        for k, v in ref.items():
            check(all(same(a, b) for a, b in zip(got[k].blocks, v.blocks)),
                  f"[35 sharded io] {label} {route}: a block of {k} differs from the "
                  f"global-fed route's")

    def hold_global(label, got, single):
        check(sorted(got) == sorted(single), f"[35] {label}: keys {sorted(got)}")
        for k, v in outputs_to_global(got).items():
            check(same(v, single[k]), f"[35 sharded io] {label}: {k} after to_global differs "
                  f"from the single-device pipeline")

    notes, times = [], {}
    for label, shape, p, build, single_cls in cases:
        mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        kind = label.split()[0]
        ins = (lt, rt) if kind == "classic" else (lp, rp)
        lb, rb = loaded[shape][:2] if kind == "classic" else map(as_pixels, loaded[shape][:2])
        placed = [Sharded.from_global(x, mesh) for x in ins]
        for x, y in zip(placed, (lb, rb)):
            check(all(same(a, b) for a, b in zip(x.blocks, y.blocks)),
                  f"[35 sharded io] {label}: a loader block differs from from_global's")
        fn = build(p, mesh)
        single_pipe = single_cls(p)
        gfed, g_counts = counted(lambda: fn(*ins))
        bfed, b_counts = counted(lambda: fn(*placed))
        lfed, l_counts = counted(lambda: fn(lb, rb))
        want = wants[kind](p)
        for route, counts in (("global-fed", g_counts), ("block-fed", b_counts),
                              ("loader-fed", l_counts)):
            check(counts == want, f"[35 sharded io] {label} {route} launches {counts}, "
                  f"want {want}")
        hold_blocks(label, "block-fed", bfed, gfed)
        hold_blocks(label, "loader-fed", lfed, gfed)
        hold_global(label, gfed, single_pipe(*ins))
        del gfed, bfed, lfed
        times[label] = {
            "block_fed_sharded_out": cuda_time_ms(lambda: fn(*placed), 3) / BATCH,
            "global_fed_to_global": cuda_time_ms(
                lambda: outputs_to_global(fn(*ins)), 3) / BATCH,
            "single_device": cuda_time_ms(lambda: single_pipe(*ins), 3) / BATCH}
        notes.append(f"{label} ({'x'.join(map(str, shape))}): launches {b_counts}")
    del loaded, placed

    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        p = cases[0][2]
        mesh = make_mesh(data=1, rows=n_gpu)
        fn = build_sharded_pipeline(p, mesh)
        placed = [Sharded.from_global(x, mesh) for x in (lt, rt)]
        check([b.device for b in placed[0].blocks] == [d for d, _ in mesh.blocks[2]],
              "[35] placed blocks are not on their own GPUs")
        gfed, bfed = fn(lt, rt), fn(*placed)
        hold_blocks(f"classic over {n_gpu} GPUs", "block-fed", bfed, gfed)
        hold_global(f"classic over {n_gpu} GPUs", gfed, ClassicPipeline(p)(lt, rt))
        times[f"classic ghost/exact over {n_gpu} GPUs (rows {n_gpu})"] = {
            "block_fed_sharded_out": cuda_time_ms(lambda: fn(*placed), 3) / BATCH,
            "global_fed_to_global": cuda_time_ms(
                lambda: outputs_to_global(fn(lt, rt)), 3) / BATCH}
        multi = f"the classic case over {n_gpu} GPUs (rows {n_gpu}, a thread per GPU): equal"
        del gfed, bfed, placed
    else:
        multi = (f"the classic case over several GPUs not run: {n_gpu} GPU visible (the "
                 f"hardware is absent; the 4-GPU tools cover it)")
    print(f"[35 sharded io] {BATCH}x{SIZE}x{SIZE}, D={SHIFTS}, meshes of {dev}: fed by global "
          f"batches, by Sharded.from_global and by BatchLoader(mesh=...) over {BATCH} of phase "
          f"28's PNG pairs: every output block of the block-fed routes == the global-fed "
          f"route's, every output after to_global == the single-device pipeline bitwise; "
          f"{'; '.join(notes)}; {multi}; {smi}: ms/pair (block-fed, outputs on their shards / "
          f"global-fed with to_global / single device) "
          + "; ".join(f"{k} " + " / ".join(f"{v:.4f}" for v in t.values())
                      for k, t in times.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"sharded_io": {"ms_per_pair": times, "batch": BATCH, "size": SIZE,
                                     "card": smi}}), flush=True)


# Phase 36's sizes: the sweep tool's 8K rung (its batch there is 4) and
# Middlebury 2005's full resolution at BASELINE.json configs[2]'s 256
# disparities, whose batch of 8 puts the SGM volume past 2^31 elements.
FULL_SIZE = (7680, 4320)
MB_H, MB_W, MB_D, MB_BATCH = 1110, 1390, 256, 8
# Phase 36's classic matchers past D 200: (D, square width), at the card's
# shared-memory limit for sw 255 (D 1952) among them.
BIG_SHIFTS = [(d, sw) for d in (256, 1024, 1952) for sw in (255, 21)]


def full_sizes_phase(dev, smi: str) -> None:
    """Phase 36: the port at the sizes the JAX package runs.  (a) The
    classic pipeline at 7680x4320, batch 4 (the size-sweep tool's batch
    there): ghost with the exact rule (K1, K2, contour) and wrap with the
    reference rule (torch edges, K8, K2), every artifact against the plain
    route on the card, and K9 on the blocks of a rows 4 mesh of the card
    against its plain version; then ``tools/size_sweep_torch.py`` over its whole
    ladder at one iteration, its 8K checksum against the plain route's
    sum of the same four planes on the same inputs.  (b) The modern
    pipeline at 1110x1390 (Middlebury 2005's full size), D 256, batch 8
    (an SGM volume of 3.16 G elements, past 2^31), with the LR check and
    the sub-pixel plane: the box route (SAD, window 9: K7 twice, K6), SGM
    (census, 4 paths: K3, K4 x 4, K5, K6) and the 8-direction stack with
    median and uniqueness (K4 x 8, K5 with the second best) on textured
    scenes shifted by known disparities, each image's planes against the
    plain route run on that image alone, and the disparity against the
    shift.  (c) K1, K8 and K9 (on a rows 2 mesh of the card) at D 256,
    1024 and 1952, sw 255 and 21, on rows wider than D (both modes) and
    narrower (wrap), against their plain versions.  Tolerance 0
    everywhere, launch counts checked.  Prints one line, each kernel's
    time at these shapes beside its bound, and a ``{"full_sizes": ...}``
    line."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch

    from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
    from stereomatching_tpu_torch.models import classic, modern
    from stereomatching_tpu_torch.ops import costvolume, fused, fused_diffusion, fused_modern
    from stereomatching_tpu_torch.ops import fused_census, fused_sgm
    from stereomatching_tpu_torch.parallel import Sharded, make_mesh
    from stereomatching_tpu_torch.parallel.mesh import run as run_blocks
    from stereomatching_tpu_torch.parallel.mesh import shard_extent
    from stereomatching_tpu_torch.parallel.pipeline import prehalo_blocks
    from stereomatching_tpu_torch.utils import bench
    from stereomatching_tpu_torch.utils.synthetic import textured_shift

    t_phase = time.perf_counter()
    sweep_tool = load_tool("size_sweep_torch")
    rng = np.random.default_rng(SEED + 36)
    wrappers = {"match_score_edges": fused.match_score_edges,
                "match_and_score": fused.match_and_score,
                "match_and_score_prehalo": fused.match_and_score_prehalo,
                "fill_web_holes_range": fused_diffusion.fill_web_holes_range,
                "sgm_volume": fused_sgm.sgm_volume,
                "sgm_directional": fused_sgm.sgm_directional,
                "sgm_tail": fused_sgm.sgm_tail,
                "fill_invalid": fused_diffusion.fill_invalid,
                "disparity": fused_modern.disparity,
                "census": fused_census.census}

    def counted(fn):
        """-> (fn(), {wrapper: launches during it}), counted from zero."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items() if w.launches}

    def hold(what, got, want):
        """Every output of ``got`` bitwise its plain ``want``."""
        check(sorted(got) == sorted(want), f"[36] {what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            check(same(got[k], want[k]), f"[36 full sizes] {what}: {k} differs from the plain "
                  f"route (max |d| {max_abs_diff(got[k], want[k])})")

    def peak_mib():
        return torch.cuda.max_memory_allocated(dev) / 2**20

    configs, times = [], {}

    def k9_kwargs(mesh, left, right, p):
        """K9's keyword arguments on the blocks the sharded classic slice
        gives it on ``mesh`` (every shard on the card: one block)."""
        bl, hs, ws = shard_extent(tuple(left.shape), mesh)
        lb, rb = (Sharded.from_global(x, mesh).blocks[0] for x in (left, right))
        return run_blocks(mesh, bl, hs, ws, lambda sh: prehalo_blocks(sh, lb, rb, p)[2])[0]

    def k9_bound(kw, w, p):
        """``k9_bound_ms`` of K9's call on the blocks ``kw``, ``w`` wide."""
        blocks, rows = kw["l_blk"].shape[:2]
        return bench.k9_bound_ms(kw["l_blk"].numel() + kw["r_blk"].numel(),
                                 blocks * (rows - 2 * kw["halo"]) * w, blocks * 2 * p.half * w,
                                 p.num_shifts)

    def kernel_time(key, fn, b, iters=2):
        """``fn``'s device ms (a warmup, then ``iters`` calls) beside
        ``b`` = (bound ms, what sets it)."""
        times[key] = {"ms": cuda_time_ms(fn, iters), "bound_ms": b[0], "bound_by": b[1]}

    # (a) The classic pipeline at 8K, batch 4, on the sweep tool's first
    # pair of that size.
    w8, h8 = FULL_SIZE
    b8 = sweep_tool.batch_for(w8, h8)
    check(b8 == 4, f"the sweep tool's batch at 8K is {b8}")
    lt, rt = (torch.from_numpy(x).to(dev).to(torch.float32) / 256.0
              for x in sweep_tool.sweep_pairs(w8, h8, 1)[0])
    npix8 = b8 * w8 * h8
    for mode, rule in ((BoundaryMode.GHOST, "exact"), (BoundaryMode.WRAP, "reference")):
        p = StereoParams(num_shifts=SHIFTS, mode=mode, edge_rule=rule)
        pipe = classic.ClassicPipeline(p)
        torch.cuda.reset_peak_memory_stats(dev)
        got, counts = counted(lambda: pipe(lt, rt))
        peak = peak_mib()
        match = "match_score_edges" if rule == "exact" else "match_and_score"
        plan = fused_diffusion.k2_plan(p.times, classic.winner_bound(p))
        want = {match: 1, "fill_web_holes_range": plan.launches}
        check(counts == want, f"[36] classic 8K {mode.value}/{rule} launches {counts}, want {want}")
        ms = cuda_time_ms(lambda: pipe(lt, rt), 1) / b8
        plain = []
        plain_ms = cuda_time_ms(lambda: plain.append(classic.classic_forward_reference(lt, rt, p)),
                                1, warmup=False) / b8
        hold(f"classic {w8}x{h8} {mode.value}/{rule}", got, plain[0])
        del plain
        configs.append({"config": f"classic {mode.value}/{rule}", "shape": [b8, h8, w8],
                        "d": SHIFTS, "ms_per_pair": ms, "plain_ms_per_pair": plain_ms,
                        "peak_mib": peak, "plain_stages": classic.plain_stages(p),
                        "launches": counts})
        if rule == "exact":
            kernel_time("K1 match_score_edges 8K", lambda: fused.match_score_edges(lt, rt, p),
                        bench.k1_bound_ms(npix8, SHIFTS))
            win = got["web-1"]
            kernel_time("K2 fill_web_holes_range 8K", lambda: fused_diffusion.fill_web_holes_range(
                win, p.times, classic.winner_bound(p)), bench.k2_bound_ms(npix8, p.times))
        else:
            el, er = got["edges-1"], got["edges-2"]
            kernel_time("K8 match_and_score 8K", lambda: fused.match_and_score(el, er, p),
                        bench.k8_bound_ms(npix8, SHIFTS))
            # K9 on the blocks of a rows 4 mesh of the card: 4 x 1080-row
            # shards of each image under halos of 10 rows.
            kw = k9_kwargs(make_mesh(data=1, rows=4, devices=[dev] * 4), lt, rt, p)
            got9, counts = counted(lambda: fused.match_and_score_prehalo(params=p, **kw))
            check(counts == {"match_and_score_prehalo": 1}, f"[36] K9 8K launches {counts}")
            hold(f"K9 {w8}x{h8} rows 4 {mode.value}/{rule}", dict(enumerate(got9)),
                 dict(enumerate(fused.match_and_score_prehalo_reference(params=p, **kw))))
            kernel_time("K9 match_and_score_prehalo 8K rows 4", lambda: (
                fused.match_and_score_prehalo(params=p, **kw)), k9_bound(kw, w8, p))
            del kw, got9
        del got
    del lt, rt
    torch.cuda.empty_cache()

    # The size-sweep tool over its ladder, one timed iteration a size; the
    # 8K checksum against the plain route's on the same two batches.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ladder, counts = counted(lambda: sweep_tool.sweep(sweep_tool.SIZES, SHIFTS, 1, dev))
        plain8 = sweep_tool.run_size(w8, h8, SHIFTS, 1, dev, plain=True)
    check([r["size"] for r in ladder] == [f"{w}x{h}" for w, h in sweep_tool.SIZES]
          and all(r["route"] == "kernels" and r["device"] == str(dev) for r in ladder),
          f"[36] sweep tool records {ladder}")
    check(set(counts) == {"match_score_edges", "fill_web_holes_range"},
          f"[36] sweep tool launches {counts}")
    check(ladder[-1]["batch"] == b8 and ladder[-1]["checksum"] == plain8["checksum"],
          f"[36] sweep tool 8K checksum {ladder[-1]['checksum']} != the plain route's "
          f"{plain8['checksum']}")
    torch.cuda.empty_cache()

    # (b) 1110x1390, D 256, batch 8: the three modern routes on textured
    # scenes whose right image is the left one shifted by 17 + 30 i.
    shifts = [17 + 30 * i for i in range(MB_BATCH)]
    scenes = [textured_shift(MB_H, MB_W, s, seed=SEED + i) for i, s in enumerate(shifts)]
    left, right = (torch.from_numpy(np.stack([sc[k] for sc in scenes])).to(dev) for k in (0, 1))
    del scenes
    check(MB_BATCH * MB_H * MB_W * MB_D > 2**31, "the SGM volume stays under 2^31 elements")
    mb_npix = MB_BATCH * MB_H * MB_W
    routes = {
        "box SAD window 9": (ModernParams(num_disparities=MB_D, window=9, cost="sad"),
                             {"disparity": 2, "fill_invalid": 1}),
        "SGM census 4 paths": (ModernParams(num_disparities=MB_D, aggregation="sgm",
                                            cost="census"),
                               {"sgm_volume": 1, "sgm_directional": 4, "sgm_tail": 1,
                                "fill_invalid": 1, "census": 1}),
        "SGM census 8 paths, median, uniqueness": (
            ModernParams(num_disparities=MB_D, aggregation="sgm", cost="census",
                         sgm_directions=8, median_filter=True, uniqueness=True),
            {"sgm_volume": 1, "sgm_directional": 8, "sgm_tail": 1, "fill_invalid": 1,
             "census": 1}),
    }
    truth = []
    for name, (p, want) in routes.items():
        check(modern.plain_stages(p) == {}, f"[36] {name} runs {modern.plain_stages(p)} plain")
        torch.cuda.reset_peak_memory_stats(dev)
        got, counts = counted(lambda: modern.modern_forward(left, right, p))
        peak = peak_mib()
        check(counts == want, f"[36] {name} launches {counts}, want {want}")
        ms = cuda_time_ms(lambda: modern.modern_forward(left, right, p), 1) / MB_BATCH
        plain_ms = 0.0
        for i in range(MB_BATCH):
            plain = []
            plain_ms += cuda_time_ms(lambda: plain.append(modern.modern_forward_reference(
                left[i:i + 1], right[i:i + 1], p)), 1, warmup=False) / MB_BATCH
            hold(f"{name} image {i}", {k: v[i:i + 1] for k, v in got.items()}, plain[0])
            del plain
        # The left disparity against the shift, away from the borders the
        # window and the shift reach.
        disp = got["disparity"].cpu().numpy()
        hits = [float((disp[i, 16:-16, s + 16:-16] == s).mean()) for i, s in enumerate(shifts)]
        check(min(hits) >= 0.99, f"[36] {name}: true disparity on {hits}")
        truth.append(min(hits))
        configs.append({"config": name, "shape": [MB_BATCH, MB_H, MB_W], "d": MB_D,
                        "ms_per_pair": ms, "plain_ms_per_pair": plain_ms, "peak_mib": peak,
                        "plain_stages": modern.plain_stages(p), "launches": counts,
                        "true_disparity_share_min": min(hits)})
        if p.aggregation == "box":
            pix = [x.to(torch.int32) for x in (left, right)]
            kernel_time("K7 disparity 1.5MP", lambda: fused_modern.disparity(*pix, p, "left"),
                        bench.k7_bound_ms("sad", mb_npix, MB_D))
            del pix
            sub, valid = got["subpixel"], got["valid"]
            kernel_time("K6 fill_invalid 1.5MP", lambda: fused_diffusion.fill_invalid(
                sub, valid, p.fill_iterations),
                bench.k6_bound_ms(mb_npix, bench.k6_filled(valid, p.fill_iterations)))
            del sub, valid
        del got
    # K3, K4 (4 and 8 paths), K5 (with and without the second best) alone
    # on the SGM routes' volume.
    p = routes["SGM census 4 paths"][0]
    codes = [costvolume.census_transform(x.to(torch.int32)).contiguous() for x in (left, right)]
    vol = fused_sgm.sgm_volume(*codes, MB_D, "census", torch.int8)
    nvox = vol.numel()
    kernel_time("K3 sgm_volume 1.5MP", lambda: fused_sgm.sgm_volume(
        *codes, MB_D, "census", torch.int8), bench.k3_bound_ms(mb_npix, MB_D, 1, "census"))
    del codes
    for paths, uniq in ((4, False), (8, True)):
        agg = fused_sgm.sgm_aggregate_paths(vol, p.sgm_p1, p.sgm_p2, torch.int16, paths)
        kernel_time(f"K4 sgm_directional {paths} paths 1.5MP", lambda: fused_sgm.sgm_aggregate_paths(
            vol, p.sgm_p1, p.sgm_p2, torch.int16, paths), bench.k4_bound_ms(nvox, paths, 1, 2))
        kernel_time(f"K5 sgm_tail{' with the second best' if uniq else ''} 1.5MP",
                    lambda: fused_sgm.sgm_tail(agg, uniq),
                    bench.k5_bound_ms(mb_npix, MB_D, 2, uniq))
        del agg
    del vol, left, right
    torch.cuda.empty_cache()

    # (c) K1, K8 and K9 past D 200: 2 x 300 rows (K9: a rows 2 mesh of the
    # card, shards of 150 rows under halos of up to 127), rows D + 333
    # wide in both modes and narrower than D in wrap mode (D // 2 + 7, or
    # the square width where that is wider: the window fits the image).
    mesh = make_mesh(data=1, rows=2, devices=[dev] * 2)
    n_big = 0
    for d, sw in BIG_SHIFTS:
        for mode, w in ((BoundaryMode.GHOST, d + 333), (BoundaryMode.WRAP, d + 333),
                        (BoundaryMode.WRAP, max(d // 2 + 7, sw))):
            p = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
            pr = dataclasses.replace(p, edge_rule="reference")
            check(classic.classic_kernels_supported(p)[0], f"[36] K1 refuses D {d} sw {sw}")
            lt, rt = (torch.from_numpy(u8_to_brightness(rng.integers(0, 256, (2, 300, w),
                                                                     dtype=np.uint8))).to(dev)
                      for _ in range(2))
            el, er = (torch.from_numpy(rng.integers(0, 2, (2, 300, w), dtype=np.int32)).to(dev)
                      for _ in range(2))
            kw = k9_kwargs(mesh, lt, rt, pr)
            cfg = f"D {d} sw {sw} {mode.value} 2x300x{w}"
            cases = (("K1", "match_score_edges", lambda: fused.match_score_edges(lt, rt, p),
                      lambda: fused.match_score_edges_reference(lt, rt, p)),
                     ("K8", "match_and_score", lambda: fused.match_and_score(el, er, p),
                      lambda: fused.match_and_score_reference(el, er, p)),
                     ("K9", "match_and_score_prehalo",
                      lambda: fused.match_and_score_prehalo(params=pr, **kw),
                      lambda: fused.match_and_score_prehalo_reference(params=pr, **kw)))
            for kernel, name, call, plain_call in cases:
                got, counts = counted(call)
                check(counts == {name: 1}, f"[36] {kernel} {cfg} launches {counts}")
                want = plain_call()
                hold(f"{kernel} {cfg}", dict(enumerate(got)), dict(enumerate(want)))
                n_big += 1
            if d == 1952 and mode == BoundaryMode.WRAP and w > d:
                npix = lt.numel()
                tag = f"D 1952 sw {sw} wrap 2x300x{w}"
                kernel_time(f"K1 match_score_edges {tag}", cases[0][2],
                            bench.k1_bound_ms(npix, d))
                kernel_time(f"K8 match_and_score {tag}", cases[1][2], bench.k8_bound_ms(npix, d))
                kernel_time(f"K9 match_and_score_prehalo {tag}", cases[2][2], k9_bound(kw, w, pr))
            del lt, rt, el, er, kw
    torch.cuda.empty_cache()

    print(f"[36 full sizes] {smi}: classic {w8}x{h8} batch {b8} (ghost/exact, wrap/reference): "
          f"every artifact == the plain route bitwise (K9 on rows 4 blocks too), "
          + ", ".join(f"{c['config']} {c['ms_per_pair']:.4f} ms/pair (plain "
                      f"{c['plain_ms_per_pair']:.4f}, peak {c['peak_mib']:.0f} MiB)"
                      for c in configs[:2])
          + f"; tools/size_sweep_torch.py over {len(ladder)} sizes at 1 iteration: "
          + ", ".join(f"{r['size']} x{r['batch']} {r['ms_per_pair']:.4f}" for r in ladder)
          + f" ms/pair, 8K checksum {ladder[-1]['checksum']} == the plain route's; "
          f"{MB_H}x{MB_W}, D {MB_D}, batch {MB_BATCH} ({MB_BATCH * MB_H * MB_W * MB_D} volume "
          f"elements): every plane of each image == the plain route bitwise, "
          + ", ".join(f"{c['config']} {c['ms_per_pair']:.4f} ms/pair (plain "
                      f"{c['plain_ms_per_pair']:.4f}, peak {c['peak_mib']:.0f} MiB, true "
                      f"disparity on >= {c['true_disparity_share_min']:.4%})"
                      for c in configs[2:])
          + f"; K1, K8, K9 at (D, sw) {', '.join(map(str, BIG_SHIFTS))} x 3 row widths: {n_big} "
          f"cases == plain bitwise; {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"full_sizes": {"card": smi, "configs": configs, "kernels": times,
                                     "size_sweep": ladder, "size_sweep_plain_8k": plain8}}),
          flush=True)


def census_phase(dev, smi: str) -> dict:
    """Phase 37: K10, the census of both views in one launch, at the SGM
    cells' size, 1110 x 1390, batch 8 and batch 1: int32 pixels 0..255
    (what the benchmark's SGM route sends) and full-range int32 at window
    5, and int32 pixels at window 3.  Both views' codes bitwise the plain
    version's on the card, one launch a call; card ms and the plain
    version's ms a pair beside the bound (``utils/bench.py``
    ``k10_bound_ms``: 0.0133 ms a pair at window 5).  Prints one line and
    a ``{"k10": ...}`` line -> the kernel table's row (batch 8, int32
    pixels, window 5) with ``max_abs_err``, the largest |code - plain
    code| over every case."""
    import torch

    from stereomatching_tpu_torch.ops import fused_census
    from stereomatching_tpu_torch.utils.bench import k10_bound_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    rows, err = [], 0
    for batch in (MB_BATCH, 1):
        pix = [torch.randint(0, 256, (batch, MB_H, MB_W), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(2)]
        full = [torch.randint(-2**31, 2**31 - 1, (batch, MB_H, MB_W), generator=gen,
                              device=dev, dtype=torch.int32) for _ in range(2)]
        cases = (("int32 pixels", pix, 5), ("int32 full range", full, 5),
                 ("int32 pixels", pix, 3))
        for what, (x, y), window in cases:
            before = fused_census.census.launches
            got = fused_census.census(x, y, window)
            torch.cuda.synchronize()
            check(fused_census.census.launches == before + 1,
                  f"[37] K10 {what} batch {batch}: {fused_census.census.launches - before} "
                  f"launches, not 1")
            want = fused_census.census_reference(x, y, window)
            for view, g, r in zip(("left", "right"), got, want):
                err = max(err, max_abs_diff(g, r))
                check(g.dtype == torch.int32 and same(g, r),
                      f"[37] K10 {what} batch {batch} window {window}: the {view} codes differ "
                      f"from the plain version's")
            del got, want
            ms = cuda_time_ms(lambda: fused_census.census(x, y, window), 50)
            plain_ms = cuda_time_ms(lambda: fused_census.census_reference(x, y, window), 5)
            bound_ms, bound_by = k10_bound_ms(batch * MB_H * MB_W, window)
            rows.append({"batch": batch, "input": what, "window": window,
                         "ms_per_pair": ms / batch, "plain_ms_per_pair": plain_ms / batch,
                         "bound_ms_per_pair": bound_ms / batch, "bound_by": bound_by,
                         "share_of_bound_pct": 100 * bound_ms / ms, "bitwise": True})
    print(f"[37 K10] {smi}: census of both views at {MB_H}x{MB_W}, one launch a call, bitwise "
          "the plain version: " + "; ".join(
              f"batch {r['batch']} {r['input']} w{r['window']} {r['ms_per_pair']:.5f} ms/pair "
              f"(plain {r['plain_ms_per_pair']:.4f}, bound {r['bound_ms_per_pair']:.5f}, "
              f"{r['share_of_bound_pct']:.1f}%)" for r in rows), flush=True)
    print(json.dumps({"k10": rows, "card": smi}))
    return {**rows[0], "max_abs_err": err}


def timing_line(stdout: str):
    """The reference's timing line of a SIZE x SIZE pair at the end of
    ``stdout`` as a match (elapsed in group 1), or None."""
    lines = stdout.strip().splitlines()
    return re.match(rf"^width = {SIZE}, height = {SIZE}, t1 = [\d.]+, t2 = [\d.]+, "
                    r"elapsed = ([\d.]+)$", lines[-1]) if lines else None


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
        costvolume, fused, fused_census, fused_diffusion, fused_modern, fused_sgm, sgm)
    from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
    from stereomatching_tpu_torch.utils.bench import (
        HBM_BYTES_PER_S, INT32_OPS_PER_S, K2_BENCH_KERNELS, K3_BENCH_KERNELS, K5_BENCH_KERNELS,
        K7_BENCH_KERNELS, K7_SWEEP, bound, k1_bound_ms,
        k2_bound_ms, k3_bound_ms, k4_bound_ms, k5_bound_ms, k6_bound_ms, k6_filled, k7_bound_ms,
        k8_bound_ms, k9_bound_ms)
    from stereomatching_tpu_torch.utils import native
    from stereomatching_tpu_torch.utils.build import build_all

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # Phase 2: build all nine kernel sources of the checkout, one nvcc
    # per source, and the host codec (stereo_io.cpp, host C++ compiler), all
    # started together.
    t0 = time.perf_counter()
    sources = ["match_score_edges", "fill_web_holes", "sgm_volume", "sgm_directional",
               "sgm_tail", "fill_invalid", "disparity", "match_and_score", "census"]
    build_all([*sources, "stereo_io"])
    fused._lib("match_score_edges")
    fused._lib("match_and_score")
    fused_diffusion._lib("fill_web_holes")
    fused_diffusion._lib("fill_invalid")
    for name in ("sgm_volume", "sgm_directional", "sgm_tail"):
        fused_sgm._lib(name)
    fused_modern._lib()
    fused_census._lib()
    codec = native.library_name()
    print(f"[2 build] {', '.join(s + '.cu' for s in sources)} and stereo_io.cpp ({codec}) "
          f"built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

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
                    "fill_invalid": fused_diffusion.fill_invalid,
                    "census": fused_census.census}
    for fn in sgm_wrappers.values():
        fn.launches = 0
    out = mmatcher(left_u8, right_u8)
    launches.update({name: fn.launches for name, fn in sgm_wrappers.items()})
    for name in sgm_wrappers:
        check(launches[name] > 0, f"the SGM path never launched {name}")
    check(launches["census"] == 1, f"K10 launches {launches['census']} on the SGM slice, not 1")
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
            "fill_invalid": fused_diffusion.k6_plan(16).launches, "census": 0}
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
            "fill_invalid": fused_diffusion.k6_plan(16).launches, "census": 1}
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

    def run_cli(*args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "stereomatching_tpu_torch.cli", *args],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"CLI {args[2:]} exited {res.returncode}: {res.stderr[-2000:]}")
        m = timing_line(res.stdout)
        check(m is not None, f"CLI timing line in {res.stdout[-300:]!r}")
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
            "fill_invalid": fused_diffusion.k6_plan(16).launches, "census": 2}
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
        Sharded, build_sharded_modern_pipeline, build_sharded_pipeline, make_mesh)
    from stereomatching_tpu_torch.parallel.mesh import run as run_blocks
    from stereomatching_tpu_torch.parallel.mesh import shard_extent
    from stereomatching_tpu_torch.parallel.pipeline import prehalo_blocks

    def card_mesh(data, rows, cols=None):
        return make_mesh(data=data, rows=rows, cols=cols,
                         devices=[dev] * (data * rows * (cols or 1)))

    def k9_inputs(mesh, left, right, params):
        """K9's keyword arguments on the blocks the sharded classic
        slice gives it (one block: every shard on cuda:0)."""
        bl, hs, ws = shard_extent(tuple(left.shape), mesh)
        lb, rb = (Sharded.from_global(x, mesh).blocks[0] for x in (left, right))
        return run_blocks(mesh, bl, hs, ws, lambda sh: prehalo_blocks(sh, lb, rb, params)[2])[0]

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
          "fill_invalid": 0, "fill_invalid_step": 16, "census": 0}),
        ("8-direction", qparams, SGM8_TRUTH_SHARE, SHIFTS,
         {"disparity": 0, "sgm_volume": 1, "sgm_directional": 2 + 3 * 2 * 4, "sgm_tail": 1,
          "fill_invalid": 0, "fill_invalid_step": 16, "census": 0}),
        ("box", bparams, BOX_TRUTH_SHARE, SHIFTS + bparams.window // 2,
         {"disparity": 2, "sgm_volume": 0, "sgm_directional": 0, "sgm_tail": 0,
          "fill_invalid": 0, "fill_invalid_step": 16, "census": 0}),
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
    k4_sizes = (vol.element_size(), agg.element_size())
    del vol, agg
    # The byte floor of one pass per path, 4 and 8 paths: the first pass
    # written, the rest added (``k4_bound_ms``, which the bytes bind).
    k4_floors = {}
    for n in (4, 8):
        k4_floor = k4_bound_ms(nvox, n, *k4_sizes)
        check(k4_floor[1] == "bytes", f"K4's {n}-path bound is set by {k4_floor[1]}")
        k4_floors[f"floor_ms_{n}path"] = k4_floor[0]
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

    # Phases 28-30: the input and quality side at 1024², D=64.
    input_and_quality_phases(dev, smi, scenes_cli)
    # Phases 31-33: the measurement and cross-check side.
    measurement_phases(dev, smi, scenes_cli)
    # Phase 34: every kernel on every route at random configurations.
    random_routes_phase(dev, smi)
    # Phase 35: the sharded tier fed and read block by block.
    sharded_io_phase(dev, smi)
    # Phase 36: the sizes the JAX package runs.
    full_sizes_phase(dev, smi)
    # Phase 37: K10 at the SGM cells' size.
    k10 = census_phase(dev, smi)

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
    # K10 replaces no Pallas kernel (the JAX census is an XLA phase); its
    # launches are the SGM slice's (phase 8), its error and times phase
    # 37's, a batch of 8 at 1110 x 1390.
    table.append({"name": "census", "route": "cuda", "source": src + "census.cu",
                  "replaces": None, "launches": launches["census"],
                  "max_abs_err": k10["max_abs_err"],
                  "ms": k10["ms_per_pair"] * MB_BATCH,
                  "plain_ms": k10["plain_ms_per_pair"] * MB_BATCH,
                  "bound_ms": k10["bound_ms_per_pair"] * MB_BATCH, "bound_by": k10["bound_by"],
                  "library_ms": None, "shape": [MB_BATCH, MB_H, MB_W]})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
