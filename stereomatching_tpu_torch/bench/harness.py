"""Timing harness (counterpart of ``stereomatching_tpu/bench/harness.py``).

Reference analogues:
  * ``time_fn`` -- the reference's self-timed ``algorithm()`` body
    (src/stereo.c:297-324), after a warmup that keeps the kernels' first
    build and launch out of the measurement;
  * ``phase_timings`` -- the classic pipeline's stages timed one by one;
  * ``size_sweep`` -- test/time.sh:3-12's loop over the fixture sizes;
  * ``pixel_passes`` -- the thesis throughput model
    (test/make_graph.py:50-51): per-pixel algorithmic workload, used to
    report "billion pixel-passes per second" comparable across sizes.

Every entry runs on the card unless ``device="cpu"`` is asked for
(``utils.device.resolve_device``, which never falls back).  On a CUDA
device a call is timed with CUDA events around it; on the CPU with
``time.perf_counter``.  ``plain=True`` times the plain torch versions
that sit beside the kernels, on the same device, in place of the
kernels: the second series of ``graphs.times_graph``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stereomatching_tpu_torch.config import StereoParams
from stereomatching_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class BenchResult:
    name: str
    mean_s: float
    min_s: float
    std_s: float
    iters: int
    pixels: int = 0
    extra: Optional[Dict[str, float]] = None

    @property
    def pixels_per_s(self) -> float:
        return self.pixels / self.mean_s if self.pixels else 0.0

    def row(self) -> str:
        return (
            f"{self.name:<28} {self.mean_s * 1e3:9.3f} ms  "
            f"(min {self.min_s * 1e3:9.3f}, std {self.std_s * 1e3:7.3f})"
        )


def pixel_passes(params: StereoParams) -> int:
    """Per-pixel workload of one pipeline run (test/make_graph.py:51):
    4 edge ops x 2 images + D matches + sw^2 box adds + 2D score/argmax
    passes + 1 winner + `times` diffusion sweeps + 3 finishing passes."""
    return (
        4 * 2
        + params.num_shifts
        + params.square_width**2
        + params.num_shifts * 2
        + 1
        + params.times
        + 3
    )


def time_fn(
    fn: Callable,
    args: Tuple,
    iters: int = 5,
    warmup: int = 2,
    name: str = "fn",
    pixels: int = 0,
    device: str | torch.device = "cuda",
) -> BenchResult:
    """Time ``fn(*args)`` ``iters`` times after ``warmup`` calls: on a
    CUDA device each call between two CUDA events (read after one
    synchronise at the end), on the CPU by ``time.perf_counter``."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, stop in events:
            start.record()
            fn(*args)
            stop.record()
        torch.cuda.synchronize(dev)
        samples = [start.elapsed_time(stop) / 1e3 for start, stop in events]
    else:
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    arr = np.asarray(samples)
    return BenchResult(
        name=name,
        mean_s=float(arr.mean()),
        min_s=float(arr.min()),
        std_s=float(arr.std()),
        iters=iters,
        pixels=pixels,
    )


def _end_to_end(params: StereoParams, plain: bool) -> Callable:
    """``ClassicPipeline``, or with ``plain`` the route's stages chained
    through the kernels' plain versions (``roofline.classic_stages``; no
    pipeline module takes a switch for it)."""
    from stereomatching_tpu_torch.bench.roofline import classic_stages, run_stages
    from stereomatching_tpu_torch.models.classic import build_classic_pipeline

    if plain:
        stages = classic_stages(params, plain=True)
        return torch.no_grad()(lambda a, b: run_stages(stages, (a, b))[1])
    return build_classic_pipeline(params)


def tier_name(plain: bool, dev: torch.device) -> str:
    """What the kernel-backed stages run: their plain versions with
    ``plain`` or on the CPU (the wrappers' CPU route), else the kernels."""
    return "plain" if plain or dev.type == "cpu" else "kernels"


@torch.no_grad()
def phase_timings(
    left: np.ndarray,
    right: np.ndarray,
    params: StereoParams,
    iters: int = 5,
    device: str | torch.device = "cuda",
    plain: bool = False,
) -> List[BenchResult]:
    """Per-phase breakdown of the classic pipeline on one pair [H, W] of
    float brightness planes: the torch edge maps (per image), match + box
    + argmax (K8, ``ops.fused.match_and_score``), the diffusion (K2,
    ``ops.fused_diffusion.fill_web_holes_range``), the contour, and end
    to end through ``ClassicPipeline`` (K1, K2 and the contour with the
    exact rule).  Each phase is a stage of ``roofline.classic_stages``
    and runs alone on the previous stage's output, so the end-to-end time
    is not their sum.  With ``plain`` each kernel's plain version runs in
    its place."""
    from stereomatching_tpu_torch.bench.roofline import classic_stages, run_stages

    dev = resolve_device(device)
    tier = tier_name(plain, dev)
    h, w = left.shape
    px = h * w
    lb, rb = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for x in (left, right))
    stages = classic_stages(params, plain, edge_maps=True)
    inputs, _ = run_stages(stages, (lb, rb))
    rows = {"edges": ("edges (per image)", px),
            "match_and_score": (f"match+box+argmax ({tier})", px * params.num_shifts),
            "diffusion": (f"diffusion ({tier})", px * max(params.times - 1, 0)),
            "contour": ("contour", px)}
    results = [time_fn(stages[k], inputs[k], iters, name=name, pixels=pixels, device=dev)
               for k, (name, pixels) in rows.items()]
    # The edges stage maps both images: its row is per image.
    e = results[0]
    results[0] = dataclasses.replace(e, mean_s=e.mean_s / 2, min_s=e.min_s / 2, std_s=e.std_s / 2)
    results.append(time_fn(_end_to_end(params, plain), (lb, rb), iters,
                           name=f"end-to-end ({tier})", pixels=px * pixel_passes(params),
                           device=dev))
    return results


def size_sweep(
    sizes: Sequence[Tuple[int, int]],
    params: StereoParams,
    iters: int = 3,
    device: str | torch.device = "cuda",
    plain: bool = False,
    seed: int = 0,
) -> List[BenchResult]:
    """The reference's size-sweep measurement (test/time.sh over
    test/imgs/{1..5}-WxH) on random pairs of the given (H, W) sizes made
    from ``seed``, end to end (``ClassicPipeline``, or with ``plain`` the
    plain versions' chain).  Reports the thesis throughput model per size."""
    dev = resolve_device(device)
    fn = _end_to_end(params, plain)
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        left, right = (torch.from_numpy(rng.integers(0, 256, size=(h, w)).astype(np.float32)
                                        / np.float32(256.0)).to(dev) for _ in range(2))
        out.append(time_fn(fn, (left, right), iters, name=f"{w}x{h}",
                           pixels=h * w * pixel_passes(params), device=dev))
    return out
