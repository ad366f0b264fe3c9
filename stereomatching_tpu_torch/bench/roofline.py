"""Roofline accounting of the port's routes on the card (counterpart of
``stereomatching_tpu/bench/roofline.py``).

  * Per-pair phase models of the port's own routes: the bytes each phase
    must move (each input read once, each output written once) and the
    operations it must do, with the peak rate of their unit.  The kernels'
    phases are the ``*_work`` functions of ``utils/bench.py``, which
    ``chip_smoke.py`` holds the kernels against; the torch phases (edges,
    census, the LR check, the contour) are counted here.
  * The stage table (``classic_stages``, ``modern_stages``): each route's
    stages by the name of their phase model, one callable each, which the
    harness and ``tools/profile_torch_pipeline.py`` time too.
  * Phase timings with the checksum discipline: a distinct device-resident
    batch on every iteration, each output's last element summed on the
    device and read back once at the end, timed with CUDA events.
  * The verdict per phase: achieved GB/s and the least time the card
    could take, ``max(bytes / HBM peak, ops / their peak)``, beside the
    measured time, with the card's power limit (the published peaks
    assume the full 700 W).  A share of the bound above 100% raises: the
    model counts more work than the phase did.

The JAX module's ``mxu_util_pct``, ``vpu_util_pct``, ``instr_bound_ms``
and ``compute_ceiling_ms`` come from TPU probes (the matrix unit, the
vector unit's issue rate) and have no counterpart on the card; they are
left out.

The halo model (``halo_phase_model``, ``gather_phase_model``,
``weak_scaling_prediction``) prices the sharded tier's exchanges
(``parallel/pipeline.py``) at NVLink's one-way peak and a measured
exchange latency.

Usage:  python -m stereomatching_tpu_torch.bench.roofline [--pipeline sgm]
            [--batch 8] [--device cuda] [--json] [--ici]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu_torch.utils.bench import (
    FP32_OPS_PER_S, FP32_UNFUSED_OPS_PER_S, HBM_BYTES_PER_S, INT32_OPS_PER_S,
    NVLINK_BYTES_PER_S_EACH_WAY, POPC_PER_S, k1_work, k2_work, k3_work, k4_work, k5_work,
    k6_work, k8_work)
from stereomatching_tpu_torch.utils.device import resolve_device

Model = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class Peaks:
    """The card's peaks (``utils/bench.py``; NVIDIA's data sheet for the
    H100 SXM at its full 700 W).  ``verdict`` prices a model's bytes at
    the HBM rate and its operations at their unit's rate."""

    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    int32_ops_per_s: float = INT32_OPS_PER_S
    popc_per_s: float = POPC_PER_S
    fp32_ops_per_s: float = FP32_OPS_PER_S
    fp32_unfused_ops_per_s: float = FP32_UNFUSED_OPS_PER_S
    # NVLink 4: 900 GB/s in all, 450 GB/s each way; a shard's sends are
    # priced at the one-way rate.
    nvlink_bytes_per_s_each_way: float = NVLINK_BYTES_PER_S_EACH_WAY
    # The fixed cost of one exchange between two ranks (a NCCL send and
    # receive issued from Python and waited on), the softest number here:
    # not a data-sheet figure but a reading.  ``tools/multihost_smoke_torch.py
    # --procs 4`` on four NVIDIA H100 80GB HBM3 (700 W) of one host, joined
    # by NVLink, read 197.0-198.8 us a round of a 1024-wide int32 row on
    # its ranks (144.2 with 2 ranks).  It dominates the diffusion's 1-row
    # exchanges.
    exchange_latency_us: float = 198.0


# Operations per pixel of the torch phases (none of them a kernel of this
# repository), each a floor: a divide or a remainder counts as one.
# The reference rule's edges, per image: per operator 4 adds, 3 divides,
# an add, a multiply, a clamp (2), a subtract, an absolute value, a compare
# and the or; four operators, float32 in the C order (no contraction).
EDGE_OPS = 4 * 15
# The 5x5 census, per image: 24 compares, 24 shifts and 24 ors.
CENSUS_OPS = 3 * 24
# The LR check: the target column, two range tests, the gather, the
# select, the difference, its absolute value and the compare.
LR_OPS = 8
# The contour's bands: subtract, convert, divide, floor, convert,
# multiply, subtract, three compares, two ors.
CONTOUR_OPS = 12


# The Peaks field of each unit's rate, by the rate ``utils/bench.py``'s
# ``*_work`` gives.
_UNITS = {INT32_OPS_PER_S: "int32_ops_per_s", POPC_PER_S: "popc_per_s",
          FP32_OPS_PER_S: "fp32_ops_per_s", FP32_UNFUSED_OPS_PER_S: "fp32_unfused_ops_per_s"}


def _model(nbytes: float, ops: float, ops_per_s: float) -> Model:
    """{"bytes": ..., "ops": {Peaks field of the ops' unit: count}}."""
    return {"bytes": float(nbytes), "ops": {_UNITS[ops_per_s]: float(ops)}}


def _total(models: Sequence[Model]) -> Model:
    """A route's model: the bytes and the operations (by unit) of its
    phases."""
    ops: Dict[str, float] = {}
    for m in models:
        for unit, n in m["ops"].items():
            ops[unit] = ops.get(unit, 0.0) + n
    return {"bytes": sum(m["bytes"] for m in models), "ops": ops}


def ops_seconds(model: Model, peaks: Peaks = Peaks()) -> float:
    """The least time of a model's operations, each unit's at its peak."""
    return sum(n / getattr(peaks, unit) for unit, n in model["ops"].items())


def classic_phase_models(params: StereoParams, h: int, w: int) -> Dict[str, Model]:
    """Per-PAIR models of the classic routes at [h, w]: the exact rule's
    K1 (``match_score_edges``), K2 (``diffusion``) and ``contour``
    (``end_to_end``); the reference rule's torch ``edges``, K8
    (``match_and_score``), K2 and the contour (``end_to_end_reference``).
    Each model: bytes, and operations by the Peaks field of their unit's
    rate."""
    npix = h * w
    d = params.num_shifts
    phases = {
        # Two float32 brightness planes in, two int32 edge maps out.
        "edges": _model(16 * npix, 2 * EDGE_OPS * npix, FP32_UNFUSED_OPS_PER_S),
        "match_score_edges": _model(*k1_work(npix, d)),
        "match_and_score": _model(*k8_work(npix, d)),
        "diffusion": _model(*k2_work(npix, params.times)),
        # The web in, the bands out (the range comes from K2).
        "contour": _model(8 * npix, CONTOUR_OPS * npix, FP32_UNFUSED_OPS_PER_S),
    }
    phases["end_to_end"] = _total(
        [phases[k] for k in ("match_score_edges", "diffusion", "contour")])
    phases["end_to_end_reference"] = _total(
        [phases[k] for k in ("edges", "match_and_score", "diffusion", "contour")])
    return phases


def _sgm_dtypes(params: ModernParams):
    from stereomatching_tpu_torch.models.modern import _sgm_out_dtype, _sgm_storage_dtype

    return _sgm_storage_dtype(params), _sgm_out_dtype(params)


def sgm_phase_models(params: ModernParams, h: int, w: int,
                     filled: float = 0.0) -> Dict[str, Model]:
    """Per-PAIR models of the SGM route at [h, w]: the torch ``census``
    of both images, K3 (``volume``), K4 (``aggregation``, one pass per
    path), K5 (``tail``), the torch ``lr_check``, K6 (``fill``, on the
    ``filled`` cells a pair's plane turns valid, ``utils.bench.k6_filled``)
    and ``end_to_end``."""
    npix = h * w
    d = params.num_disparities
    vb, ab = (torch.tensor([], dtype=t).element_size() for t in _sgm_dtypes(params))
    phases = {
        # int32 pixels in, int32 codes out, both images.
        "census": _model(16 * npix, 2 * CENSUS_OPS * npix, INT32_OPS_PER_S),
        "volume": _model(*k3_work(npix, d, vb, params.cost)),
        "aggregation": _model(*k4_work(npix * d, params.sgm_directions, vb, ab)),
        "tail": _model(*k5_work(npix, d, ab, params.uniqueness)),
        # Two int32 disparity planes in, the bool mask out.
        "lr_check": _model(9 * npix, LR_OPS * npix, INT32_OPS_PER_S),
        "fill": _model(*k6_work(npix, filled)),
    }
    phases["end_to_end"] = _total(list(phases.values()))
    return phases


def card(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit (``nvidia-smi``), or the CPU's
    place-holders, for every line that carries a share."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    idx = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout
    name, limit = (x.strip() for x in out.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": limit}


def verdict(name: str, seconds_per_pair: float, model: Model, peaks: Peaks = Peaks(),
            power_limit: Optional[str] = None) -> Dict[str, object]:
    """The roofline verdict of one phase: ms/pair, bytes, operations,
    achieved GB/s, the bound (the larger of bytes over the HBM peak and
    operations over their unit's peak), which of the two sets it, the
    share of the bound reached and its inverse, and the power limit the
    time was taken at.  Raises when the share exceeds 100%: the model
    counts more than the phase did."""
    t_bytes = model["bytes"] / peaks.hbm_bytes_per_s
    t_ops = ops_seconds(model, peaks)
    bound = max(t_bytes, t_ops)
    share = bound / seconds_per_pair * 100
    if share > 100:
        raise ValueError(f"{name}: {seconds_per_pair * 1e3:.6f} ms/pair is below its bound "
                         f"{bound * 1e3:.6f} ms ({share:.1f}%): the model's count is wrong")
    return {
        "phase": name,
        "ms_per_pair": seconds_per_pair * 1e3,
        "mbytes": model["bytes"] / 1e6,
        "gops": sum(model["ops"].values()) / 1e9,
        "achieved_gbps": model["bytes"] / seconds_per_pair / 1e9,
        "bound_ms": bound * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "share_of_bound_pct": share,
        "x_from_bound": seconds_per_pair / bound if bound > 0 else 0.0,
        "power_limit": power_limit,
    }


def _time_checksum(fn: Callable, inputs: List, device: torch.device) -> float:
    """Seconds per call of ``fn`` (-> a scalar tensor) over the distinct
    device-resident ``inputs[1:]`` after a warmup on ``inputs[0]``: the
    checksums summed on the device, one readback at the end; CUDA events
    around the loop on a card, ``perf_counter`` on the CPU."""
    float(fn(*inputs[0]))  # warmup: the kernels' build and first launch
    iters = len(inputs) - 1
    acc = torch.zeros((), dtype=torch.float64, device=device)
    if device.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for args in inputs[1:]:
            acc += fn(*args)
        stop.record()
        float(acc)
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for args in inputs[1:]:
        acc += fn(*args)
    float(acc)
    return (time.perf_counter() - t0) / iters


def checksum(*planes: torch.Tensor) -> torch.Tensor:
    """The planes' last elements, summed: the readback depends on every
    plane's kernel while adding no pass over the planes to the timed
    phase (a full sum of the SGM volume took ten times K3's time)."""
    return sum(p.reshape(-1)[-1].to(torch.float64) for p in planes)


def _batches(rng, n: int, batch: int, h: int, w: int, device: torch.device):
    """``n`` distinct pairs of uint8 batches [batch, h, w] on ``device``."""
    return [tuple(torch.from_numpy(rng.integers(0, 256, (batch, h, w), dtype=np.uint8)).to(device)
                  for _ in range(2)) for _ in range(n)]


# ----------------------------------------------------------- the stage table

# A route's stages in forward order, by the name of their phase model: each
# takes the previous stage's outputs (the first, the route's pair of
# batches) and returns its own as a tuple.  ``measure``, ``measure_sgm``,
# ``harness.phase_timings`` and ``tools/profile_torch_pipeline.py`` time
# them.
Stages = Dict[str, Callable[..., Tuple[torch.Tensor, ...]]]

# The kernel each stage launches; the other stages are torch ops.
KERNEL_OF = {"match_score_edges": "K1", "match_and_score": "K8", "diffusion": "K2",
             "volume": "K3", "aggregation": "K4", "tail": "K5", "fill": "K6",
             "disparity_left": "K7", "disparity_right": "K7"}


def classic_stages(params: StereoParams, plain: bool = False,
                   edge_maps: Optional[bool] = None) -> Stages:
    """The classic route's stages on a pair of brightness batches.  The
    exact rule: K1 (``match_score_edges``), K2 (``diffusion``) and the
    ``contour``; the reference rule, or any rule with ``edge_maps``: the
    torch ``edges`` of both images under the params' rule, K8
    (``match_and_score``), K2 and the contour.  ``plain``: each kernel's
    plain version in its place."""
    from stereomatching_tpu_torch.models.classic import winner_bound
    from stereomatching_tpu_torch.ops import fused, fused_diffusion
    from stereomatching_tpu_torch.ops.contour import contour_bands
    from stereomatching_tpu_torch.ops.edges import find_edges

    def edges(a, b):
        return tuple(find_edges(x, params.threshold, params.mode, params.edge_rule)
                     for x in (a, b))

    if plain:
        def k1(a, b):
            return fused.match_score_edges_reference(a, b, params)[1:2]

        def k8(el, er):
            return fused.match_and_score_reference(el, er, params)[1:2]

        def k2(winner):
            return fused_diffusion.fill_web_holes_range_reference(winner, params.times)
    else:
        def k1(a, b):
            return fused.match_score_edges(a, b, params)[1:2]

        def k8(el, er):
            return fused.match_and_score(el, er, params)[1:2]

        def k2(winner):
            return fused_diffusion.fill_web_holes_range(winner, params.times,
                                                        winner_bound(params))

    def contour(web, mn, mx):
        return (contour_bands(web, params.lines, mn, mx),)

    if edge_maps is None:
        edge_maps = params.edge_rule == "reference"
    head = {"edges": edges, "match_and_score": k8} if edge_maps else {"match_score_edges": k1}
    return {**head, "diffusion": k2, "contour": contour}


def modern_stages(params: ModernParams) -> Stages:
    """The modern route's stages (``scales=1``) on a pair of int32 pixel
    batches, in ``modern_forward``'s order: with the census cost the
    torch ``census`` of both images; then SGM's K3 (``volume``), K4
    (``aggregation``), K5 (``tail``) and, with ``uniqueness``, the torch
    ratio, or the box route's K7 for each view (``disparity_left``,
    ``disparity_right``); then, with ``median_filter``, the torch
    ``median``, the torch ``lr_check`` and K6 (``fill``).  Planes a later
    stage needs pass through the stages between."""
    from stereomatching_tpu_torch.models.modern import _uniqueness_ratio
    from stereomatching_tpu_torch.ops import costvolume, fused_modern
    from stereomatching_tpu_torch.ops.fused_diffusion import fill_invalid
    from stereomatching_tpu_torch.ops.fused_sgm import sgm_aggregate_paths, sgm_tail, sgm_volume

    d = params.num_disparities
    stages: Stages = {}
    if params.cost == "census":
        stages["census"] = lambda a, b: tuple(
            costvolume.census_transform(x, params.census_window).contiguous() for x in (a, b))
    if params.aggregation == "sgm":
        st, odt = _sgm_dtypes(params)

        def tail(agg):
            disp, sub, cost, dr, *second = sgm_tail(agg, params.uniqueness)
            return (disp, sub, dr, cost, *second)

        stages["volume"] = lambda a, b: (sgm_volume(a, b, d, params.cost, st),)
        stages["aggregation"] = lambda v: (sgm_aggregate_paths(
            v, params.sgm_p1, params.sgm_p2, odt, params.sgm_directions),)
        stages["tail"] = tail
        if params.uniqueness:
            stages["uniqueness"] = lambda disp, sub, dr, cost, second: (
                disp, sub, dr, _uniqueness_ratio(second, cost))
    else:
        def left(a, b):
            dl = fused_modern.disparity(a, b, params, "left")
            return a, b, dl.disparity, dl.subpixel

        stages["disparity_left"] = left
        stages["disparity_right"] = lambda a, b, disp, sub: (
            disp, sub, fused_modern.disparity(b, a, params, "right").disparity)
    if params.median_filter:
        stages["median"] = lambda disp, sub, dr, *rest: (
            *(costvolume.median3x3(x) for x in (disp, sub, dr)), *rest)
    stages["lr_check"] = lambda disp, sub, dr, *rest: (
        sub, costvolume.lr_consistency(disp, dr, params.lr_max_diff, d))
    stages["fill"] = lambda sub, valid: (fill_invalid(sub, valid, params.fill_iterations),)
    return stages


def run_stages(stages: Stages, first: Tuple) -> Tuple[Dict[str, Tuple], Tuple]:
    """The stages in order from ``first`` -> (each stage's inputs, the
    last stage's outputs)."""
    inputs, x = {}, first
    for name, fn in stages.items():
        inputs[name] = x
        x = fn(*x)
    return inputs, x


def _time_stages(stages: Stages, batches: List[Tuple], device: torch.device,
                 batch: int) -> Tuple[Dict[str, float], List[Tuple]]:
    """Seconds per pair of each stage with the checksum discipline, each
    on the previous stage's outputs of the same distinct batches ->
    (the times, the last stage's inputs)."""
    times, x = {}, batches
    for i, (name, fn) in enumerate(stages.items()):
        if i:
            x = [prev(*args) for args in x]
        times[name] = _time_checksum(lambda *a, fn=fn: checksum(*fn(*a)), x, device) / batch
        prev = fn
    return times, x


@torch.no_grad()
def measure(h: int = 1024, w: int = 1024, d: int = 64, batch: int = 8, iters: int = 3,
            peaks: Peaks = Peaks(), seed: int = 0,
            device: str | torch.device = "cuda") -> List[Dict[str, object]]:
    """Per-phase roofline of the classic routes (ghost mode) on ``device``:
    the exact rule's K1, K2 and contour and its end to end, the reference
    rule's torch edges and K8 and its end to end, at ``batch`` pairs of
    [h, w] from ``seed``, ``iters`` distinct batches a phase."""
    from stereomatching_tpu_torch.models.classic import build_classic_pipeline

    dev = resolve_device(device)
    power = card(dev)["power_limit"]
    params = StereoParams(num_shifts=d, mode=BoundaryMode.GHOST, edge_rule="exact")
    rparams = dataclasses.replace(params, edge_rule="reference")
    models = classic_phase_models(params, h, w)
    ins = [tuple(x.to(torch.float32) / 256.0 for x in pair)
           for pair in _batches(np.random.default_rng(seed), iters + 1, batch, h, w, dev)]
    times = {}
    for name, p in (("end_to_end", params), ("end_to_end_reference", rparams)):
        pipe = build_classic_pipeline(p)
        times[name] = _time_checksum(
            lambda a, b, pipe=pipe: checksum(pipe(a, b)["output-0"]), ins, dev) / batch
    ref = classic_stages(rparams)
    times.update(_time_stages({k: ref[k] for k in ("edges", "match_and_score")},
                              ins, dev, batch)[0])
    times.update(_time_stages(classic_stages(params), ins, dev, batch)[0])
    return [verdict(name, times[name], models[name], peaks, power)
            for name in ("edges", "match_and_score", "match_score_edges", "diffusion",
                         "contour", "end_to_end", "end_to_end_reference")]


@torch.no_grad()
def measure_sgm(h: int = 1024, w: int = 1024, d: int = 64, batch: int = 32, iters: int = 3,
                peaks: Peaks = Peaks(), seed: int = 0, directions: int = 4,
                device: str | torch.device = "cuda") -> List[Dict[str, object]]:
    """Per-phase roofline of the SGM route (census, ``directions`` paths)
    on ``device``: the torch census, K3, K4, K5, the torch LR check, K6
    and end to end, at ``batch`` pairs of [h, w] from ``seed``, ``iters``
    distinct batches a phase.  K6's bound counts the cells this run's
    planes fill (``k6_filled``)."""
    from stereomatching_tpu_torch.models.modern import build_modern_pipeline
    from stereomatching_tpu_torch.utils.bench import k6_filled

    dev = resolve_device(device)
    power = card(dev)["power_limit"]
    params = ModernParams(num_disparities=d, aggregation="sgm", cost="census",
                          sgm_directions=directions)
    ins = [tuple(x.to(torch.int32) for x in pair)
           for pair in _batches(np.random.default_rng(seed), iters + 1, batch, h, w, dev)]
    pipe = build_modern_pipeline(params)
    times = {"end_to_end": _time_checksum(
        lambda a, b: checksum(pipe(a, b)["filled"]), ins, dev) / batch}
    stage_times, fill_ins = _time_stages(modern_stages(params), ins, dev, batch)
    times.update(stage_times)
    # The cells the timed batches' planes fill, per pair.
    filled = sum(k6_filled(valid, params.fill_iterations) for _, valid in fill_ins[1:])
    models = sgm_phase_models(params, h, w, filled / (iters * batch))
    return [verdict(name, times[name], models[name], peaks, power)
            for name in ("census", "volume", "aggregation", "tail", "lr_check", "fill",
                         "end_to_end")]


# ------------------------------------------------------------ the halo model

def halo_phase_model(params: StereoParams, w: int, batch: int = 1,
                     peaks: Peaks = Peaks()) -> Dict[str, Dict[str, float]]:
    """Per-SHARD exchanges of the row-sharded classic tier
    (``parallel/pipeline.py``'s table; ``prehalo_blocks``, ``_web_steps``,
    ``Shards.reduce_images``), each priced at NVLink's one-way peak.

    Every halo is one shift per direction, and each shift is a round of
    its own (``DistComm.shift`` waits for its send and receive); each
    image or map is exchanged on its own:
      * edges_halo: 1 row of x-padded float32 brightness, (w + 2) cells,
        of each image, both directions: 4 rounds;
      * boxfilter_halo: square_width // 2 rows of the left int32 edge map
        (w cells) and of the right one, extended by num_shifts columns
        before the exchange (w + num_shifts cells), both directions: 4
        rounds;
      * diffusion_halo: 1 int32 row of the web, both directions, before
        each of the times - 1 Jacobi steps: 2 (times - 1) sequential rounds;
      * contour_reduce: the per-image max and min (int32) as two
        all-reduces, priced as one round each.
    bytes: what one shard sends over the phase; exchanges: its sequential
    rounds; us = exchanges x latency + bytes / one-way NVLink rate.  None
    of it depends on the shard count or the shard's rows: each shard
    talks to its two neighbours only (the all-reduces' latency grows with
    the ranks and is not modelled)."""
    f32 = i32 = 4
    half, d = params.half, params.num_shifts
    steps = max(params.times - 1, 0)
    phases = {
        "edges_halo": {"bytes": float(4 * (w + 2) * f32 * batch), "exchanges": 4.0},
        "boxfilter_halo": {"bytes": float(2 * half * (w + w + d) * i32 * batch),
                           "exchanges": 4.0},
        "diffusion_halo": {"bytes": float(2 * steps * w * i32 * batch),
                           "exchanges": float(2 * steps)},
        "contour_reduce": {"bytes": float(2 * i32 * batch), "exchanges": 2.0},
    }
    for m in phases.values():
        m["us"] = _exchange_us(m, peaks)
    return phases


def _exchange_us(m: Dict[str, float], peaks: Peaks) -> float:
    return m["exchanges"] * peaks.exchange_latency_us + m["bytes"] / (
        peaks.nvlink_bytes_per_s_each_way) * 1e6


def gather_phase_model(rows_per_shard: int, w: int, batch: int, shards: int,
                       peaks: Peaks = Peaks()) -> Dict[str, float]:
    """The sharded tier's last step, which the JAX tier does not take:
    ``sharded_forward`` gathers every output to every rank, 6 int32
    planes and 2 per-image values as 8 all-gathers, in which each shard
    receives the other ``shards - 1`` blocks.  Grows with the shard
    count; nothing at one shard."""
    if shards == 1:
        return {"bytes": 0.0, "exchanges": 0.0, "us": 0.0}
    block = (6 * rows_per_shard * w + 2) * 4 * batch
    m = {"bytes": float((shards - 1) * block), "exchanges": 8.0}
    m["us"] = _exchange_us(m, peaks)
    return m


def weak_scaling_prediction(
    params: StereoParams, rows_per_shard: int, w: int, batch: int = 1,
    shard_counts: Sequence[int] = (1, 2, 4, 8), peaks: Peaks = Peaks(),
    compute_us: Optional[float] = None,
) -> List[Dict[str, float]]:
    """Weak-scaling efficiency of the row-sharded classic tier: the work
    per shard is constant (H = N x rows_per_shard), so

        eff(N) = t_compute / (t_compute + t_halo + t_gather(N)),  eff(1) = 1.

    t_compute is ``compute_us``, a measured 1-shard time of a batch (the
    scaling tool passes its own), or else the bound of the exact-rule
    route (K1, K2, contour) on one shard's slab: the hardest bar, since
    the tier's real compute (torch edges, K9, K2's step per exchange)
    takes longer and dilutes the exchanges' share.  ``peaks`` carries the
    exchange latency."""
    comp = classic_phase_models(params, rows_per_shard, w)["end_to_end"]
    t_bound_us = max(comp["bytes"] / peaks.hbm_bytes_per_s,
                     ops_seconds(comp, peaks)) * 1e6 * batch
    t_comp_us = t_bound_us if compute_us is None else compute_us
    t_halo_us = sum(m["us"] for m in halo_phase_model(params, w, batch, peaks).values())
    out = []
    for n in shard_counts:
        t_gather_us = gather_phase_model(rows_per_shard, w, batch, n, peaks)["us"]
        t_x = 0.0 if n == 1 else t_halo_us + t_gather_us
        out.append({
            "shards": n,
            "height": n * rows_per_shard,
            "t_compute_us_bound": t_bound_us,
            "t_compute_us": t_comp_us,
            "compute_from": "bound" if compute_us is None else "measured",
            "exchange_latency_us": peaks.exchange_latency_us,
            "t_halo_us": 0.0 if n == 1 else t_halo_us,
            "t_gather_us": t_gather_us,
            "predicted_efficiency": t_comp_us / (t_comp_us + t_x),
        })
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--batch", type=int, default=None,
                   help="default 8 (classic) or 32 (sgm)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--pipeline", choices=["classic", "sgm"], default="classic")
    p.add_argument("--directions", type=int, default=4, choices=[4, 8])
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", action="store_true", help="one JSON line per phase")
    p.add_argument("--ici", action="store_true",
                   help="print the halo-exchange model and the weak-scaling "
                        "prediction (no device needed) instead of measuring")
    p.add_argument("--rows-per-shard", type=int, default=256)
    args = p.parse_args(argv)

    if args.ici:
        params = StereoParams(num_shifts=args.disparities, edge_rule="exact")
        for name, m in halo_phase_model(params, args.size, args.batch or 1).items():
            print(json.dumps({"phase": name, **m}))
        for row in weak_scaling_prediction(params, args.rows_per_shard, args.size,
                                           args.batch or 1):
            print(json.dumps(row))
        return 0

    dev = resolve_device(args.device)
    info = card(dev)
    if args.pipeline == "sgm":
        rows = measure_sgm(h=args.size, w=args.size, d=args.disparities,
                           batch=args.batch or 32, iters=args.iters,
                           directions=args.directions, device=dev)
    else:
        rows = measure(h=args.size, w=args.size, d=args.disparities,
                       batch=args.batch or 8, iters=args.iters, device=dev)
    print(f"# {info['name']}, power limit {info['power_limit']}")
    if args.json:
        for r in rows:
            print(json.dumps(r))
        return 0
    cols = ("phase", "ms_per_pair", "mbytes", "achieved_gbps", "bound_ms", "bound_by",
            "share_of_bound_pct", "x_from_bound")
    print("  ".join(f"{c:>20}" for c in cols))
    for r in rows:
        print("  ".join(f"{r[c]:>20.4f}" if isinstance(r[c], float) else f"{str(r[c]):>20}"
                        for c in cols))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
