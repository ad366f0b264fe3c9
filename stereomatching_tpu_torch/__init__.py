"""stereomatching_tpu_torch — the stereo pipelines in PyTorch + CUDA.

A port of ``stereomatching_tpu`` (the JAX/Pallas package, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU.  Plain phases are torch
ops; the Pallas kernels on the ported routes are hand-written CUDA C++
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use:

* classic pipeline (``models/classic.py``, ``Matcher``):
  ``ops.fused.match_score_edges`` (exact rule: edges + match + box score +
  argmax) or ``ops.fused.match_and_score`` (reference rule: match + box
  score + argmax from torch edge maps), both with an optional sub-pixel
  plane, and ``ops.fused_diffusion.fill_web_holes_range`` (hole-filling
  steps + per-image min/max);
* modern pipeline (``models/modern.py``, ``ModernMatcher``): on the box
  route (the default) ``ops.fused_modern.disparity`` (per-pixel cost +
  window sum + argmin + sub-pixel, twice per forward; ``scales=2`` runs
  as torch ops); on the SGM route ``ops.fused_sgm.sgm_volume`` (census /
  SAD cost volume; torch ops at ``scales=2``), ``ops.fused_sgm.sgm_directional``
  (one SGM path: four per call with 4 directions, eight with the
  diagonals) and ``ops.fused_sgm.sgm_tail`` (argmin, sub-pixel, right
  view, second best); on both ``ops.fused_diffusion.fill_invalid``
  (validity-aware hole fill);
* the reference-compatible CLI, ``python -m stereomatching_tpu_torch.cli``
  (``--tier oracle`` runs the numpy serial oracle, ``oracle/``);
* the input and quality side: ``data`` (``discover_pairs``,
  ``StereoPairDataset``, ``BatchLoader``, which places batches on the card
  through page-locked non-blocking copies; PFM and 16-bit disparity PNG
  ground truth), ``utils/synthetic.py`` (scenes with known disparity) and
  ``utils/metrics.py`` (bad-pixel rate, EPE).

Each kernel wrapper runs its plain torch version on CPU tensors and the
kernel on CUDA tensors (no fallback).  The port owns its parameters
(``config``) and imports no module of the JAX package.
"""

from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams

__all__ = [
    "BoundaryMode", "StereoParams", "ModernParams",
    "Matcher", "ClassicPipeline", "ModernMatcher", "ModernPipeline",
    "StereoPairDataset", "BatchLoader", "discover_pairs",
]


def __getattr__(name):
    """Lazy exports so ``import stereomatching_tpu_torch`` stays light
    (no torch import at package import time)."""
    if name in ("Matcher", "ModernMatcher"):
        from stereomatching_tpu_torch import serving

        return getattr(serving, name)
    if name == "ClassicPipeline":
        from stereomatching_tpu_torch.models.classic import ClassicPipeline

        return ClassicPipeline
    if name == "ModernPipeline":
        from stereomatching_tpu_torch.models.modern import ModernPipeline

        return ModernPipeline
    if name in ("StereoPairDataset", "BatchLoader", "discover_pairs"):
        from stereomatching_tpu_torch import data

        return getattr(data, name)
    raise AttributeError(name)
