"""stereomatching_tpu_torch — the classic stereo pipeline in PyTorch + CUDA.

A port of ``stereomatching_tpu`` (the JAX/Pallas package, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU.  Plain phases are torch
ops; the two Pallas kernels of the classic pipeline are hand-written
CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use:

* ``ops.fused.match_score_edges`` — exact-rule edges + per-shift match
  + square box score + last-wins argmax (Pallas
  ``ops/fused.py::match_score_edges_pallas``);
* ``ops.fused_diffusion.fill_web_holes_range`` — the hole-filling
  Jacobi steps + per-image min/max (Pallas
  ``ops/fused_diffusion.py::fill_web_holes_pallas``).

Each kernel wrapper runs its plain torch version on CPU tensors and the
kernel on CUDA tensors (no fallback).  The framework-free modules of the
JAX package (``config``, ``oracle``, ``utils.{synthetic,artifacts,
imageio}``) are imported, not copied; none of them imports jax.
"""

from stereomatching_tpu.config import BoundaryMode, StereoParams

__all__ = ["BoundaryMode", "StereoParams", "Matcher", "ClassicPipeline"]


def __getattr__(name):
    """Lazy re-exports so ``import stereomatching_tpu_torch`` stays light
    (no torch import at package import time)."""
    if name == "Matcher":
        from stereomatching_tpu_torch.serving import Matcher

        return Matcher
    if name == "ClassicPipeline":
        from stereomatching_tpu_torch.models.classic import ClassicPipeline

        return ClassicPipeline
    raise AttributeError(name)
