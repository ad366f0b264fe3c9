"""Pipelines of the PyTorch port: ``classic`` (the reference's edge
matcher, ``ClassicPipeline``) and ``modern`` (box and SGM routes,
``ModernPipeline``), exported under the names of the JAX package's
``models``."""

from stereomatching_tpu_torch.models.classic import (
    build_classic_collect_pipeline,
    build_classic_finish_pipeline,
    build_classic_pipeline,
    classic_finish,
    classic_forward,
)
from stereomatching_tpu_torch.models.modern import (
    build_modern_pipeline,
    disparity_one_view,
    modern_forward,
)

__all__ = [
    "classic_forward",
    "classic_finish",
    "build_classic_pipeline",
    "build_classic_collect_pipeline",
    "build_classic_finish_pipeline",
    "modern_forward",
    "build_modern_pipeline",
    "disparity_one_view",
]
