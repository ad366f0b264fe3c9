"""Measurement harness (counterpart of ``stereomatching_tpu/bench``):
per-phase timers, size sweeps, the thesis's pixel-pass throughput model
(``harness``), the roofline of the port's routes on the card's peaks
(``roofline``) and the graphs (``graphs``)."""

from stereomatching_tpu_torch.bench.harness import (
    BenchResult,
    phase_timings,
    pixel_passes,
    size_sweep,
    time_fn,
)

__all__ = [
    "BenchResult",
    "pixel_passes",
    "phase_timings",
    "size_sweep",
    "time_fn",
]
