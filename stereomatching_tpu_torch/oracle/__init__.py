"""Pure-NumPy serial oracle for the stereo pipeline (the port's own copy
of ``stereomatching_tpu/oracle``).

Plays the role the reference's serial C programs (``src/stereo.c``,
``src/stereo-ghost.c``) play for its CUDA binaries: a trivially-correct,
CPU-runnable executable spec against which the accelerated
implementations are validated phase-by-phase, bit-for-bit (reference
``test/diff.sh``).  It runs on no device; ``python -m
stereomatching_tpu_torch.cli --tier oracle`` runs it.
"""

from stereomatching_tpu_torch.oracle.pipeline import (
    find_edges,
    fill_matches,
    box_sum,
    record_scores,
    best_and_winner,
    fill_web_holes,
    draw_contour,
    run_pipeline,
)

__all__ = [
    "find_edges",
    "fill_matches",
    "box_sum",
    "record_scores",
    "best_and_winner",
    "fill_web_holes",
    "draw_contour",
    "run_pipeline",
]
