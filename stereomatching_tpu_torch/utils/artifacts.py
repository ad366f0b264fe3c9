"""Artifact checkpoints of the port's CLI: an artifact dict saved as one
compressed ``.npz`` (exact integer and float values, where the PPM dumps
normalise) and loaded back.  The port's own copy of
``stereomatching_tpu/utils/artifacts.py``'s ``save_artifacts`` and
``load_artifacts``; the files are the same, so a checkpoint written by
either package's CLI resumes in the other's."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def save_artifacts(path: str, artifacts: Mapping[str, np.ndarray]) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in artifacts.items()})


def load_artifacts(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
