"""Artifact checkpoints of the port's CLI: an artifact dict saved as one
compressed ``.npz`` (exact integer and float values, where the PPM dumps
normalise) and loaded back.  The port's own copy of
``stereomatching_tpu/utils/artifacts.py``: the files are the same, so a
checkpoint written by either package's CLI resumes in the other's, and
``compare_artifacts`` diffs two artifact dicts as the JAX one does."""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


def save_artifacts(path: str, artifacts: Mapping[str, np.ndarray]) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in artifacts.items()})


def load_artifacts(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare_artifacts(
    a: Mapping[str, np.ndarray],
    b: Mapping[str, np.ndarray],
    atol: float = 0.0,
) -> List[str]:
    """Names of the artifacts that differ: those present in only one
    dict, then (in sorted order) those of another shape or other values.
    ``atol`` 0 asks for equal values (``np.array_equal``, the reference's
    diff of dumps), a positive ``atol`` for values within that absolute
    tolerance and no relative one."""
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            bad.append(k)
        elif atol == 0.0:
            if not np.array_equal(x, y):
                bad.append(k)
        elif not np.allclose(x, y, atol=atol, rtol=0.0):
            bad.append(k)
    return bad
