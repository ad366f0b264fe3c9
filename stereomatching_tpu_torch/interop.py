"""State carried across the two packages.

The classic pipeline has no learned weights (its parameters are the
shared ``StereoParams``); its state is the resumable artifact checkpoint
(``stereomatching_tpu.utils.artifacts``, the CLI's ``--save-artifacts`` /
``--resume``).  These two functions move an artifact dict between numpy
(what the JAX package saves and loads) and port tensors, keeping dtypes
(int32 planes, int32 scalars or [B]), so a ``web-1`` checkpoint written
by either package resumes in the other's ``classic_finish``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def artifacts_from_numpy(
    arts: Mapping[str, np.ndarray], device: str | torch.device = "cpu"
) -> Dict[str, object]:
    """Numeric arrays -> tensors on ``device`` with the same dtype and
    shape; non-numeric entries (a checkpoint's ``params`` JSON string)
    are passed through unchanged."""
    out: Dict[str, object] = {}
    for k, v in arts.items():
        a = np.asarray(v)
        if a.dtype.kind in "biuf":
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        else:
            out[k] = v
    return out


def artifacts_to_numpy(arts: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """Tensors -> numpy arrays on the host (dtype and shape kept)."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in arts.items()
    }
