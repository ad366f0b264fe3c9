"""State carried across the two packages.

Neither pipeline has learned weights.  What crosses is (a) the
parameters, ``StereoParams`` / ``ModernParams``, which ``params_from_jax``
turns from the JAX package's classes into the port's through their JSON
form, and (b) the classic pipeline's resumable artifact checkpoint (the
JAX CLI's ``--save-artifacts`` / ``--resume``): ``artifacts_from_numpy``
and ``artifacts_to_numpy`` move an artifact dict between numpy (what the
JAX package saves and loads) and port tensors, keeping dtypes (int32
planes, int32 scalars or [B]), so a ``web-1`` checkpoint written by
either package resumes in the other's ``classic_finish``.

``mesh_shape_from_jax`` reads a JAX mesh's (data, rows[, cols]) sizes, so
that a test builds the same shard layout in both packages.

Nothing of the JAX package is imported here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from stereomatching_tpu_torch.config import ModernParams, StereoParams

_PARAM_CLASSES = {"StereoParams": StereoParams, "ModernParams": ModernParams}


def params_from_jax(p) -> Union[StereoParams, ModernParams]:
    """The JAX package's ``StereoParams`` or ``ModernParams`` -> the
    port's class of the same name with the same field values (through
    ``p.to_json()``).  Raises ``TypeError`` for any other object."""
    cls = _PARAM_CLASSES.get(type(p).__name__)
    if cls is None or not hasattr(p, "to_json"):
        raise TypeError(f"not a StereoParams or ModernParams: {type(p).__name__}")
    return cls.from_json(p.to_json())


def mesh_shape_from_jax(mesh) -> tuple:
    """A JAX ``Mesh`` over the (data, rows[, cols]) axes -> its sizes,
    (data, rows) or (data, rows, cols): the arguments of the port's
    ``parallel.make_mesh`` for the same layout."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if names not in (("data", "rows"), ("data", "rows", "cols")):
        raise TypeError(f"not a (data, rows[, cols]) mesh: axes {names}")
    return tuple(int(mesh.shape[n]) for n in names)


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
