"""Device selection (the port's counterpart of the JAX package's
``utils/platform.py``, whose job there is pinning the JAX platform).

``resolve_device`` never falls back: asking for a CUDA device on a host
without one raises, so a measurement meant for the GPU cannot quietly
run on the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> ``torch.device``.
    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False, or the index is out of range."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r} (use 'cpu' or 'cuda')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__})"
        )
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {name!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible"
        )
    return dev
