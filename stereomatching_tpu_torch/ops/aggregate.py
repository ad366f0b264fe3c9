"""Windowed score aggregation (counterpart of ``stereomatching_tpu/ops/
aggregate.py``; reference ``addup_pixels_in_square``, src/stereo.c:
132-148): the square_width² box sum centered on each pixel, as a
summed-area table — two cumulative sums and a 4-corner difference, exact
in int32 (window sums <= sw² and table entries <= H*W < 2^31).

Only the SAT form is ported: the JAX package's banded-matmul form is a
choice for the TPU's matrix unit and gives the same integers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereomatching_tpu_torch.config import BoundaryMode


def wrap_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes by ``pad`` with modulo wrap-around (any
    ``pad``, also larger than the axis, like ``jnp.pad(mode="wrap")``)."""
    h, w = x.shape[-2:]
    ys = torch.arange(-pad, h + pad, device=x.device) % h
    xs = torch.arange(-pad, w + pad, device=x.device) % w
    return x.index_select(-2, ys).index_select(-1, xs)


def pad_plane(plane: torch.Tensor, half: int, mode: BoundaryMode) -> torch.Tensor:
    """Pad a match plane by ``half``: wrap-around (src/stereo.c:141-142)
    or the ghost variant's zero-filled match halo
    (src/stereo-ghost.c:93-97, 140-141)."""
    if mode == BoundaryMode.WRAP:
        return wrap_pad(plane, half)
    return F.pad(plane, (half, half, half, half))


def box_sum_padded(padded: torch.Tensor, half: int) -> torch.Tensor:
    """Box sum over an already ``half``-padded plane (last two axes)
    -> int32 [..., H, W]; leading batch dims pass through."""
    k = 2 * half + 1
    sat = padded.to(torch.int32).cumsum(-2, dtype=torch.int32)
    sat = F.pad(sat.cumsum(-1, dtype=torch.int32), (1, 0, 1, 0))
    return (
        sat[..., k:, k:]
        - sat[..., :-k, k:]
        - sat[..., k:, :-k]
        + sat[..., :-k, :-k]
    )


def box_sum(plane: torch.Tensor, square_width: int, mode: BoundaryMode) -> torch.Tensor:
    half = square_width // 2
    return box_sum_padded(pad_plane(plane, half, mode), half)
