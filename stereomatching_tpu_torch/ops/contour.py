"""Contour rendering (counterpart of ``stereomatching_tpu/ops/contour.py``;
reference ``draw_contour_map``, src/stereo.c:256-274): per-image min/max,
interval = range // num_lines (clamped to >= 1, where the reference
divides by zero for a range smaller than num_lines), pixel on a line iff
(web - min) % interval == 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def contour_bands(
    web: torch.Tensor, num_lines: int, min_e: torch.Tensor, max_e: torch.Tensor
) -> torch.Tensor:
    """Banding pass given each image's elevation range -> int32 {0,1},
    same shape as ``web`` [..., H, W]; ``min_e``/``max_e`` have shape
    ``web.shape[:-2]``.

    The same float32-quotient form as the JAX package: q = floor(x/i) in
    float32 is within ±1 of the true floor for elevations far below
    2^20, and the remainder test accepts r in {-i, 0, i}, which
    classifies every pixel exactly under that error bound."""
    min_e = min_e[..., None, None]
    interval = torch.clamp((max_e[..., None, None] - min_e) // num_lines, min=1)
    x = web - min_e
    q = torch.floor(x.to(torch.float32) / interval.to(torch.float32))
    r = x - q.to(torch.int32) * interval
    return ((r == 0) | (r == interval) | (r == -interval)).to(torch.int32)


def draw_contour(
    web: torch.Tensor, num_lines: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (contour int32 {0,1} [..., H, W], min_elevation, max_elevation),
    the range taken per image."""
    max_e = web.amax(dim=(-2, -1))
    min_e = web.amin(dim=(-2, -1))
    return contour_bands(web, num_lines, min_e, max_e), min_e, max_e
