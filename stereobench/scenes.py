"""Stereo scenes made on the device from a seed.

Modelled on ``textured_shift`` (dense uniform texture under a horizontal
shift, every pixel matchable), with layers: a textured background at one
shift and textured rectangular regions in front of it at larger shifts.
Each region hides part of the background in the other view, so the
occlusion bands give the LR check and the hole fill real work.

A layer at disparity d with texture T seen from the left camera shows
T(y, x); from the right camera it shows T(y, x + s * d), where ``s`` is
the route's sign (+1: right(x) = left(x + d), the modern routes; -1:
right(x) = left(x - d), the classic route).  Nearer layers (larger d)
cover farther ones in both views.

Everything is drawn from a ``torch.Generator`` on the device the pixels
are made on, in a few large calls: the same seed gives the same pixels
on the same device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _shifts(gen: torch.Generator, shape, frac: Tuple[float, float], max_shift: int):
    """Integer shifts in [frac[0], frac[1]] x max_shift."""
    lo, hi = frac
    return torch.round(_uniform(gen, shape, lo, hi) * max_shift).to(torch.int64).clamp(0, max_shift)


def layered_batch(
    gen: torch.Generator, batch: int, h: int, w: int, max_shift: int, sign: int,
    scene: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of layered pairs -> (left, right), uint8 [batch, h, w].

    ``scene``: ``regions`` (regions per image), ``background_shift`` and
    ``foreground_shift`` (ranges of the shift as fractions of
    ``max_shift``), ``region_size`` (range of a region's half-height and
    half-width as fractions of the image's).  Shifts lie in
    [0, max_shift]."""
    if sign not in (-1, 1):
        raise ValueError("sign must be +1 or -1")
    dev = gen.device
    k = int(scene["regions"])
    pad = max_shift
    width = w + 2 * pad  # texture columns: x in [-pad, w + pad)
    tex = torch.randint(0, 256, (k + 1, batch, h, width), generator=gen, device=dev,
                        dtype=torch.uint8)
    d_bg = _shifts(gen, (batch,), scene["background_shift"], max_shift)
    d_fg = _shifts(gen, (k, batch), scene["foreground_shift"], max_shift)
    # Nearer regions are painted later: sort each image's regions by shift.
    d_fg, order = d_fg.sort(dim=0)
    tex_fg = tex[1:].gather(0, order[:, :, None, None].expand(k, batch, h, width))
    size = scene["region_size"]
    cy = _uniform(gen, (k, batch), 0.0, 1.0) * h
    cx = _uniform(gen, (k, batch), 0.0, 1.0) * w
    hh = _uniform(gen, (k, batch), size[0], size[1]) * h
    hw = _uniform(gen, (k, batch), size[0], size[1]) * w
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.int64)[None, None, :]

    def view(s: int) -> torch.Tensor:
        col = (xs + s * d_bg[:, None, None] + pad).expand(batch, h, w)
        img = tex[0].gather(2, col)
        for r in range(k):
            x = xs + s * d_fg[r][:, None, None]
            inside = ((ys - cy[r][:, None, None]).abs() <= hh[r][:, None, None]) & (
                (x.to(torch.float32) - cx[r][:, None, None]).abs() <= hw[r][:, None, None])
            img = torch.where(inside, tex_fg[r].gather(2, (x + pad).expand(batch, h, w)), img)
        return img

    return view(0), view(sign)
