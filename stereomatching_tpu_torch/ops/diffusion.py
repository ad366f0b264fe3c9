"""Web hole-filling diffusion (counterpart of
``stereomatching_tpu/ops/diffusion.py``; reference ``fill_web_holes``,
src/stereo.c:230-251).

The reference's double-buffer pointer swaps amount to the two-history
recurrence

    X[t+1][p] = (X[t][p] == 0) ? floor(avg4(X[t])[p]) : X[t-1][p]

with X[-1] = X[0] = web, returning X[times-1].  Neighbours are raw flat
indices p±1 / p±W of each image (x neighbours cross row boundaries);
reads outside the image's buffer are 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fill_web_holes(web: torch.Tensor, times: int) -> torch.Tensor:
    """[..., H, W] -> int32 [..., H, W]; each image diffuses on its own."""
    cur = web.to(torch.int32)
    steps = max(times - 1, 0)
    if steps == 0:
        return cur
    shape = cur.shape
    w = shape[-1]
    f = cur.reshape(*shape[:-2], -1)
    prev = f
    for _ in range(steps):
        right = F.pad(f[..., 1:], (0, 1))  # p+1
        down = F.pad(f[..., w:], (0, w))  # p+W
        left = F.pad(f[..., :-1], (1, 0))  # p-1
        up = F.pad(f[..., :-w], (w, 0))  # p-W
        avg = (right + down + left + up) // 4  # floor division
        prev, f = f, torch.where(f == 0, avg, prev)
    return f.reshape(shape)
