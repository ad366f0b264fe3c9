"""Plain PyTorch reference of the classic pipeline (the C reference
``chrg127/stereomatching``'s ``algorithm()``, src/stereo.c:287-333, and
its ghost variant src/stereo-ghost.c): edges, per-shift match, box score
and argmax, web diffusion, contour.

Written for the benchmark alone: it imports nothing of the program and
takes nothing the program made.  Every float operation runs in
``float_dtype``: float32 is the pipeline's stated precision and gives
its artifacts bit for bit; a lower type is the benchmark's control.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# The ghost programs' 1-pixel brightness halo (src/stereo-ghost.c:384-385).
GHOST_FILL = 128.0
# (side a, side b) taps as (dx, dy) of the four edge operators, in the C
# summation order (src/stereo.c:16-70).
OPERATORS = (
    (((-1, -1), (-1, 0), (-1, 1)), ((1, -1), (1, 0), (1, 1))),
    (((-1, -1), (0, -1), (1, -1)), ((-1, 1), (0, 1), (1, 1))),
    (((-1, -1), (0, -1), (-1, 0)), ((1, 0), (0, 1), (1, 1))),
    (((-1, 1), (0, 1), (-1, 0)), ((0, -1), (1, -1), (1, 0))),
)


def wrap_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes by ``pad`` with modulo wrap-around."""
    h, w = x.shape[-2:]
    ys = torch.arange(-pad, h + pad, device=x.device) % h
    xs = torch.arange(-pad, w + pad, device=x.device) % w
    return x.index_select(-2, ys).index_select(-1, xs)


def edges(brightness: torch.Tensor, params: Dict, float_dtype: torch.dtype) -> torch.Tensor:
    """Binary int32 edge map [..., H, W] of one view."""
    if params["mode"] == "wrap":
        p = wrap_pad(brightness, 1)
    else:
        p = F.pad(brightness, (1, 1, 1, 1), value=GHOST_FILL)
    h, w = brightness.shape[-2:]
    exact = params["edge_rule"] == "exact"
    if exact:
        # 2|ka - kb| > min(t (ka + kb), 1536) on k = round(256 brightness).
        p = torch.round(p.to(float_dtype) * 256.0).to(torch.int32)
    else:
        p = p.to(float_dtype)

    def nb(dx: int, dy: int) -> torch.Tensor:
        return p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=float_dtype, device=p.device)

    out = torch.zeros((*p.shape[:-2], h, w), dtype=torch.bool, device=p.device)
    for (a0, a1, a2), (b0, b1, b2) in OPERATORS:
        if exact:
            ka = nb(*a0) + nb(*a1) + nb(*a2)
            kb = nb(*b0) + nb(*b1) + nb(*b2)
            lhs = (2 * (ka - kb).abs()).to(float_dtype)
            rhs = torch.minimum(const(params["threshold"]) * (ka + kb).to(float_dtype),
                                const(1536.0))
            out |= lhs > rhs
        else:
            avg_a = (nb(*a0) + nb(*a1) + nb(*a2)) / const(3.0)
            avg_b = (nb(*b0) + nb(*b1) + nb(*b2)) / const(3.0)
            bound = torch.clamp(const(params["threshold"]) * ((avg_a + avg_b) / const(2.0)),
                                0.0, 1.0)
            out |= (avg_a - avg_b).abs() > bound
    return out.to(torch.int32)


def box_sum(plane: torch.Tensor, half: int, wrap: bool) -> torch.Tensor:
    """The (2 half + 1)^2 box sum of an int32 plane, wrapped or over a
    zero halo, by a summed-area table."""
    p = wrap_pad(plane, half) if wrap else F.pad(plane, (half,) * 4)
    k = 2 * half + 1
    sat = F.pad(p.cumsum(-2, dtype=torch.int32).cumsum(-1, dtype=torch.int32), (1, 0, 1, 0))
    return sat[..., k:, k:] - sat[..., :-k, k:] - sat[..., k:, :-k] + sat[..., :-k, :-k]


def match(edges_l: torch.Tensor, edges_r: torch.Tensor, params: Dict):
    """-> (best score, winner) int32 [..., H, W]: for each shift i the
    match plane L(x) == R(x + i) (wrapped, or the ghost halo's zeros),
    its box sum where it matched, and the last shift reaching the best
    score (winner i + 1; all-zero scores give num_shifts)."""
    d = params["num_shifts"]
    w = edges_l.shape[-1]
    wrap = params["mode"] == "wrap"
    if wrap:
        ext = torch.cat([edges_r] * (-(-d // w) + 1), dim=-1)[..., : w + d]
    else:
        ext = F.pad(edges_r, (0, d))
    half = params["square_width"] // 2
    best = torch.zeros(edges_l.shape, dtype=torch.int32, device=edges_l.device)
    winner = torch.zeros_like(best)
    for i in range(d):
        m = (edges_l == ext[..., i: i + w]).to(torch.int32)
        score = torch.where(m == 1, box_sum(m, half, wrap), 0)
        winner = torch.where(score >= best, i + 1, winner)
        best = torch.maximum(best, score)
    return best, winner


def diffuse(web: torch.Tensor, times: int) -> torch.Tensor:
    """X[t+1][p] = X[t][p] == 0 ? floor(avg4(X[t])[p]) : X[t-1][p] over
    flat indices p of each image (x neighbours cross rows; outside reads
    0), X[-1] = X[0] = web, -> X[times - 1]."""
    cur = web.to(torch.int32)
    if times <= 1:
        return cur
    shape, w = cur.shape, cur.shape[-1]
    f = cur.reshape(*shape[:-2], -1)
    prev = f
    for _ in range(times - 1):
        avg = (F.pad(f[..., 1:], (0, 1)) + F.pad(f[..., w:], (0, w))
               + F.pad(f[..., :-1], (1, 0)) + F.pad(f[..., :-w], (w, 0))) // 4
        prev, f = f, torch.where(f == 0, avg, prev)
    return f.reshape(shape)


def contour(web: torch.Tensor, lines: int, float_dtype: torch.dtype):
    """-> (bands int32, min, max): per image the elevation range,
    interval = max(range // lines, 1), a pixel on a band iff (web - min)
    is a multiple of the interval (the quotient in ``float_dtype``, the
    remainder test taking r in {-i, 0, i})."""
    mn, mx = web.amin(dim=(-2, -1)), web.amax(dim=(-2, -1))
    lo = mn[..., None, None]
    interval = torch.clamp((mx[..., None, None] - lo) // lines, min=1)
    x = web - lo
    q = torch.floor(x.to(float_dtype) / interval.to(float_dtype))
    r = x - q.to(torch.int32) * interval
    return ((r == 0) | (r == interval) | (r == -interval)).to(torch.int32), mn, mx


def forward(left: torch.Tensor, right: torch.Tensor, params: Dict,
            float_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The pipeline on brightness [B, H, W] -> every artifact the
    program's forward returns."""
    el, er = edges(left, params, float_dtype), edges(right, params, float_dtype)
    best, winner = match(el, er, params)
    web = diffuse(winner, params["times"])
    bands, mn, mx = contour(web, params["lines"], float_dtype)
    return {"edges-1": el, "edges-2": er, "score_best": best, "web-1": winner,
            "web-2": web, "output-0": bands, "min_elevation": mn, "max_elevation": mx}
