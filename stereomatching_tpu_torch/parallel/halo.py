"""Halo exchange between row (and column) shards (counterpart of
``stereomatching_tpu/parallel/halo.py``; the reference's ghost areas,
``src/ghost.h:6-55``).

Each shard sends its boundary rows to its mesh neighbours and receives
the rows it needs to read past its own boundary.  Two boundary behaviours:

* circular (wrap mode): the first shard's top halo comes from the last
  shard (the distributed modulo indexing of ``src/util.h:42-47``);
* open (ghost mode): an edge shard's outer halo is ``fill`` (128.0 for
  brightness per ``src/stereo-ghost.c:384-385``, 0 otherwise).  As with
  ``jax.lax.ppermute``, nothing is delivered there (zeros), and a
  non-zero ``fill`` is written over it.

The functions take a block tensor [lr, lc, n, ..., h, w] of
``mesh.Shards`` (rows are axis -2, columns axis -1).  Between shards of a
block the exchange is slicing and concatenation; the faces of the block
go to the neighbouring blocks through the block's communicator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereomatching_tpu_torch.parallel.mesh import COLS_AXIS, ROWS_AXIS, Shards


def _exchange_halo(
    x: torch.Tensor, halo: int, shards: Shards, axis: str, circular: bool, fill: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared body of the row and column exchanges -> (low, high) halo
    blocks of ``halo`` slices each along the axis's spatial dimension."""
    mdim = 0 if axis == ROWS_AXIS else 1  # the block's mesh dimension
    sdim = x.ndim - 2 if axis == ROWS_AXIS else x.ndim - 1
    ext = x.shape[sdim]
    if halo > ext:
        raise ValueError(
            f"halo {halo} exceeds shard extent {ext} on axis {sdim - x.ndim}: use "
            "fewer shards on that mesh axis (halo width == dependency "
            "reach, src/stereo-ghost.c:11-12)"
        )
    high = x.narrow(sdim, ext - halo, halo)  # what the next shard needs as low
    low = x.narrow(sdim, 0, halo)  # what the previous shard needs as high
    n = x.shape[mdim]
    cax = 1 if axis == ROWS_AXIS else 2  # the communicator's axis
    from_prev = shards.comm.shift(high.narrow(mdim, n - 1, 1), cax, 1, circular)
    from_next = shards.comm.shift(low.narrow(mdim, 0, 1), cax, -1, circular)
    low_h = torch.cat([from_prev, high.narrow(mdim, 0, n - 1)], dim=mdim)
    high_h = torch.cat([low.narrow(mdim, 1, n - 1), from_next], dim=mdim)
    if not circular and fill != 0:
        if shards.first(axis):
            low_h.narrow(mdim, 0, 1).fill_(fill)
        if shards.last(axis):
            high_h.narrow(mdim, n - 1, 1).fill_(fill)
    return low_h, high_h


def exchange_row_halo(
    x: torch.Tensor, halo: int, shards: Shards, circular: bool, fill: float = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (top, bottom) halo blocks of ``halo`` rows each: the rows just
    above each shard's first row (the bottom rows of the shard above) and
    just below its last.  Open boundaries are filled with ``fill``."""
    return _exchange_halo(x, halo, shards, ROWS_AXIS, circular, fill)


def exchange_col_halo(
    x: torch.Tensor, halo: int, shards: Shards, circular: bool, fill: float = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (left, right) halo blocks of ``halo`` columns each, the x-axis
    twin of ``exchange_row_halo`` for the cols mesh axis (the x halo is
    the wider one: shift reach + window half, src/stereo-ghost.c:11-12)."""
    return _exchange_halo(x, halo, shards, COLS_AXIS, circular, fill)


def with_row_halo(
    x: torch.Tensor, halo: int, shards: Shards, circular: bool, fill: float = 0
) -> torch.Tensor:
    """Concatenate exchanged halos: [..., hs, w] -> [..., hs + 2*halo, w]."""
    if halo == 0:
        return x
    top, bottom = exchange_row_halo(x, halo, shards, circular, fill)
    return torch.cat([top, x, bottom], dim=-2)


def with_col_halo(
    x: torch.Tensor, halo: int, shards: Shards, circular: bool, fill: float = 0,
    right_halo: int | None = None,
) -> torch.Tensor:
    """Concatenate exchanged column halos: [..., h, ws] ->
    [..., h, halo + ws + right_halo]; ``right_halo`` (default ``halo``)
    sizes the right side on its own (the classic pipeline's x reach is
    asymmetric: the shift slide reads only to the right)."""
    rh = halo if right_halo is None else right_halo
    if halo == 0 and rh == 0:
        return x
    parts = []
    if halo:
        parts.append(exchange_col_halo(x, halo, shards, circular, fill)[0])
    parts.append(x)
    if rh:
        parts.append(exchange_col_halo(x, rh, shards, circular, fill)[1])
    return torch.cat(parts, dim=-1)
