"""Process groups and the messages between shard blocks (counterpart of
``stereomatching_tpu/parallel/distributed.py``).

A mesh's shards are split into equal contiguous blocks, one per process
(``torch.distributed`` rank) or, in one process, one per device.  Inside
a block every shard lives on the block's device, stacked along leading
axes, and an exchange between two of them is slicing.  Between blocks the
messages go through a communicator:

* ``LocalComm``: the whole mesh is one block (one process, one device,
  the repeated-device mesh of the tests and of the one-card runs);
* ``DistComm``: one block per rank, ``torch.distributed`` point-to-point
  sends (``batch_isend_irecv``) and collectives, gloo for CPU shards and
  NCCL for CUDA shards;
* ``ThreadComm``: one block per device in one process, each block's body
  in its own thread, the blocks meeting at a barrier.

Every block makes the same communicator calls in the same order, and a
shift is one batched send and receive on every block (JAX's
``ppermute``), so no exchange waits on a send that is queued behind it.

Typical multi-process run, one process per GPU (``torchrun
--nproc-per-node N``, which sets the environment ``initialize`` reads):

    from stereomatching_tpu_torch.parallel import Sharded, distributed, make_mesh
    distributed.initialize()
    mesh = make_mesh(data=1, rows=N)        # one row shard per rank
    left = Sharded.from_callback(shape, mesh, lambda index: read_left(index))
    right = Sharded.from_callback(shape, mesh, lambda index: read_right(index))
    arts = build_sharded_pipeline(params, mesh)(left, right)   # this rank's shards
    web = arts["web-2"].to_global()         # an all-gather: every rank calls it

Nothing here starts a process group at import time.  Failure model:
fail-fast, as the reference; a lost rank fails the job.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence, Tuple

import torch

# Message tags: the two directions of a shift.
_TAG_SHIFT = {1: 1, -1: 2}


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Start ``torch.distributed`` for a multi-process sharded run; a
    no-op when it is already started or when the run is one process
    (no ``world_size`` > 1 given and no ``WORLD_SIZE`` > 1 in the
    environment).  ``init_method`` defaults to ``env://`` (``MASTER_ADDR``
    / ``MASTER_PORT``, as ``torchrun`` sets them); ``backend`` to NCCL
    when a GPU is visible, else gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def local_shard_bounds(global_rows: int, n_shards: int, shard_idx: int):
    """Row range [lo, hi) owned by shard ``shard_idx`` under the even
    row sharding the sharded pipelines use (H must divide evenly)."""
    if global_rows % n_shards:
        raise ValueError(f"H={global_rows} not divisible by {n_shards} row shards")
    per = global_rows // n_shards
    return shard_idx * per, (shard_idx + 1) * per


class _Grid:
    """Blocks laid out as a (data, rows, cols) grid, ``index`` this one."""

    def __init__(self, grid: Tuple[int, int, int], index: Tuple[int, int, int]):
        self.grid, self.index = grid, index

    def neighbour(self, axis: int, step: int, circular: bool) -> Optional[int]:
        """Flat index of the block ``step`` away along mesh axis ``axis``
        (0 data, 1 rows, 2 cols), None past an open edge."""
        n = self.grid[axis]
        pos = self.index[axis] + step
        if not 0 <= pos < n:
            if not circular:
                return None
            pos %= n
        idx = list(self.index)
        idx[axis] = pos
        return (idx[0] * self.grid[1] + idx[1]) * self.grid[2] + idx[2]


class LocalComm(_Grid):
    """The whole mesh is one block: no messages."""

    def __init__(self):
        super().__init__((1, 1, 1), (0, 0, 0))

    def shift(self, face, axis, step, circular):
        return face if circular else torch.zeros_like(face)

    def all_reduce(self, t, op):
        return t


class DistComm(_Grid):
    """One block per ``torch.distributed`` rank (rank = flat block index)."""

    def shift(self, face, axis, step, circular):
        """Every block sends ``face`` to its neighbour ``step`` away along
        ``axis`` and returns the face of the neighbour ``-step`` away;
        zeros where no block sends (an open edge, as ``ppermute``)."""
        import torch.distributed as dist

        if self.grid[axis] == 1:
            return face if circular else torch.zeros_like(face)
        dst = self.neighbour(axis, step, circular)
        src = self.neighbour(axis, -step, circular)
        out = torch.zeros(face.shape, dtype=face.dtype, device=face.device)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, face.contiguous(), dst, tag=_TAG_SHIFT[step]))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, src, tag=_TAG_SHIFT[step]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def all_reduce(self, t, op):
        import torch.distributed as dist

        dist.all_reduce(t, op={"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op])
        return t


class _Board:
    """What the blocks of one process post for each other: one slot per
    block, a barrier between posting and reading."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n)

    def post_and_read(self, me: int, value, read: Sequence[Optional[int]]):
        self.slots[me] = value
        self.barrier.wait()
        out = [None if i is None else self.slots[i] for i in read]
        self.barrier.wait()
        return out


class ThreadComm(_Grid):
    """One block per device of one process, each in its own thread."""

    def __init__(self, grid, index, board: _Board, device: torch.device):
        super().__init__(grid, index)
        self.board, self.device = board, device
        self.me = (index[0] * grid[1] + index[1]) * grid[2] + index[2]

    def shift(self, face, axis, step, circular):
        if self.grid[axis] == 1:
            return face if circular else torch.zeros_like(face)
        src = self.neighbour(axis, -step, circular)
        (got,) = self.board.post_and_read(self.me, face, [src])
        return torch.zeros_like(face) if got is None else got.to(self.device)

    def all_reduce(self, t, op):
        parts = self.board.post_and_read(self.me, t, range(len(self.board.slots)))
        fn = torch.maximum if op == "max" else torch.minimum
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = fn(out, p.to(self.device))
        return out

