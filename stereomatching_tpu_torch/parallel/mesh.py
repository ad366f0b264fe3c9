"""The device mesh of the sharded tier (counterpart of
``stereomatching_tpu/parallel/mesh.py``) and the local view of its
shards.

Axes, as in the JAX package:
  * ``data`` -- independent stereo pairs;
  * ``rows`` -- image rows, stitched by halo exchanges (``halo.py``);
  * ``cols`` (optional) -- image columns, with x halos sized to the x
    dependency reach.

A mesh is a list of devices, one per shard, in (data, rows, cols) order.
The list may repeat a device: shards that share a device live in one
process on it, stacked, and exchange halos by slicing (the counterpart of
the JAX tests' 8 virtual CPU devices).  The shards split into equal
contiguous blocks -- one per ``torch.distributed`` rank when a process
group is up, else one per run of equal devices -- and each block must be
an aligned box of the mesh.

``Shards`` is one block's view of a call: its box of the mesh, the shard
extent, and the block tensor layout [lr, lc, ld * bl, ..., h, w] (local
row positions, local column positions, the block's images, then the
per-shard planes), which every per-shard stage flattens to one launch
over all the block's shards.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from stereomatching_tpu_torch.parallel import distributed

DATA_AXIS = "data"
ROWS_AXIS = "rows"
COLS_AXIS = "cols"


class Mesh:
    """Shards over devices: ``shape`` maps each axis name to its size,
    ``devices`` lists one device per shard in (data, rows, cols) order."""

    def __init__(self, devices: Sequence[torch.device], shape: dict):
        self.devices = tuple(devices)
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.dims = (self.shape[DATA_AXIS], self.shape[ROWS_AXIS],
                     self.shape.get(COLS_AXIS, 1))
        self.blocks = _blocks(self.devices, self.dims)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _default_devices() -> list:
    """One device per rank across a process group (each rank's current
    CUDA device, or the CPU for a gloo group), else every visible CUDA
    device; raises without a GPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        world = dist.get_world_size()
        if dist.get_backend() == "gloo":
            return [torch.device("cpu")] * world
        return [torch.device("cuda", torch.cuda.current_device())] * world
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is visible (torch.cuda.is_available() "
            "is False); a CPU mesh must be asked for by name, "
            "devices=['cpu'] * n")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: int = 1,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, rows) mesh -- or (data, rows, cols) when ``cols`` is
    given -- over ``devices`` (names or ``torch.device``; default: the
    visible CUDA devices, or one per rank of a process group).  ``rows``
    defaults to all remaining devices."""
    devices = list(devices) if devices is not None else _default_devices()
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: device {d} requested but no CUDA device is visible")
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"make_mesh: unsupported device {d}")
    n = len(devices)
    c = 1 if cols is None else cols
    if rows is None:
        if n % (data * c) != 0:
            raise ValueError(f"{n} devices not divisible by data={data} * cols={c}")
        rows = n // (data * c)
    if data * rows * c != n:
        raise ValueError(f"mesh {data}x{rows}x{c} != {n} devices")
    shape = {DATA_AXIS: data, ROWS_AXIS: rows}
    if cols is not None:
        shape[COLS_AXIS] = cols
    return Mesh(devices, shape)


def mesh_cols(mesh: Mesh) -> int:
    """Size of the cols axis, 1 when the mesh has none."""
    return mesh.shape.get(COLS_AXIS, 1)


def _box(k: int, dims: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Shape of a block of ``k`` consecutive shards of the (data, rows,
    cols) grid ``dims``, which must be an aligned box."""
    nd, nr, nc = dims
    if k % (nr * nc) == 0 and nd % (k // (nr * nc)) == 0:
        return k // (nr * nc), nr, nc
    if k % nc == 0 and k < nr * nc and nr % (k // nc) == 0:
        return 1, k // nc, nc
    if k < nc and nc % k == 0:
        return 1, 1, k
    raise ValueError(f"blocks of {k} shards do not tile the mesh {dims} as boxes")


def _blocks(devices, dims):
    """-> (box shape, grid of blocks, [(block device, flat block index)]
    of the blocks this process holds, a process group's rank or None)."""
    import torch.distributed as dist

    n = len(devices)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n % world:
            raise ValueError(f"{n} shards do not split over {world} ranks")
        k = n // world
        mine = devices[rank * k:(rank + 1) * k]
        if len(set(mine)) != 1:
            raise ValueError(f"rank {rank}'s shards span devices {sorted(map(str, set(mine)))}")
        local = [(mine[0], rank)]
    else:
        runs = []
        for i, d in enumerate(devices):
            if runs and runs[-1][0] == d:
                continue
            runs.append((d, i))
        k = n // len(runs)
        if any(list(devices[i:i + k]) != [d] * k for d, i in runs) or len({d for d, _ in runs}) != len(runs):
            raise ValueError("each device must hold one contiguous run of equally many shards")
        local = [(d, j) for j, (d, _) in enumerate(runs)]
        rank = None
    box = _box(k, dims)
    grid = tuple(n_ // b for n_, b in zip(dims, box))
    return box, grid, local, rank


def _block_index(j: int, grid: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(data, rows, cols) position of flat block ``j`` in the block grid."""
    return j // (grid[1] * grid[2]), (j // grid[2]) % grid[1], j % grid[2]


class Shards:
    """One block of a mesh in one call: shards of ``bl`` images of
    ``hs`` x ``ws`` pixels.  Block tensors are [lr, lc, ld * bl, ..., h, w]."""

    def __init__(self, mesh: Mesh, comm, index: Tuple[int, int, int],
                 device: torch.device, bl: int, hs: int, ws: int):
        box = mesh.blocks[0]
        self.mesh, self.comm, self.device = mesh, comm, device
        self.n_data, self.n_rows, self.n_cols = mesh.dims
        self.has_cols = COLS_AXIS in mesh.axis_names
        self.ld, self.lr, self.lc = box
        self.d0, self.r0, self.c0 = (i * b for i, b in zip(index, box))
        self.bl, self.hs, self.ws = bl, hs, ws
        self.n = self.ld * bl  # images per shard position of the block

    # --- positions -------------------------------------------------------

    def first(self, axis: str) -> bool:
        """Whether the block holds the global first shard along ``axis``."""
        return (self.r0 if axis == ROWS_AXIS else self.c0) == 0

    def last(self, axis: str) -> bool:
        """Whether the block holds the global last shard along ``axis``."""
        if axis == ROWS_AXIS:
            return self.r0 + self.lr == self.n_rows
        return self.c0 + self.lc == self.n_cols

    def offsets(self, axis: str, extent: int, start: int = 0) -> torch.Tensor:
        """int32 [lr, lc, n]: for each image of the block, the global
        index along ``axis`` of its shard's element ``start`` (shard
        position x ``extent`` + ``start``), the per-shard form of JAX's
        ``axis_index``."""
        r = torch.arange(self.r0, self.r0 + self.lr, device=self.device)
        c = torch.arange(self.c0, self.c0 + self.lc, device=self.device)
        pos = r[:, None] if axis == ROWS_AXIS else c[None, :]
        pos = pos.expand(self.lr, self.lc)
        return (pos * extent + start).to(torch.int32)[..., None].expand(
            self.lr, self.lc, self.n).contiguous()

    # --- layout ----------------------------------------------------------

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """[lr, lc, n, ...] -> [lr * lc * n, ...] (one launch over all)."""
        return x.reshape(-1, *x.shape[3:])

    def unflat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.lr, self.lc, self.n, *x.shape[1:])

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Global [B, H, W] -> this block's [lr, lc, n, hs, ws] on its device."""
        nd, nr, nc = self.n_data, self.n_rows, self.n_cols
        v = x.reshape(nd, self.bl, nr, self.hs, nc, self.ws)
        v = v[self.d0:self.d0 + self.ld, :, self.r0:self.r0 + self.lr, :,
              self.c0:self.c0 + self.lc, :]
        v = v.permute(2, 4, 0, 1, 3, 5).reshape(self.lr, self.lc, self.n, self.hs, self.ws)
        return v.to(self.device).contiguous()

    def _place(self, out: torch.Tensor, blk: torch.Tensor, index) -> None:
        ld, lr, lc = self.ld, self.lr, self.lc
        d0, r0, c0 = (i * b for i, b in zip(index, (ld, lr, lc)))
        if blk.ndim == 3:  # per-image values [lr, lc, n] (equal over lr, lc)
            out.view(self.n_data, self.bl)[d0:d0 + ld] = blk[0, 0].view(ld, self.bl)
            return
        v = blk.reshape(lr, lc, ld, self.bl, self.hs, self.ws).permute(2, 3, 0, 4, 1, 5)
        o = out.view(self.n_data, self.bl, self.n_rows, self.hs, self.n_cols, self.ws)
        o[d0:d0 + ld, :, r0:r0 + lr, :, c0:c0 + lc, :] = v

    def gather(self, blk: torch.Tensor) -> torch.Tensor:
        """A block's planes [lr, lc, n, hs, ws] (or per-image values
        [lr, lc, n]) -> the global [B, H, W] (or [B]) on every block."""
        b = self.n_data * self.bl
        shape = (b,) if blk.ndim == 3 else (b, self.n_rows * self.hs, self.n_cols * self.ws)
        out = torch.empty(shape, dtype=blk.dtype, device=self.device)
        grid = self.mesh.blocks[1]
        for j, part in enumerate(self.comm.all_gather(blk.contiguous())):
            self._place(out, part, _block_index(j, grid))
        return out

    def reduce_images(self, v: torch.Tensor, op: str) -> torch.Tensor:
        """Per-image ``op`` ("max" or "min") over every shard of the
        image: v [lr, lc, n] -> [lr, lc, n], each shard holding its
        image's value (JAX's pmax / pmin over the spatial axes)."""
        v = v.amax(dim=(0, 1)) if op == "max" else v.amin(dim=(0, 1))
        if self.mesh.blocks[1][1:] != (1, 1):
            ident = torch.iinfo(v.dtype).min if op == "max" else torch.iinfo(v.dtype).max
            full = torch.full((self.n_data * self.bl,), ident, dtype=v.dtype, device=v.device)
            full[self.d0 * self.bl:(self.d0 + self.ld) * self.bl] = v
            v = self.comm.all_reduce(full, op)[self.d0 * self.bl:(self.d0 + self.ld) * self.bl]
        return v.expand(self.lr, self.lc, self.n).contiguous()


def run(mesh: Mesh, bl: int, hs: int, ws: int, body: Callable[[Shards], object]) -> list:
    """Run ``body(shards)`` for every block this process holds (its
    communicator chosen by the mesh's layout) -> their results.  Several
    blocks (devices) in one process run in threads that meet at a
    barrier; an exception in one breaks the barrier for all and is
    re-raised."""
    box, grid, local, rank = mesh.blocks
    index = functools.partial(_block_index, grid=grid)
    if rank is not None:
        import torch.distributed as dist

        dev, j = local[0]
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise ValueError(f"{dev.type} shards across ranks need the {want} backend, "
                             f"not {dist.get_backend()}")
        comm = distributed.DistComm(grid, index(j))
        return [body(Shards(mesh, comm, index(j), dev, bl, hs, ws))]
    if len(local) == 1:
        dev, j = local[0]
        return [body(Shards(mesh, distributed.LocalComm(), index(j), dev, bl, hs, ws))]
    board = distributed._Board(len(local))

    def one(dev, j):
        comm = distributed.ThreadComm(grid, index(j), board, dev)
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return body(Shards(mesh, comm, index(j), dev, bl, hs, ws))
            return body(Shards(mesh, comm, index(j), dev, bl, hs, ws))
        except BaseException:
            board.barrier.abort()
            raise

    with concurrent.futures.ThreadPoolExecutor(len(local)) as pool:
        futs = [pool.submit(one, dev, j) for dev, j in local]
        errors = [f.exception() for f in futs]
    # The first error that is not another block's broken barrier.
    errors = [e for e in errors if e is not None]
    errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
    if errors:
        raise errors[0]
    return [f.result() for f in futs]
