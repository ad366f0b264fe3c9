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

``Sharded`` is a global array as this process's block tensors (the
counterpart of a ``jax.Array`` under a ``NamedSharding``): what the
sharded pipelines take and return, so that no plane leaves its shard
unless a caller asks for the global array (``to_global``).
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

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and list(self.shape.items()) == list(other.shape.items()))

    def __hash__(self) -> int:
        return hash((self.devices, tuple(self.shape.items())))


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


def _flat_block(index: Tuple[int, int, int], grid: Tuple[int, int, int]) -> int:
    return (index[0] * grid[1] + index[1]) * grid[2] + index[2]


class Shards:
    """One block of a mesh in one call: shards of ``bl`` images of
    ``hs`` x ``ws`` pixels.  Block tensors are [lr, lc, ld * bl, ..., h, w]."""

    def __init__(self, mesh: Mesh, comm, index: Tuple[int, int, int],
                 device: torch.device, bl: int, hs: int, ws: int):
        box, grid = mesh.blocks[:2]
        self.mesh, self.comm, self.device = mesh, comm, device
        self.block = _flat_block(index, grid)  # the flat index of the block
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


# ------------------------------------------------------------ sharded tensors

PLANE = "plane"          # [B, H, W] as P(data, rows[, cols])
PER_IMAGE = "per_image"  # [B] as P(data), the same on every spatial shard
LAYOUTS = (PLANE, PER_IMAGE)


def shard_extent(shape, mesh: Mesh, layout: str = PLANE):
    """Global [B, H, W] (or [B] per image) -> (bl, hs, ws), the per-shard
    extent (hs, ws None per image); raises unless each axis divides by
    its mesh axis."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    want = 3 if layout == PLANE else 1
    if len(shape) != want:
        raise ValueError(f"a {layout} array is {want}-D, got shape {tuple(shape)}")
    nd, nr, nc = mesh.dims
    named = (("batch", nd), ("height", nr), ("width", nc))[:want]
    for (name, k), n in zip(named, shape):
        if n % k:
            raise ValueError(f"{name} {n} does not divide by the mesh's {k} shards on that axis")
    if layout == PER_IMAGE:
        return shape[0] // nd, None, None
    return shape[0] // nd, shape[1] // nr, shape[2] // nc


def _as_tensor(x) -> torch.Tensor:
    """A tensor, or numpy (copied where it is read-only) as one."""
    import numpy as np

    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def block_view(x: torch.Tensor, mesh: Mesh, j: int) -> torch.Tensor:
    """The view of flat block ``j`` in global planes x [..., B, H, W]
    (leading axes kept): [..., lr, lc, ld, bl, hs, ws].  Reshaped to
    [..., lr, lc, ld * bl, hs, ws] it is the block tensor; written to, it
    writes into x."""
    (ld, lr, lc), grid = mesh.blocks[:2]
    nd, nr, nc = mesh.dims
    *lead, b, h, w = x.shape
    d0, r0, c0 = (i * k for i, k in zip(_block_index(j, grid), (ld, lr, lc)))
    v = x.reshape(*lead, nd, b // nd, nr, h // nr, nc, w // nc)
    v = v[..., d0:d0 + ld, :, r0:r0 + lr, :, c0:c0 + lc, :]
    k = len(lead)
    return v.permute(*range(k), k + 2, k + 4, k, k + 1, k + 3, k + 5)


def _shard_places(mesh: Mesh, j: int) -> list:
    """-> [(global shard position (d, r, c), its place (dl, rl, cl) in the
    block)] for flat block ``j``, in mesh order."""
    box, grid = mesh.blocks[:2]
    i = _block_index(j, grid)
    return [((i[0] * box[0] + dl, i[1] * box[1] + rl, i[2] * box[2] + cl), (dl, rl, cl))
            for dl in range(box[0]) for rl in range(box[1]) for cl in range(box[2])]


def _shard_index(mesh: Mesh, extent, layout: str, pos) -> tuple:
    """A shard's global index as JAX's ``Shard.index`` gives it: a slice
    per axis, ``slice(None)`` where the mesh axis has size 1."""
    def cut(i, n, k):
        return slice(i * k, (i + 1) * k) if n > 1 else slice(None)

    axes = 1 if layout == PER_IMAGE else 3
    return tuple(cut(i, n, k) for i, n, k in zip(pos[:axes], mesh.dims, extent))


class Sharded:
    """A global array laid out over a mesh, the counterpart of a
    ``jax.Array`` under ``NamedSharding(mesh, P(...))``.  ``layout`` is
    ``PLANE`` (a [B, H, W] batch as P(data, rows[, cols])) or
    ``PER_IMAGE`` (a [B] vector as P(data), the same on every spatial
    shard).  It holds the blocks of this process only (``mesh.blocks``'
    local list, in that order), each on its block's device as a block
    tensor: [lr, lc, ld * bl, hs, ws] for a plane, [lr, lc, ld * bl] per
    image.

    ``from_global`` places a global array (``jax.device_put``),
    ``from_callback`` builds the blocks from the shards this process
    holds (``jax.make_array_from_callback``), ``addressable_shards``
    lists them by their global index, and ``to_global`` (or
    ``np.asarray``) assembles the global array: across ranks an
    all-gather that every rank calls."""

    def __init__(self, mesh: Mesh, shape, layout: str, blocks: Sequence[torch.Tensor]):
        self.mesh, self.shape, self.layout = mesh, tuple(shape), layout
        self.extent = shard_extent(self.shape, mesh, layout)
        local = mesh.blocks[2]
        if len(blocks) != len(local):
            raise ValueError(f"{len(blocks)} blocks for the {len(local)} this process holds")
        want = _block_shape(mesh, self.extent, layout)
        for (dev, j), blk in zip(local, blocks):
            if tuple(blk.shape) != want:
                raise ValueError(f"block {j} has shape {tuple(blk.shape)}, want {want}")
        self.blocks = tuple(blocks)
        self.dtype = self.blocks[0].dtype

    def __repr__(self) -> str:
        return (f"Sharded({self.layout}, shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh.shape}, blocks={len(self.blocks)})")

    def block(self, j: int) -> torch.Tensor:
        """The block tensor of flat block ``j``, one this process holds."""
        for (_, i), blk in zip(self.mesh.blocks[2], self.blocks):
            if i == j:
                return blk
        raise KeyError(f"block {j} is not held by this process")

    @property
    def addressable_shards(self) -> list:
        """[(index, tensor)] for every shard of this process's blocks:
        the tuple of global slices and the shard's [bl, hs, ws] (or [bl])
        view of its block, on the block's device."""
        bl = self.extent[0]
        return [(_shard_index(self.mesh, self.extent, self.layout, pos),
                 blk[rl, cl, dl * bl:(dl + 1) * bl])
                for (_, j), blk in zip(self.mesh.blocks[2], self.blocks)
                for pos, (dl, rl, cl) in _shard_places(self.mesh, j)]

    @classmethod
    def from_global(cls, x, mesh: Mesh, layout: str = PLANE) -> "Sharded":
        """Cut a global array (a tensor on any device, or numpy) into this
        process's blocks, each copied to its block's device."""
        x = _as_tensor(x)
        bl, hs, ws = shard_extent(tuple(x.shape), mesh, layout)
        (ld, lr, lc), _, local, _ = mesh.blocks
        blocks = []
        for dev, j in local:
            if layout == PER_IMAGE:
                d0 = _block_index(j, mesh.blocks[1])[0] * ld * bl
                v = x[d0:d0 + ld * bl].expand(lr, lc, ld * bl)
            else:
                v = block_view(x, mesh, j).reshape(lr, lc, ld * bl, hs, ws)
            blocks.append(v.contiguous().to(dev))
        return cls(mesh, x.shape, layout, blocks)

    @classmethod
    def from_callback(cls, shape, mesh: Mesh, cb: Callable, layout: str = PLANE) -> "Sharded":
        """Build the array from ``cb(index)`` -> the shard at ``index`` (a
        tuple of global slices, as ``addressable_shards`` gives it; numpy
        or a tensor), called only for the shards of this process's
        blocks, which must all have one dtype."""
        extent = shard_extent(tuple(shape), mesh, layout)
        bl = extent[0]
        want = extent if layout == PLANE else (bl,)
        blocks, dtypes = [], set()
        for dev, j in mesh.blocks[2]:
            parts = []
            for pos, place in _shard_places(mesh, j):
                index = _shard_index(mesh, extent, layout, pos)
                part = _as_tensor(cb(index))
                if tuple(part.shape) != want:
                    raise ValueError(f"the callback gave shape {tuple(part.shape)} for "
                                     f"index {index}, want {want}")
                dtypes.add(part.dtype)
                if len(dtypes) > 1:
                    raise ValueError(f"the callback gave shards of several dtypes "
                                     f"({sorted(map(str, dtypes))}), at index {index}")
                parts.append((place, part))
            blk = torch.empty(_block_shape(mesh, extent, layout), dtype=parts[0][1].dtype,
                              device=dev)
            for (dl, rl, cl), part in parts:
                blk[rl, cl, dl * bl:(dl + 1) * bl] = part.to(dev)
            blocks.append(blk)
        return cls(mesh, shape, layout, blocks)

    def reduce(self, op: str = "sum") -> torch.Tensor:
        """Every element of the global array reduced to one scalar on
        this process's first block's device: ``"sum"`` (in float64),
        ``"min"`` or ``"max"`` (in the array's dtype).  Each held block is
        reduced, then one all-reduce runs across ranks, a collective that
        every rank calls; no plane is gathered.  A per-image array counts
        each image once."""
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
        grid, local, rank = self.mesh.blocks[1:]
        dev = self.blocks[0].device
        if op == "sum":
            out = torch.zeros((), dtype=torch.float64, device=dev)
            for (_, j), blk in zip(local, self.blocks):
                if self.layout == PLANE:
                    out += blk.sum(dtype=torch.float64).to(dev)
                elif _block_index(j, grid)[1:] == (0, 0):  # the copy on the first spatial block
                    out += blk[0, 0].sum(dtype=torch.float64).to(dev)
        elif op in ops:
            fn = torch.amin if op == "min" else torch.amax
            out = fn(torch.stack([fn(blk).to(dev) for blk in self.blocks]))
        else:
            raise ValueError(f"op must be one of {sorted(ops)}, got {op!r}")
        if rank is not None:
            dist.all_reduce(out, ops[op])
        return out

    def to_global(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the device of this
        process's first block).  In one process the blocks are placed
        into it; across ranks the blocks are all-gathered first, a
        collective that every rank calls."""
        (ld, lr, lc), grid, local, rank = self.mesh.blocks
        device = local[0][0] if device is None else torch.device(device)
        if rank is not None:
            import torch.distributed as dist

            mine = self.blocks[0].contiguous()
            parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, mine)
            pieces = list(enumerate(parts))
        else:
            pieces = [(j, blk) for (_, j), blk in zip(local, self.blocks)]
        bl, hs, ws = self.extent
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for j, blk in pieces:
            blk = blk.to(device)
            if self.layout == PER_IMAGE:
                d0 = _block_index(j, grid)[0] * ld * bl
                out[d0:d0 + ld * bl] = blk[0, 0]
            else:
                block_view(out, self.mesh, j).copy_(blk.reshape(lr, lc, ld, bl, hs, ws))
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.to_global().cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def _block_shape(mesh: Mesh, extent, layout: str) -> Tuple[int, ...]:
    ld, lr, lc = mesh.blocks[0]
    bl, hs, ws = extent
    return (lr, lc, ld * bl, hs, ws) if layout == PLANE else (lr, lc, ld * bl)


def outputs_to_global(outputs, device=None) -> dict:
    """An output dict with ``Sharded`` values -> the same dict with each
    gathered by ``to_global(device)`` (in key order: on every rank the
    same collectives)."""
    return {k: v.to_global(device) if isinstance(v, Sharded) else v
            for k, v in outputs.items()}
