"""Stereo-pair dataset + prefetching batch loader (the counterpart of
``stereomatching_tpu/data/loader.py``).

The reference's data story is two ``read_image`` calls per run
(src/stereo.c:345-348) over a fixture layout ``test/imgs/<name>/a.png``
+ ``b.png``.  A production pipeline needs the input side to keep the
card busy: decode on host threads, assemble fixed-shape batches, and
hand the next batch to the device while the current one computes.

Components:
  * ``discover_pairs`` — finds ``(left, right)`` image pairs under a
    root (the reference's fixture layout, plus ``*_left/right`` naming).
  * ``StereoPairDataset`` — decodes pairs to uint8 [H, W]; validates
    equal shapes (the reference's CLI check, src/stereo.c:350).
  * ``BatchLoader`` — iterator of [B, H, W] float32 brightness batches
    (pixel / 256) with a background decode thread pool and ``prefetch``
    batches in flight, placed on ``device`` (default ``"cuda"``; no GPU
    raises).  On a CUDA device each batch is assembled as uint8 in
    page-locked host memory, copied by a non-blocking copy on a stream of
    the loader's own and divided by 256 there (exact: a power-of-two
    divide), and the consumer's stream waits on that copy's event, not
    the host.  A page-locked buffer is written again only once the event
    of the copy that read it has completed.
"""

from __future__ import annotations

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stereomatching_tpu_torch.utils.imageio import read_png_gray

_PAIR_NAMES = (("a.png", "b.png"), ("left.png", "right.png"))


def discover_pairs(root: str) -> List[Tuple[str, str]]:
    """Find stereo pairs under ``root``: directories containing
    a/b.png or left/right.png (sorted), or flat files matching
    ``<stem>_left.png`` + ``<stem>_right.png``."""
    pairs: List[Tuple[str, str]] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        names = set(filenames)
        for a, b in _PAIR_NAMES:
            if a in names and b in names:
                pairs.append((os.path.join(dirpath, a), os.path.join(dirpath, b)))
        for f in sorted(filenames):
            if f.endswith("_left.png"):
                mate = f[: -len("_left.png")] + "_right.png"
                if mate in names:
                    pairs.append(
                        (os.path.join(dirpath, f), os.path.join(dirpath, mate))
                    )
    return pairs


class StereoPairDataset:
    """Decodes image pairs to uint8 [H, W] on demand."""

    def __init__(self, pairs: Sequence[Tuple[str, str]]):
        self.pairs = list(pairs)

    @classmethod
    def from_root(cls, root: str) -> "StereoPairDataset":
        pairs = discover_pairs(root)
        if not pairs:
            raise FileNotFoundError(f"no stereo pairs under {root}")
        return cls(pairs)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        a, b = self.pairs[i]
        left = read_png_gray(a)
        right = read_png_gray(b)
        if left.shape != right.shape:
            raise ValueError(
                f"{a} / {b}: the two images must have equal width and height"
            )
        return left, right


class _PinnedPool:
    """Page-locked uint8 staging buffers, reused per shape.  A buffer comes
    back with the event of the copy that reads it, and is handed out again
    only after that event has completed."""

    def __init__(self):
        self._free = {}
        self._lock = threading.Lock()
        self.allocated = 0

    def take(self, shape: Tuple[int, ...]):
        import torch

        with self._lock:
            free = self._free.get(shape)
            entry = free.pop() if free else None
            if entry is None:
                self.allocated += 1
        if entry is None:
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        buf, event = entry
        event.synchronize()
        return buf

    def give(self, buf, event) -> None:
        with self._lock:
            self._free.setdefault(tuple(buf.shape), []).append((buf, event))


class BatchLoader:
    """Iterates fixed-shape [B, H, W] float32 brightness batches with
    threaded decode and device prefetch.

    Pairs whose shape differs from the first pair's are skipped with a
    warning (static shapes keep one set of kernels per batch shape);
    ``pad_to`` instead pads every image up to the given (H, W) with
    zeros.  The final partial batch is dropped if ``drop_last`` is True;
    otherwise it is padded by repeating its last pair, and the third item
    of each yielded ``(left, right, kept)`` gives the real count.

    ``device_put=True`` yields tensors on ``device`` ("cuda", the default,
    or "cuda:N" or "cpu"; a CUDA device without a GPU raises); with
    ``mesh`` (``parallel.make_mesh``) on the device where the sharded tier
    reads a global batch (the one ``Matcher(mesh=mesh).device`` names),
    and ``batch_size`` must divide by the mesh's data axis.
    ``device_put=False`` yields numpy arrays.  Every form holds the same
    values: uint8 / 256 in float32.
    """

    def __init__(
        self,
        dataset: StereoPairDataset,
        batch_size: int,
        pad_to: Optional[Tuple[int, int]] = None,
        drop_last: bool = False,
        num_threads: int = 4,
        device_put: bool = True,
        prefetch: int = 2,
        mesh=None,
        device="cuda",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to = pad_to
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.device_put = device_put
        self.prefetch = prefetch
        self.mesh = mesh
        if mesh is not None:
            if batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {batch_size} must divide by the mesh "
                    f"data axis ({mesh.shape['data']})"
                )
        self.device = None
        self._pool = self._copy_stream = None
        if device_put:
            if mesh is not None:
                self.device = mesh.blocks[2][0][0]
            else:
                from stereomatching_tpu_torch.utils.device import resolve_device

                self.device = resolve_device(device)
            if self.device.type == "cuda":
                import torch

                self._pool = _PinnedPool()
                self._copy_stream = torch.cuda.Stream(self.device)

    def _assemble(self, idxs: Sequence[int]):
        decoded = [self.dataset[i] for i in idxs]
        target = self.pad_to or decoded[0][0].shape
        lefts, rights, kept = [], [], 0
        for (l, r), i in zip(decoded, idxs):
            if self.pad_to is None and l.shape != target:
                print(
                    f"warning: skipping pair {i} with shape {l.shape} != {target}",
                    file=sys.stderr,
                )
                continue
            if self.pad_to is not None:
                ph, pw = target[0] - l.shape[0], target[1] - l.shape[1]
                if ph < 0 or pw < 0:
                    raise ValueError(f"pair {i} larger than pad_to {target}")
                l = np.pad(l, ((0, ph), (0, pw)))
                r = np.pad(r, ((0, ph), (0, pw)))
            lefts.append(l)
            rights.append(r)
            kept += 1
        if not lefts:
            return None
        while len(lefts) < self.batch_size:  # pad partial batch
            lefts.append(lefts[-1])
            rights.append(rights[-1])
        if self._pool is not None:
            return (*self._upload(lefts, rights), kept)
        lb = np.stack(lefts).astype(np.float32) / np.float32(256.0)
        rb = np.stack(rights).astype(np.float32) / np.float32(256.0)
        if self.device_put:
            import torch

            lb, rb = torch.from_numpy(lb), torch.from_numpy(rb)
        return lb, rb, None, kept

    def _upload(self, lefts, rights):
        """Stage the uint8 pairs in a page-locked buffer, copy it to the
        card on the copy stream and divide by 256 there -> (left, right,
        the event that follows both)."""
        import torch

        host = self._pool.take((2, len(lefts), *lefts[0].shape))
        staged = host.numpy()
        np.stack(lefts, out=staged[0])
        np.stack(rights, out=staged[1])
        with torch.cuda.stream(self._copy_stream):
            planes = host.to(self.device, non_blocking=True).to(torch.float32).div_(256.0)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._pool.give(host, done)
        return planes[0], planes[1], done

    def _deliver(self, out):
        """-> (left, right, kept); on a CUDA device the caller's current
        stream first waits on the batch's copy, and the batch's memory is
        marked as used by that stream."""
        lb, rb, done, kept = out
        if done is not None:
            import torch

            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            lb.record_stream(stream)
            rb.record_stream(stream)
        return lb, rb, kept

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        n = len(self.dataset)
        batches = [
            list(range(i, min(i + self.batch_size, n)))
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        # One worker per in-flight batch; each batch decodes serially in
        # its worker (no nested pool use, so no saturation deadlock).
        with ThreadPoolExecutor(max(self.num_threads, 1)) as pool:
            pending = []
            for idxs in batches:
                pending.append(pool.submit(self._assemble, idxs))
                # Keep `prefetch` batches in flight.
                while len(pending) > self.prefetch:
                    out = pending.pop(0).result()
                    if out is not None:
                        yield self._deliver(out)
            for fut in pending:
                out = fut.result()
                if out is not None:
                    yield self._deliver(out)
