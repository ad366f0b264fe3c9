"""Data loading: stereo-pair datasets, a prefetching batch loader that
places batches on the card, and ground-truth disparity formats (PFM /
16-bit disparity PNG) -- the counterpart of ``stereomatching_tpu/data``."""

from stereomatching_tpu_torch.data.loader import (
    StereoPairDataset,
    BatchLoader,
    discover_pairs,
)
from stereomatching_tpu_torch.data.formats import (
    read_pfm,
    write_pfm,
    read_disparity_png,
    write_disparity_png,
    read_ground_truth,
)

__all__ = [
    "StereoPairDataset",
    "BatchLoader",
    "discover_pairs",
    "read_pfm",
    "write_pfm",
    "read_disparity_png",
    "write_disparity_png",
    "read_ground_truth",
]
