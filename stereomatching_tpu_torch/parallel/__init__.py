"""The sharded tier: the pipelines over a (data, rows[, cols]) mesh of
shards (counterpart of ``stereomatching_tpu/parallel``).

Batches shard over "data", image rows over "rows" and optionally columns
over "cols"; halo strips move between neighbouring shards, each exchange
as wide as the dependency it feeds (the reference's ghost-zone rule,
src/stereo-ghost.c:11-12).  Shards that share a device are stacked and
run each stage as one launch; blocks of shards on other devices or ranks
exchange through ``torch.distributed`` (or, in one process, device
copies).

Inputs and outputs are sharded, as the JAX tier's ``shard_map`` takes
and returns them: ``Sharded`` holds this process's blocks of a global
array (``from_global`` places one, ``from_callback`` builds one from
the shards this process holds), the pipelines return their planes and
per-image values that way, and ``to_global`` / ``outputs_to_global``
assemble the global arrays where a caller asks for them.
"""

from stereomatching_tpu_torch.parallel.mesh import (
    PER_IMAGE,
    PLANE,
    Sharded,
    make_mesh,
    mesh_cols,
    outputs_to_global,
)
from stereomatching_tpu_torch.parallel.halo import (
    exchange_col_halo,
    exchange_row_halo,
    with_col_halo,
    with_row_halo,
)
from stereomatching_tpu_torch.parallel.pipeline import (
    build_sharded_pipeline,
    sharded_classic_forward,
)
from stereomatching_tpu_torch.parallel.modern import (
    build_sharded_modern_pipeline,
    sharded_modern_forward,
)

__all__ = [
    "make_mesh",
    "mesh_cols",
    "Sharded",
    "PLANE",
    "PER_IMAGE",
    "outputs_to_global",
    "exchange_row_halo",
    "exchange_col_halo",
    "with_row_halo",
    "with_col_halo",
    "build_sharded_pipeline",
    "sharded_classic_forward",
    "build_sharded_modern_pipeline",
    "sharded_modern_forward",
]
