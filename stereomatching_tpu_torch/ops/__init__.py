"""Ops of the port: plain torch phases (``edges``, ``matching``,
``aggregate``, ``argmax``, ``diffusion``, ``contour``, ``costvolume``,
``sgm``) and the kernel wrappers (``fused``, ``fused_diffusion``,
``fused_sgm``, ``fused_modern``), each module importable on its own.

The package re-exports the JAX package's op names from the port modules
of the same names.  The one name without a same-named counterpart is
the JAX ``match_and_score_pallas``: its counterpart is the kernel
wrapper ``fused.match_and_score`` (K8), exported here as
``match_and_score_kernel`` beside the plain ``match_and_score``.  No
kernel is built at import: each wrapper builds its library at its first
launch on a CUDA tensor.
"""

from stereomatching_tpu_torch.ops.aggregate import box_sum
from stereomatching_tpu_torch.ops.argmax import match_and_score, match_and_score_collect
from stereomatching_tpu_torch.ops.contour import draw_contour
from stereomatching_tpu_torch.ops.costvolume import (
    argmin_subpixel_scan,
    fill_invalid,
    lr_consistency,
    sad_disparity,
)
from stereomatching_tpu_torch.ops.diffusion import fill_web_holes
from stereomatching_tpu_torch.ops.edges import find_edges
from stereomatching_tpu_torch.ops.fused import match_and_score as match_and_score_kernel
from stereomatching_tpu_torch.ops.matching import extend_right_edges, match_plane

__all__ = [
    "find_edges",
    "extend_right_edges",
    "match_plane",
    "box_sum",
    "match_and_score",
    "match_and_score_collect",
    "fill_web_holes",
    "draw_contour",
    "match_and_score_kernel",
    "argmin_subpixel_scan",
    "sad_disparity",
    "lr_consistency",
    "fill_invalid",
]
