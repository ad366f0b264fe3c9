"""The classic route: ``stereomatching_tpu_torch.models.build_classic_pipeline``
(``ClassicPipeline.forward``) on float32 brightness (pixel / 256)
[B, H, W], held to ``reference/classic.py``."""

from __future__ import annotations

import json
from typing import Callable, Dict

import torch

from stereobench import workmodel
from stereobench.reference import classic as reference_impl

# right(x) = left(x - d): the classic matcher compares L(x) with R(x + i).
SIGN = -1
# Every plane the program's forward returns (K1's match, score and argmax
# with its edges, K2's diffusion with the elevation range, the contour).
PLANES = ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0",
          "min_elevation", "max_elevation")


def max_shift(params: Dict) -> int:
    """The largest shift the matcher can find."""
    return params["num_shifts"] - 1


def reference_block(params: Dict, h: int, w: int) -> int:
    """Pairs per block of the reference: 8 Mi pixels, so that a block's
    int32 planes stay a few GiB."""
    return max(1, 8 * 2**20 // (h * w))


def program(params: Dict) -> Callable:
    """The system under test: the port's classic pipeline for ``params``."""
    from stereomatching_tpu_torch.config import StereoParams
    from stereomatching_tpu_torch.models import build_classic_pipeline

    return build_classic_pipeline(StereoParams.from_json(json.dumps(params)))


def inputs(left_u8: torch.Tensor, right_u8: torch.Tensor):
    """The pipeline's input: float32 brightness, pixel / 256."""
    return tuple(x.to(torch.float32) / 256.0 for x in (left_u8, right_u8))


def reference(left: torch.Tensor, right: torch.Tensor, params: Dict,
              float_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return reference_impl.forward(left, right, params, float_dtype)


def stages(params: Dict, h: int, w: int) -> Dict[str, workmodel.Work]:
    if params["edge_rule"] != "exact":
        return {}
    return workmodel.classic_stages(params, h, w)
