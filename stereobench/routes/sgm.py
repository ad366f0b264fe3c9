"""The census SGM route: ``stereomatching_tpu_torch.models.build_modern_pipeline``
(``ModernPipeline.forward``) on int32 pixels 0..255 [B, H, W], held to
``reference/sgm.py``."""

from __future__ import annotations

import json
from typing import Callable, Dict

import torch

from stereobench import workmodel
from stereobench.reference import sgm as reference_impl

# right(x) = left(x + d): the left view's L(x) matches R(x - d).
SIGN = 1
# Every plane the program's forward returns (census, K3's volume, K4's
# paths, K5's argmin, sub-pixel and right view, the LR check, K6's fill).
PLANES = ("disparity", "subpixel", "disparity_right", "valid", "filled", "cost")


def max_shift(params: Dict) -> int:
    return params["num_disparities"] - 1


def reference_block(params: Dict, h: int, w: int) -> int:
    """Pairs per block of the reference: 1600 Mi volume elements, so that
    its int32 volume and aggregate stay near 6 GiB each."""
    return max(1, 1600 * 2**20 // (h * w * params["num_disparities"]))


def program(params: Dict) -> Callable:
    """The system under test: the port's modern pipeline for ``params``."""
    from stereomatching_tpu_torch.config import ModernParams
    from stereomatching_tpu_torch.models import build_modern_pipeline

    return build_modern_pipeline(ModernParams.from_json(json.dumps(params)))


def inputs(left_u8: torch.Tensor, right_u8: torch.Tensor):
    """The pipeline's input: int32 pixels."""
    return tuple(x.to(torch.int32) for x in (left_u8, right_u8))


def reference(left: torch.Tensor, right: torch.Tensor, params: Dict,
              float_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return reference_impl.forward(left, right, params, float_dtype)


def stages(params: Dict, h: int, w: int) -> Dict[str, workmodel.Work]:
    return workmodel.sgm_stages(params, h, w)
