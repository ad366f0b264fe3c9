"""Serving API: ``Matcher`` runs the classic pipeline on one device
(counterpart of ``stereomatching_tpu/serving.py::Matcher``).

    matcher = Matcher(StereoParams(num_shifts=64, edge_rule="exact"), device="cuda")
    arts = matcher(left_u8, right_u8)      # dict of numpy arrays

It accepts uint8 pixel arrays (brightness = pixel / 256, float32) or
brightness floats, single pairs [H, W] or batches [B, H, W].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from stereomatching_tpu.config import StereoParams
from stereomatching_tpu_torch.interop import artifacts_to_numpy
from stereomatching_tpu_torch.models.classic import ClassicPipeline
from stereomatching_tpu_torch.utils.device import resolve_device


class Matcher:
    """Classic-pipeline runner on ``device`` ("cuda" runs the kernels,
    "cpu" their plain versions; a missing GPU raises)."""

    def __init__(
        self,
        params: Optional[StereoParams] = None,
        device: str | torch.device = "cuda",
    ):
        self.params = params or StereoParams(edge_rule="exact")
        self.device = resolve_device(device)
        self.pipeline = ClassicPipeline(self.params).eval()

    @staticmethod
    def _to_brightness(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.integer):
            return img.astype(np.float32) / np.float32(256.0)
        return img.astype(np.float32)

    def __call__(self, left: np.ndarray, right: np.ndarray) -> Dict[str, np.ndarray]:
        lb = self._to_brightness(left)
        rb = self._to_brightness(right)
        if lb.shape != rb.shape:
            raise ValueError("the two images must have equal width and height")
        if lb.ndim not in (2, 3):
            raise ValueError(f"need [H, W] or [B, H, W], got {lb.shape}")
        lt = torch.from_numpy(lb).to(self.device)
        rt = torch.from_numpy(rb).to(self.device)
        return artifacts_to_numpy(self.pipeline(lt, rt))
