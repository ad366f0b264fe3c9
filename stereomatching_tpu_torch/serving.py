"""Serving API on one device or a mesh of shards (counterpart of
``stereomatching_tpu/serving.py``):

    matcher = Matcher(StereoParams(num_shifts=64, edge_rule="exact"), device="cuda")
    arts = matcher(left_u8, right_u8)      # classic artifacts, numpy

    box = ModernMatcher(device="cuda")     # ModernParams(): SAD, window 9, D=64
    out = box(left_u8, right_u8)           # disparity, subpixel, ... numpy

    sgm = ModernMatcher(ModernParams(num_disparities=64, aggregation="sgm",
                                     cost="census", sgm_directions=8,
                                     median_filter=True, uniqueness=True))
    sgm.warmup((1024, 1024), batch=8)      # build the kernels before serving

A stage whose CUDA kernel does not take the params (a square width above
255, a tile past the card's shared memory, more than 256 disparities for
K7 and K4) runs its plain torch version on the device; the matchers name
those stages and the reasons in ``plain_stages`` ({stage: why}), decided
from the params before any launch.

``Matcher`` accepts uint8 pixel arrays (brightness = pixel / 256,
float32) or brightness floats; ``ModernMatcher`` takes 0..255 integer
pixels.  Both take single pairs [H, W] or batches [B, H, W].

With ``mesh=`` (``parallel.make_mesh``) either runs the sharded tier
instead: the batch is split over the mesh's data axis (padded up to a
multiple of it by repeating the last pair, the padding sliced away) and
each image's rows (and columns) over its spatial axes:

    mesh = make_mesh(data=2, rows=4, devices=["cuda:0"] * 8)
    arts = Matcher(params, mesh=mesh)(left_u8, right_u8)

A batch already laid out on the matcher's mesh (``parallel.Sharded``, as
``BatchLoader(mesh=mesh)`` yields it: float32 brightness for ``Matcher``,
integer pixels for ``ModernMatcher``) goes straight in, block by block;
any other sharded batch is gathered first (``np.asarray``).  Either way
the outputs are gathered (``to_global``) and returned as numpy arrays of
the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from stereomatching_tpu_torch.config import ModernParams, StereoParams
from stereomatching_tpu_torch.interop import artifacts_to_numpy
from stereomatching_tpu_torch.models import classic, modern
from stereomatching_tpu_torch.models.classic import ClassicPipeline
from stereomatching_tpu_torch.models.modern import ModernPipeline
from stereomatching_tpu_torch.parallel.mesh import PLANE, Sharded, outputs_to_global
from stereomatching_tpu_torch.utils.device import resolve_device


def _warmup(pipeline, device: torch.device, dtype: torch.dtype,
            hw: Tuple[int, int], batch: Optional[int]) -> None:
    """Run one zero batch [batch, H, W] (or one [H, W] pair) through
    ``pipeline`` (a matcher's tensor route) on ``device`` and wait for
    it: on a CUDA device this builds and loads every kernel of the route."""
    shape = (batch, *hw) if batch else tuple(hw)
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    pipeline(zeros, zeros)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _straight_in(mesh, left, right, floating: bool) -> bool:
    """Whether a pair goes straight into the sharded tier: two equal
    ``Sharded`` planes of ``mesh`` (whose batch the data axis divides, as
    every plane of the mesh's does) of float32 brightness (``floating``)
    or integer pixels."""
    def fits(x):
        if not (isinstance(x, Sharded) and x.mesh == mesh and x.layout == PLANE):
            return False
        if floating:
            return x.dtype == torch.float32
        return not x.dtype.is_floating_point and x.dtype != torch.bool

    return mesh is not None and fits(left) and fits(right) and left.shape == right.shape


def _run_sharded(fn, mesh, lt, rt, device: torch.device) -> Dict[str, torch.Tensor]:
    """The sharded tier on a pair or batch, gathered on ``device``.  A
    sharded batch goes straight in.  Otherwise a pair becomes a batch of
    one, the batch is padded up to a multiple of the data axis by
    repeating its last pair, and the padding is sliced away again; a
    height that does not divide by the rows axis is refused."""
    from stereomatching_tpu_torch.parallel.mesh import DATA_AXIS, ROWS_AXIS

    if isinstance(lt, Sharded):
        return outputs_to_global(fn(lt, rt), device)
    squeeze = lt.ndim == 2
    if squeeze:
        lt, rt = lt[None], rt[None]
    n_real = lt.shape[0]
    n_data, n_rows = mesh.shape[DATA_AXIS], mesh.shape[ROWS_AXIS]
    if lt.shape[1] % n_rows:
        raise ValueError(
            f"height {lt.shape[1]} must divide by the mesh rows axis ({n_rows})")
    if n_real % n_data:
        pad = n_data - n_real % n_data
        lt = torch.cat([lt, lt[-1:].expand(pad, *lt.shape[1:])])
        rt = torch.cat([rt, rt[-1:].expand(pad, *rt.shape[1:])])
    out = outputs_to_global(fn(lt, rt), device)
    if squeeze:
        return {k: v[0] for k, v in out.items()}
    return {k: v[:n_real] for k, v in out.items()}


class Matcher:
    """Classic-pipeline runner on ``device`` ("cuda" runs the kernels,
    "cpu" their plain versions; a missing GPU raises), or with ``mesh``
    the sharded tier over the mesh's devices."""

    def __init__(
        self,
        params: Optional[StereoParams] = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.params = params or StereoParams(edge_rule="exact")
        self.mesh = mesh
        self.plain_stages = classic.plain_stages(self.params, sharded=mesh is not None)
        if mesh is None:
            self.device = resolve_device(device)
            self.pipeline = ClassicPipeline(self.params).eval()
        else:
            from stereomatching_tpu_torch.parallel import build_sharded_pipeline

            self.device = mesh.blocks[2][0][0]
            self.pipeline = build_sharded_pipeline(self.params, mesh)

    @staticmethod
    def _to_brightness(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.integer):
            return img.astype(np.float32) / np.float32(256.0)
        return img.astype(np.float32)

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        """Build and load the route's kernels ahead of serving by running
        one zero batch of (H, W) pairs (or one pair) on the device (with
        a mesh, through the sharded tier)."""
        _warmup(self._run, self.device, torch.float32, hw, batch)

    def __call__(self, left: np.ndarray, right: np.ndarray) -> Dict[str, np.ndarray]:
        if _straight_in(self.mesh, left, right, floating=True):
            return artifacts_to_numpy(self._run(left, right))
        lb = self._to_brightness(left)
        rb = self._to_brightness(right)
        if lb.shape != rb.shape:
            raise ValueError("the two images must have equal width and height")
        if lb.ndim not in (2, 3):
            raise ValueError(f"need [H, W] or [B, H, W], got {lb.shape}")
        lt = torch.from_numpy(lb).to(self.device)
        rt = torch.from_numpy(rb).to(self.device)
        return artifacts_to_numpy(self._run(lt, rt))

    def _run(self, lt: torch.Tensor, rt: torch.Tensor):
        if self.mesh is not None:
            return _run_sharded(self.pipeline, self.mesh, lt, rt, self.device)
        return self.pipeline(lt, rt)


class ModernMatcher:
    """Modern-pipeline runner (box or SGM route; ``ModernParams()``, the
    box route, when ``params`` is None) on ``device`` ("cuda" runs the
    kernels, "cpu" their plain versions; a missing GPU raises), or with
    ``mesh`` the sharded tier over the mesh's devices."""

    def __init__(
        self,
        params: Optional[ModernParams] = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.params = params or ModernParams()
        self.mesh = mesh
        self.plain_stages = modern.plain_stages(self.params)
        if mesh is None:
            self.device = resolve_device(device)
            self.pipeline = ModernPipeline(self.params).eval()
        else:
            from stereomatching_tpu_torch.parallel import build_sharded_modern_pipeline

            self.device = mesh.blocks[2][0][0]
            self.pipeline = build_sharded_modern_pipeline(self.params, mesh)

    @staticmethod
    def _to_pixels(img: np.ndarray) -> np.ndarray:
        """0..255 integer pixel planes; uint8 stays uint8 (widened to
        int32 on the device: the same values, 4x fewer host-to-device
        bytes), other integer types become int32.  Float inputs must be
        on the same 0..255 scale: [0, 1] brightness floats are rejected,
        since truncating them would zero the image."""
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.floating):
            if img.size and float(img.max()) <= 1.0 and float(img.min()) >= 0.0:
                raise ValueError(
                    "ModernMatcher takes 0..255 pixel values, not [0,1) "
                    "brightness floats (multiply by 256 and floor first)"
                )
        elif not np.issubdtype(img.dtype, np.integer):
            raise ValueError(f"unsupported image dtype {img.dtype}")
        return img if img.dtype == np.uint8 else img.astype(np.int32)

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        """Build and load the route's kernels ahead of serving by running
        one zero batch of (H, W) pairs (or one pair) on the device (with
        a mesh, through the sharded tier)."""
        _warmup(self._run, self.device, torch.int32, hw, batch)

    def __call__(self, left: np.ndarray, right: np.ndarray) -> Dict[str, np.ndarray]:
        if _straight_in(self.mesh, left, right, floating=False):
            return artifacts_to_numpy(self._run(left, right))
        lp = self._to_pixels(left)
        rp = self._to_pixels(right)
        if lp.shape != rp.shape:
            raise ValueError("the two images must have equal width and height")
        if lp.ndim not in (2, 3):
            raise ValueError(f"need [H, W] or [B, H, W], got {lp.shape}")
        lt = torch.from_numpy(np.ascontiguousarray(lp)).to(self.device).to(torch.int32)
        rt = torch.from_numpy(np.ascontiguousarray(rp)).to(self.device).to(torch.int32)
        return artifacts_to_numpy(self._run(lt, rt))

    def _run(self, lt: torch.Tensor, rt: torch.Tensor):
        if self.mesh is not None:
            return _run_sharded(self.pipeline, self.mesh, lt, rt, self.device)
        return self.pipeline(lt, rt)
