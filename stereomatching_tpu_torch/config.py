"""Parameters of the port's pipelines.

The port's own copy of the JAX package's parameter classes (same fields,
defaults, validation and JSON form), so that importing the port loads no
module of the JAX package.  ``interop.params_from_jax`` turns the JAX
package's instances into these through their JSON.

The reference hard-codes its parameters as compile-time constants
(``src/stereo.c:6-10``: NUM_SHIFTS 30, DEFAULT_THRESHOLD 0.15,
DEFAULT_SQUARE_WIDTH 21, DEFAULT_TIMES 32, DEFAULT_LINES 10) and takes
overrides for all but NUM_SHIFTS as positional argv
(``src/stereo.c:335-386``).  Here every one is a runtime parameter of a
frozen dataclass, validated with the rules the reference's ``main()``
enforces.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any

# Reference defaults (src/stereo.c:6-10).
NUM_SHIFTS = 30
DEFAULT_THRESHOLD = 0.15
DEFAULT_SQUARE_WIDTH = 21
DEFAULT_TIMES = 32
DEFAULT_LINES = 10

# Fill value for the 1-px brightness halo in ghost mode
# (src/stereo-ghost.c:384-385 pads with 128.0: out of band for [0, 1)
# data, kept for a golden match of the border pixels).
GHOST_BRIGHTNESS_FILL = 128.0


class BoundaryMode(str, enum.Enum):
    """Boundary handling, mirroring the reference's two program families.

    WRAP  — modulo wrap-around indexing (src/util.h:42-47, used by
            ``stereomatch`` / ``stereopar``).
    GHOST — ghost-area (halo) padding: brightness halo of 1 filled with
            128.0, edge halo of ``num_shifts`` filled 0, match halo of
            ``square_width`` filled 0 (src/ghost.h, src/stereo-ghost.c:11-12).
    """

    WRAP = "wrap"
    GHOST = "ghost"


@dataclasses.dataclass(frozen=True)
class StereoParams:
    """Classic-pipeline parameters (reference ``AlgorithmParams``,
    src/stereo.c:280-285, plus the compile-time constants as runtime
    values).

    ``edge_rule``: ``"reference"`` runs the edge decision's float ops in
    the C reference's order (src/stereo.c:16-70); ``"exact"`` is the same
    predicate rescaled to integers, 2*|ka-kb| > min(f32(threshold) *
    (ka+kb), 1536) with ka/kb integer 3-pixel sums of brightness*256, so
    its only float op is one IEEE multiply and it is bit-identical on
    every backend."""

    threshold: float = DEFAULT_THRESHOLD
    square_width: int = DEFAULT_SQUARE_WIDTH
    times: int = DEFAULT_TIMES
    lines: int = DEFAULT_LINES
    num_shifts: int = NUM_SHIFTS
    mode: BoundaryMode = BoundaryMode.WRAP
    edge_rule: str = "reference"

    def __post_init__(self) -> None:
        # The reference CLI's checks (src/stereo.c:378-385), minus the
        # image-size check, which needs the images (validate_for_image).
        if not (0.0 <= self.threshold <= 1.0):
            raise ValueError("threshold must be between 0 and 1")
        if self.square_width < 1 or self.square_width % 2 == 0:
            raise ValueError("square_width must be a positive odd integer")
        if self.times < 0:
            raise ValueError("times must be non-negative")
        if self.lines < 1:
            raise ValueError("lines must be positive")
        if self.num_shifts < 1:
            raise ValueError("num_shifts must be positive")
        if self.edge_rule not in ("reference", "exact"):
            raise ValueError("edge_rule must be 'reference' or 'exact'")

    @property
    def half(self) -> int:
        """Half window width (src/stereo.c:135)."""
        return self.square_width // 2

    def validate_for_image(self, width: int, height: int) -> None:
        """Reference check: square width must fit in the image
        (src/stereo.c:382-385)."""
        if self.square_width > width or self.square_width > height:
            raise ValueError(
                "square width must not be higher than image width/height"
            )

    def replace(self, **kwargs: Any) -> "StereoParams":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "StereoParams":
        d = json.loads(s)
        if "mode" in d:
            d["mode"] = BoundaryMode(d["mode"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ModernParams:
    """Parameters of the modern pipeline (``models/modern.py``): census
    or SAD costs, box or SGM aggregation, LR consistency, sub-pixel
    refine, hole filling, multi-scale cost fusion."""

    num_disparities: int = 64
    window: int = 9
    lr_max_diff: int = 1  # LR consistency tolerance in pixels
    fill_iterations: int = 16  # diffusion sweeps for invalidated pixels
    # Hole filling for LR-invalidated pixels: "diffusion" (valid-aware
    # Jacobi averaging, fill_iterations sweeps) or "background"
    # (scanline background extension: min of the nearest valid left /
    # right disparity, the standard SGM occlusion interpolation).
    fill_mode: str = "diffusion"
    scales: int = 1  # 1 = single scale; 2 = fuse a half-res cost pyramid
    coarse_weight: int = 1  # integer weight of the upsampled coarse cost
    cost: str = "sad"  # "sad" | "census" (Hamming on census codes)
    census_window: int = 5  # census neighborhood (3 or 5)
    # Aggregation: "box" (windowed sum) or "sgm" (Semi-Global Matching
    # over the materialized volume of per-pixel costs; `window` is then
    # unused).
    aggregation: str = "box"
    sgm_p1: int = 8  # SGM small-change penalty (|dd| == 1)
    sgm_p2: int = 96  # SGM jump penalty (|dd| > 1)
    # 4 = two horizontal + two vertical paths; 8 adds the four diagonal
    # paths.
    sgm_directions: int = 4
    median_filter: bool = False  # 3x3 median speckle removal before LR
    # Emit a per-pixel "uniqueness" confidence plane: c2 / max(c1, 1),
    # the second-best aggregated cost OUTSIDE the winner's +-1
    # neighborhood over the best (OpenCV SGBM's uniquenessRatio signal;
    # higher = more confident).  SGM only.
    uniqueness: bool = False

    def __post_init__(self) -> None:
        if self.num_disparities < 2:
            raise ValueError("num_disparities must be >= 2")
        if self.window < 1 or self.window % 2 == 0:
            raise ValueError("window must be a positive odd integer")
        if self.scales not in (1, 2):
            raise ValueError("scales must be 1 or 2")
        if self.lr_max_diff < 0 or self.fill_iterations < 0:
            raise ValueError("lr_max_diff/fill_iterations must be >= 0")
        if self.cost not in ("sad", "census"):
            raise ValueError("cost must be 'sad' or 'census'")
        if self.census_window not in (3, 5):
            raise ValueError("census_window must be 3 or 5")
        if self.aggregation not in ("box", "sgm"):
            raise ValueError("aggregation must be 'box' or 'sgm'")
        if self.sgm_p1 < 0 or self.sgm_p2 < self.sgm_p1:
            raise ValueError("need 0 <= sgm_p1 <= sgm_p2")
        if self.sgm_directions not in (4, 8):
            raise ValueError("sgm_directions must be 4 or 8")
        if self.fill_mode not in ("diffusion", "background"):
            raise ValueError("fill_mode must be 'diffusion' or 'background'")
        if self.uniqueness and self.aggregation != "sgm":
            raise ValueError(
                "uniqueness needs the materialized cost volume "
                "(aggregation='sgm')"
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ModernParams":
        return cls(**json.loads(s))
