"""Domain value types.

Field names and defaults are a parity contract with the reference's value
objects (reference: atlas_patch/core/models.py:10-37) — the runner, services,
and tests pass these records across layer boundaries, and downstream callers
pattern-match their attributes. Slide is frozen (hashable; used as a dict key
by trackers); Mask carries the prediction-time shape so contour scaling knows
its source resolution; ExtractionResult accumulates per-slide outputs as the
pipeline stages touch it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np


@dataclass(frozen=True)
class Slide:
    """A slide to process: path + optional user MPP + optional forced backend."""

    path: Path
    mpp: float | None = None
    backend: str | None = None

    @property
    def stem(self) -> str:
        return self.path.stem


@dataclass
class Mask:
    """A float32 tissue mask in [0,1] plus the shape it was predicted for."""

    data: np.ndarray
    source_shape: tuple[int, int]


@dataclass
class ExtractionResult:
    """Result record for a processed slide."""

    slide: Slide
    h5_path: Path
    num_patches: int
    image_dir: Path | None = None
    visualizations: dict[str, Path] = field(default_factory=dict)
    metadata: dict[str, Any] = field(default_factory=dict)
    coords: np.ndarray | None = None  # optional in-memory (N,2) xy for visualization
    patch_size_level0: int | None = None
