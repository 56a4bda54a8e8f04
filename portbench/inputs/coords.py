"""Patch coordinates of the cohort's slides, by the plain reference.

A slide's tissue mask is its thumbnail thresholded below ``tissue_below``
(the cohort paints tissue darker than background); its coordinates are the
upstream geometry's over that mask. They are what ``segment-and-get-coords``
writes for such a slide, and the embed cells start from them. Kept beside the pool as ``<slide>.coords.npy``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.reference import geometry, slide


def for_slide(path: Path, extraction: dict) -> np.ndarray:
    """(N, 2) int64 level-0 anchors of the pool slide at ``path``."""
    key = "_".join(str(extraction[k]) for k in ("patch_size", "step_size", "target_mag", "tissue_threshold",
                                                 "tissue_below"))
    cache = path.with_name(f"{path.stem}.{key}.coords.npy")
    if cache.exists():
        return np.load(cache)
    s = slide.open_slide(str(path))
    mask = slide.tissue_mask(slide.thumbnail(s, extraction["thumbnail_power"]), extraction["tissue_below"])
    lv0 = s.levels[0]
    ds = s.magnification / extraction["target_mag"]
    out = geometry.coordinates(mask, (lv0.width, lv0.height), patch=int(round(extraction["patch_size"] * ds)),
                               step=int(round((extraction["step_size"] or extraction["patch_size"]) * ds)),
                               tissue_threshold=extraction["tissue_threshold"])
    tmp = cache.with_suffix(".tmp.npy")
    np.save(tmp, out)
    tmp.replace(cache)
    return out
