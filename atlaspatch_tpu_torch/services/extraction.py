"""Patch coordinate extraction from a tissue mask.

Coordinate parity contract (reference: atlas_patch/services/extraction.py:22-197):

  * contours from the mask are scaled to level-0 by (W0/mask_w, H0/mask_h);
  * geometry: desired_downsample = src_mag / tgt_mag; level via
    optimal_level(desired_downsample); patch_size_src =
    round(patch_size * desired_downsample); step likewise;
    patch_size_level0 = patch_size * int(src_mag) // int(tgt_mag);
    read_w = max(1, round(patch_size_src / level_downsample));
  * the grid scan runs row-major over each tissue contour's bounding rect and
    keeps anchors passing the 4-probe containment test outside holes.

The scan is one vectorized containment evaluation per contour
(ops/contours.py), yielding entries in the reference's order. This module
holds the geometry (contours, level/size geometry, coordinates); the H5
writer and ``extract()`` are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from atlaspatch_tpu_torch.core.config import ExtractionConfig, OutputConfig
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.ops.contours import (
    containment_mask,
    grid_candidates,
    mask_to_contours,
    scale_contours,
)
from atlaspatch_tpu_torch.utils import perf

logger = logging.getLogger("atlaspatch_tpu_torch.extraction_service")


class PatchExtractionService:
    """Computes patch coordinates from WSIs given a tissue mask."""

    def __init__(
        self, extraction_cfg: ExtractionConfig, output_cfg: OutputConfig | None = None
    ) -> None:
        self.cfg = extraction_cfg.validated()
        self.output_cfg = output_cfg.validated() if output_cfg is not None else None

    # --- geometry -------------------------------------------------------------------
    def _prepare_contours(self, mask: np.ndarray, wsi: IWSI):
        with perf.stage("contours"):
            tissue_t, holes_t = mask_to_contours(
                mask, tissue_area_thresh=self.cfg.tissue_threshold
            )
            W, H = wsi.get_size(lv=0)
            mh, mw = mask.shape[:2]
            sx = W / float(mw)
            sy = H / float(mh)
            tissue_contours = scale_contours(tissue_t, sx, sy)
            holes_contours = [scale_contours(hs, sx, sy) for hs in holes_t]
            return tissue_contours, holes_contours

    def _prepare_geometry(self, wsi: IWSI) -> tuple[int, tuple[int, int], int, int, int]:
        """Return (level, (read_w, read_h), patch_size_src, step_src, patch_size_level0)."""
        src_mag = wsi.mag
        tgt_mag = self.cfg.target_magnification
        if src_mag is None:
            raise ValueError("WSI base magnification is required for patch extraction.")
        if int(tgt_mag) > int(src_mag):
            raise ValueError(f"Requested magnification {tgt_mag}x exceeds available {src_mag}x.")

        desired_downsample = float(src_mag) / float(tgt_mag)
        level, _ = wsi.optimal_level(desired_downsample)
        downsamples = wsi.ds or [1.0]
        level_ds = float(downsamples[level])

        patch_size_src = int(round(self.cfg.patch_size * desired_downsample))
        step_src = int(round((self.cfg.step_size or self.cfg.patch_size) * desired_downsample))
        patch_size_level0 = int(self.cfg.patch_size * int(src_mag) // int(tgt_mag))

        read_w = max(1, int(round(patch_size_src / level_ds)))
        return level, (read_w, read_w), patch_size_src, step_src, patch_size_level0

    # --- candidate generation -------------------------------------------------------
    def compute_coords(
        self,
        tissue_contours: Sequence[np.ndarray],
        holes_contours: Sequence[Sequence[np.ndarray]],
        *,
        patch_size_src: int,
        step_src: int,
    ) -> np.ndarray:
        """All accepted (x, y) anchors, vectorized, in reference iteration order."""
        with perf.stage("grid_scan"):
            accepted: list[np.ndarray] = []
            for contour, holes in zip(tissue_contours, holes_contours):
                xs, ys = grid_candidates(contour, step_src)
                if xs.size == 0:
                    continue
                keep = containment_mask(
                    contour, list(holes), xs, ys, patch_size=patch_size_src, center_shift=0.5
                )
                if keep.any():
                    accepted.append(np.stack([xs[keep], ys[keep]], axis=1))
            if not accepted:
                return np.empty((0, 2), dtype=np.int64)
            return np.concatenate(accepted, axis=0)
