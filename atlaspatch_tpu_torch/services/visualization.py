"""Overlay rendering service.

Dispatches each enabled overlay kind (patch grid, tissue mask, contours)
through one fault-isolated loop: a failure in any single overlay logs a
warning and the rest still render — visualization never fails a slide.
Behavior parity: atlas_patch/services/visualization.py:23-103 (grid coords
are re-read from the slide's H5 when the in-memory result doesn't carry them).

The port of ``atlaspatch_tpu/services/visualization.py``; the H5 read-back
goes through this package's own reader (utils/h5.py), not h5py.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

from atlaspatch_tpu_torch.core.config import ExtractionConfig, OutputConfig, VisualizationConfig
from atlaspatch_tpu_torch.core.models import ExtractionResult
from atlaspatch_tpu_torch.core.paths import build_run_root
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.ops.contours import mask_to_contours
from atlaspatch_tpu_torch.utils.h5 import read_h5
from atlaspatch_tpu_torch.utils.visualization import (
    visualize_contours_on_thumbnail,
    visualize_mask_on_thumbnail,
    visualize_patches_on_thumbnail,
)

logger = logging.getLogger("atlaspatch_tpu_torch.visualization_service")


class DefaultVisualizationService:
    """Renders the overlays selected in :class:`OutputConfig`."""

    def __init__(
        self,
        output_cfg: OutputConfig,
        extraction_cfg: ExtractionConfig,
        vis_cfg: VisualizationConfig | None = None,
    ) -> None:
        self.output_cfg = output_cfg
        self.extraction_cfg = extraction_cfg
        self.vis_cfg = vis_cfg or VisualizationConfig()

    # -- per-kind renderers (each returns the written path) --------------------

    def _render_grids(self, result: ExtractionResult, wsi: IWSI, vis_dir, mask):
        coords, psize_l0 = self._grid_inputs(result)
        xy = coords[:, :2] if coords.ndim == 2 and coords.shape[1] >= 2 else coords
        step = self.extraction_cfg.step_size or self.extraction_cfg.patch_size
        return visualize_patches_on_thumbnail(
            coords=xy,
            patch_size_level0=psize_l0,
            wsi=wsi,
            output_dir=vis_dir,
            thumbnail_size=self.vis_cfg.thumbnail_size,
            info={
                "patch_size": self.extraction_cfg.patch_size,
                "step_size": step,
                "tissue_thresh": self.extraction_cfg.tissue_threshold,
            },
        )

    def _render_mask(self, result: ExtractionResult, wsi: IWSI, vis_dir, mask):
        return visualize_mask_on_thumbnail(
            mask=mask,
            wsi=wsi,
            output_dir=vis_dir,
            thumbnail_size=self.vis_cfg.thumbnail_size,
        )

    def _render_contours(self, result: ExtractionResult, wsi: IWSI, vis_dir, mask):
        tissue, holes = mask_to_contours(
            mask, tissue_area_thresh=self.extraction_cfg.tissue_threshold
        )
        return visualize_contours_on_thumbnail(
            tissue_contours=tissue,
            holes_contours=holes,
            wsi=wsi,
            output_dir=vis_dir,
            thumbnail_size=self.vis_cfg.thumbnail_size,
            mask_shape=mask.shape,
        )

    def _grid_inputs(self, result: ExtractionResult):
        """Coords + level-0 patch size, from memory or back from the H5 file."""
        if result.coords is not None and result.patch_size_level0 is not None:
            return result.coords, result.patch_size_level0
        datasets, attrs = read_h5(result.h5_path)
        return datasets["coords"], int(attrs["patch_size_level0"])

    # -- entry point ------------------------------------------------------------

    def visualize(self, result: ExtractionResult, *, wsi: IWSI, mask: np.ndarray) -> None:
        out = self.output_cfg
        enabled: list[tuple[str, Callable]] = [
            (kind, render)
            for kind, on, render in (
                ("grids", out.visualize_grids, self._render_grids),
                ("mask", out.visualize_mask, self._render_mask),
                ("contours", out.visualize_contours, self._render_contours),
            )
            if on
        ]
        if not enabled:
            return

        vis_dir = build_run_root(out, self.extraction_cfg) / "visualization"
        vis_dir.mkdir(parents=True, exist_ok=True)

        for kind, render in enabled:
            try:
                result.visualizations[kind] = render(result, wsi, vis_dir, mask)
            except Exception as e:  # noqa: BLE001 — overlay failures never fail a slide
                logger.warning(
                    "Failed to visualize %s for %s: %s", kind, result.slide.path.name, e
                )
