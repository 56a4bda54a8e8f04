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
(ops/contours.py), yielding entries in the reference's order; ``extract()``
writes them, with the slide's file attrs, to ``patches/<stem>.h5`` through
services/storage.py.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from atlaspatch_tpu_torch.core.config import ExtractionConfig, OutputConfig
from atlaspatch_tpu_torch.core.models import ExtractionResult, Slide
from atlaspatch_tpu_torch.core.paths import RunLayout, build_run_root, images_dir, patch_h5_path
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.ops.contours import (
    containment_mask,
    grid_candidates,
    mask_to_contours,
    scale_contours,
)
from atlaspatch_tpu_torch.services.interfaces import ExtractionService
from atlaspatch_tpu_torch.services.storage import Entry, H5PatchWriter
from atlaspatch_tpu_torch.utils import perf
from atlaspatch_tpu_torch.utils.image import is_black_patch, is_white_patch

logger = logging.getLogger("atlaspatch_tpu_torch.extraction_service")


def _resize_patch(patch: np.ndarray, size: int) -> np.ndarray:
    """Host resize to the output patch size (cv2 INTER_LINEAR default, matching
    the reference's cv2.resize call at extraction.py:113)."""
    import cv2

    return cv2.resize(patch, (size, size))


class PatchExtractionService(ExtractionService):
    """Extracts patch coordinates (and optional images) from WSIs given a tissue mask.

    ``output_cfg`` may be left out by callers that only compute coordinates;
    ``extract()`` needs it."""

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

    def _iter_patch_entries(
        self,
        wsi: IWSI,
        tissue_contours: Sequence[np.ndarray],
        holes_contours: Sequence[Sequence[np.ndarray]],
        *,
        include_patch: bool,
        geometry: tuple | None = None,
    ) -> Iterable[Entry]:
        """Yield (x, y, read_w, read_h, level, patch_or_none) per accepted anchor.

        `geometry` is _prepare_geometry(wsi)'s tuple when the caller already
        computed it — extract() derives the H5 attrs from the same values, so
        sharing one derivation keeps them from ever disagreeing."""
        if geometry is None:
            geometry = self._prepare_geometry(wsi)
        level, (read_w, read_h), patch_size_src, step_src, _ = geometry
        coords = self.compute_coords(
            tissue_contours,
            holes_contours,
            patch_size_src=patch_size_src,
            step_src=step_src,
        )
        fast_no_pixels = self.cfg.fast_mode and not include_patch
        for x, y in coords:
            x, y = int(x), int(y)
            if fast_no_pixels:
                yield x, y, int(read_w), int(read_h), int(level), None
                continue

            patch_any = wsi.extract((x, y), lv=level, wh=(read_w, read_h), mode="array")
            if not isinstance(patch_any, np.ndarray):
                continue
            patch = patch_any
            if patch.shape[0] != self.cfg.patch_size or patch.shape[1] != self.cfg.patch_size:
                patch = _resize_patch(patch, self.cfg.patch_size)

            if not self.cfg.fast_mode:
                if is_black_patch(patch, rgb_thresh=self.cfg.black_threshold):
                    continue
                if is_white_patch(patch, sat_thresh=self.cfg.white_threshold):
                    continue

            yield x, y, int(read_w), int(read_h), int(level), (patch if include_patch else None)

    # --- public API -----------------------------------------------------------------
    def extract(self, wsi: IWSI, mask: np.ndarray, *, slide: Slide) -> ExtractionResult:
        if self.output_cfg is None:
            raise ValueError("extract() needs an OutputConfig: construct the service with one")
        tissue_contours, holes_contours = self._prepare_contours(mask, wsi)

        run_root = build_run_root(self.output_cfg, self.cfg)
        RunLayout(run_root).patches.mkdir(parents=True, exist_ok=True)
        out_h5 = patch_h5_path(slide, self.output_cfg, self.cfg)

        img_dir: Path | None = None
        if self.output_cfg.save_images:
            img_dir = images_dir(slide, self.output_cfg, self.cfg)
            img_dir.mkdir(parents=True, exist_ok=True)

        logger.debug("Extracting patches for %s to %s", slide.path.name, out_h5)

        geometry = self._prepare_geometry(wsi)
        patch_size_level0 = geometry[4]
        level0_width, level0_height = wsi.get_size(lv=0)
        step = self.cfg.step_size or self.cfg.patch_size
        overlap = max(0, int(self.cfg.patch_size) - int(step))

        extra_attrs = {"filename": slide.path.name}
        extra_attrs.update(wsi.metadata_attrs())

        writer = H5PatchWriter(
            chunk_rows=self.cfg.write_batch,
            patch_size=self.cfg.patch_size,
            patch_size_level0=patch_size_level0,
            level0_mag=int(wsi.mag) if wsi.mag is not None else 0,
            target_mag=self.cfg.target_magnification,
            level0_wh=(int(level0_width), int(level0_height)),
            overlap=overlap,
            slide_stem=slide.stem,
            wsi_path=str(wsi.path),
            extra_file_attrs=extra_attrs,
        )

        entries = self._iter_patch_entries(
            wsi=wsi,
            tissue_contours=tissue_contours,
            holes_contours=holes_contours,
            include_patch=bool(img_dir),
            geometry=geometry,
        )

        # collect the (N,2) xy array so grid visualization reuses it instead
        # of re-opening the just-written H5 to read every coordinate back
        if img_dir is None:
            total, coords_xy = writer.write_coords(
                output_path=out_h5,
                entries=entries,
                batch=self.cfg.write_batch,
                collect_coords=True,
            )
        else:
            total, coords_xy = writer.write_coords_and_images(
                output_path=out_h5,
                entries=entries,
                image_dir=img_dir,
                batch=self.cfg.write_batch,
                collect_coords=True,
            )

        return ExtractionResult(
            slide=slide,
            h5_path=out_h5,
            num_patches=int(total),
            image_dir=img_dir,
            coords=coords_xy,
            patch_size_level0=patch_size_level0,
        )
