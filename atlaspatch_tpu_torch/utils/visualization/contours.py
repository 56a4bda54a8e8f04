"""Contour overlay rendering
(reference: atlas_patch/utils/visualization/contours.py:14-49): red tissue
outlines, blue hole outlines on the thumbnail."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from typing import TYPE_CHECKING

import numpy as np

from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.ops.contours import scale_contours

if TYPE_CHECKING:
    from PIL import Image

_TISSUE_STYLE = ((255, 0, 0), 2)  # red, thick
_HOLE_STYLE = ((0, 0, 255), 1)  # blue, thin


def _overlay(thumb: Image.Image, scaled: Sequence[np.ndarray], style) -> None:
    from PIL import ImageDraw

    color, width = style
    draw = ImageDraw.Draw(thumb)
    for contour in scaled:
        ring = [tuple(p) for p in contour.reshape(-1, 2).tolist()]
        if len(ring) < 2:
            continue
        draw.line(ring + ring[:1], fill=color, width=width)


def visualize_contours_on_thumbnail(
    *,
    tissue_contours: Sequence[np.ndarray],
    holes_contours: Sequence[Sequence[np.ndarray]],
    wsi: IWSI,
    output_dir: Path,
    thumbnail_size: int,
    mask_shape: tuple[int, int] | None = None,
) -> Path:
    """Draw tissue (red) and hole (blue) outlines over the slide thumbnail.

    Contour coordinates live in mask space when ``mask_shape`` is given,
    otherwise in level-0 pixel space; either way they are rescaled to the
    thumbnail before drawing. Output name/layout matches the reference
    (`<stem>_contours.png` under ``output_dir``).
    """
    output_dir.mkdir(parents=True, exist_ok=True)
    thumb = wsi.get_thumb((thumbnail_size, thumbnail_size)).convert("RGB")

    # Source space the contours are expressed in → scale to thumbnail pixels.
    if mask_shape is not None:
        src_w, src_h = float(mask_shape[1]), float(mask_shape[0])
    else:
        level0 = wsi.get_size(lv=0)
        src_w, src_h = float(level0[0]), float(level0[1])
    sx, sy = thumb.width / src_w, thumb.height / src_h

    _overlay(thumb, scale_contours(list(tissue_contours), sx, sy), _TISSUE_STYLE)
    flat_holes = [hole for per_tissue in holes_contours for hole in per_tissue]
    _overlay(thumb, scale_contours(flat_holes, sx, sy), _HOLE_STYLE)

    out_path = output_dir / f"{Path(wsi.path).stem}_contours.png"
    thumb.save(out_path)
    return out_path
