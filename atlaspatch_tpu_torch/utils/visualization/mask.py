"""Tissue-mask overlay rendering.

Per slide, two PNGs land in the visualization directory:

* ``<stem>_mask_bw.png`` — the binary mask itself, thumbnail-sized.
* ``<stem>_mask.png``    — the thumbnail tinted green where tissue was found
  (alpha 80/255, matching the reference overlay look,
  atlas_patch/utils/visualization/mask.py:11-45).

Compositing is done directly in numpy (uint8 blend) rather than via PIL layer
stacking; the mask is nearest-resampled to the thumbnail grid so overlay and
preview always share the thumbnail's geometry.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from atlaspatch_tpu_torch.io.iwsi import IWSI

_TISSUE_TINT = np.array([0, 255, 0], dtype=np.float32)  # green
_TINT_ALPHA = 80.0 / 255.0


def _mask_at_thumb_grid(mask: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """Binarize ``mask`` (>0.5) and nearest-resample it to ``size_wh``; uint8 0/255."""
    from PIL import Image

    binary = np.where(np.asarray(mask, dtype=np.float32) > 0.5, 255, 0).astype(np.uint8)
    h, w = binary.shape[:2]
    if (w, h) == size_wh:
        return binary
    resampled = Image.fromarray(binary, mode="L").resize(
        size_wh, resample=Image.Resampling.NEAREST
    )
    return np.asarray(resampled)


def visualize_mask_on_thumbnail(
    *,
    mask: np.ndarray,
    wsi: IWSI,
    output_dir: Path,
    thumbnail_size: int,
) -> Path:
    """Render the BW preview and the green tissue overlay; return the overlay path."""
    from PIL import Image

    thumb = wsi.get_thumb((thumbnail_size, thumbnail_size)).convert("RGB")
    tissue = _mask_at_thumb_grid(mask, (thumb.width, thumb.height))

    output_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(wsi.path).stem
    Image.fromarray(tissue, mode="L").save(output_dir / f"{stem}_mask_bw.png")

    rgb = np.asarray(thumb, dtype=np.float32)
    weight = (tissue[..., None].astype(np.float32) / 255.0) * _TINT_ALPHA
    blended = rgb * (1.0 - weight) + _TISSUE_TINT * weight
    overlay_path = output_dir / f"{stem}_mask.png"
    Image.fromarray(blended.round().astype(np.uint8)).save(overlay_path, quality=95)
    return overlay_path
