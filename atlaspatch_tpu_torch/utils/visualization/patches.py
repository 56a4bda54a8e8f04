"""Patch-grid overlay: extracted patch boxes drawn on the slide thumbnail.

Output is ``<stem>.png`` — level-0 coords projected onto the thumbnail grid,
each patch outlined 1px black, plus a stats box (patch count, slide size,
config) in the top-right corner. Look parity with the reference overlay
(atlas_patch/utils/visualization/patches.py:14-90).
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

from atlaspatch_tpu_torch.io.iwsi import IWSI

if TYPE_CHECKING:
    from PIL import Image

_INFO_LABELS = {
    "patch_size": "Patch Size",
    "step_size": "Step Size",
    "tissue_thresh": "Tissue Threshold",
}
_LINE_HEIGHT = 16
_PAD = 10
_MARGIN = 10


def _stats_lines(n_patches: int, size_l0: tuple[int, int], info: dict[str, Any] | None):
    lines = [f"Patches Extracted: {n_patches}", f"WSI Size: {size_l0[0]} x {size_l0[1]}"]
    for key, label in _INFO_LABELS.items():
        if info and key in info:
            lines.append(f"{label}: {info[key]}")
    return lines


def _draw_stats_box(canvas: Image.Image, lines: list[str]) -> None:
    """White box, black border, anchored to the top-right corner."""
    from PIL import ImageDraw, ImageFont

    draw = ImageDraw.Draw(canvas, "RGBA")
    font = ImageFont.load_default()
    text_w = max(
        draw.textbbox((0, 0), line, font=font)[2] for line in lines
    )
    box_w = text_w + 2 * _PAD
    box_h = len(lines) * _LINE_HEIGHT + 2 * _PAD
    left = canvas.width - box_w - _MARGIN
    top = _MARGIN
    draw.rectangle(
        ((left, top), (canvas.width - _MARGIN, top + box_h)),
        fill=(255, 255, 255, 230),
        outline=(0, 0, 0, 255),
        width=2,
    )
    for i, line in enumerate(lines):
        draw.text(
            (left + _PAD, top + _PAD + i * _LINE_HEIGHT),
            line,
            fill=(0, 0, 0, 255),
            font=font,
        )


def visualize_patches_on_thumbnail(
    *,
    coords: np.ndarray,
    patch_size_level0: int,
    wsi: IWSI,
    output_dir: Path,
    thumbnail_size: int,
    info: dict[str, Any] | None = None,
) -> Path:
    from PIL import ImageDraw

    canvas = wsi.get_thumb((thumbnail_size, thumbnail_size)).convert("RGB")
    W0, H0 = wsi.get_size(lv=0)

    # Project level-0 patch rectangles onto the thumbnail grid in one shot.
    scale = np.array([canvas.width / W0, canvas.height / H0], dtype=np.float64)
    tl = np.asarray(coords, dtype=np.float64)[:, :2] * scale
    br = tl + patch_size_level0 * scale
    boxes = np.concatenate([tl, br], axis=1).astype(np.int64)

    draw = ImageDraw.Draw(canvas, "RGBA")
    for x0, y0, x1, y1 in boxes:
        draw.rectangle(((int(x0), int(y0)), (int(x1), int(y1))), outline=(0, 0, 0), width=1)

    _draw_stats_box(canvas, _stats_lines(len(coords), (W0, H0), info))

    output_dir.mkdir(parents=True, exist_ok=True)
    out_path = output_dir / f"{Path(wsi.path).stem}.png"
    canvas.save(out_path)
    return out_path
