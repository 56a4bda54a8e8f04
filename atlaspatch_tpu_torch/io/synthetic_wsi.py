"""In-memory synthetic slide backend for tests and benchmarks.

The reference ships no test backend; this fills that gap (SURVEY.md §4). A
SyntheticWSI owns a procedurally generated level-0 RGB canvas plus a true
power-of-two pyramid, with configurable mpp/mag/metadata, so every pipeline
stage — thumbnailing, level selection, region reads, extraction, embedding —
runs without any slide files on disk.
"""

from __future__ import annotations

from typing import Any, Literal, Optional, Tuple, Union

import numpy as np

from atlaspatch_tpu_torch.io.iwsi import IWSI


def make_tissue_canvas(
    width: int,
    height: int,
    *,
    seed: int = 0,
    n_blobs: int = 3,
    background: int = 245,
) -> np.ndarray:
    """Generate a plausible H&E-like canvas: white background + dark tissue blobs."""
    rng = np.random.default_rng(seed)
    canvas = np.full((height, width, 3), background, dtype=np.uint8)
    xx = np.arange(width, dtype=np.float32)[None, :]
    yy = np.arange(height, dtype=np.float32)[:, None]
    for _ in range(n_blobs):
        cx = rng.uniform(0.2, 0.8) * width
        cy = rng.uniform(0.2, 0.8) * height
        rx = rng.uniform(0.08, 0.22) * width
        ry = rng.uniform(0.08, 0.22) * height
        blob = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
        color = np.array(
            [rng.integers(140, 200), rng.integers(60, 120), rng.integers(140, 200)],
            dtype=np.uint8,
        )
        canvas[blob] = color
    noise = rng.integers(0, 17, size=canvas.shape, dtype=np.uint8)
    np.subtract(canvas, 8, out=canvas, where=canvas >= 8)
    np.add(canvas, noise, out=canvas, where=canvas <= 255 - 16)
    return canvas


def _downsample2x(arr: np.ndarray) -> np.ndarray:
    h, w = arr.shape[:2]
    h2, w2 = h // 2 * 2, w // 2 * 2
    a = arr[:h2, :w2].astype(np.uint16)
    out = (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) // 4
    return out.astype(np.uint8)


class SyntheticWSI(IWSI):
    """Pyramidal in-memory slide with power-of-two levels."""

    def __init__(
        self,
        path: str = "<synthetic>",
        mpp: Optional[float] = 0.5,
        *,
        level0: np.ndarray | None = None,
        size: tuple[int, int] = (2048, 1536),
        levels: int = 3,
        mag: int | None = None,
        seed: int = 0,
        meta: dict[str, Any] | None = None,
    ) -> None:
        super().__init__(path=path, mpp=mpp)
        if level0 is None:
            level0 = make_tissue_canvas(size[0], size[1], seed=seed)
        self._levels = [level0]
        for _ in range(max(0, levels - 1)):
            self._levels.append(_downsample2x(self._levels[-1]))
        self._mag_override = mag
        self._meta_override = dict(meta or {})
        self.read_count = 0  # instrumentation for IO tests

    def _setup(self) -> None:
        l0 = self._levels[0]
        self.h, self.w = l0.shape[:2]
        self.nlvl = len(self._levels)
        self.dims = [(lvl.shape[1], lvl.shape[0]) for lvl in self._levels]
        self.ds = [self._levels[0].shape[1] / lvl.shape[1] for lvl in self._levels]
        self.meta = dict(self._meta_override)
        self.mpp = (
            self.validate_mpp(self._mpp_manual, source="user-provided mpp")
            if self._mpp_manual is not None
            else None
        )
        if self._mag_override is not None:
            self.mag = self._mag_override
        elif self.mpp is not None:
            try:
                self.mag = self._infer_mag(self.mpp)
            except ValueError:
                self.mag = None
        else:
            self.mag = None

    def extract(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        *,
        mode: Literal["array", "image"] = "array",
    ) -> Union[np.ndarray, "Image.Image"]:
        self._ensure_loaded()
        if lv < 0 or lv >= len(self._levels):
            raise IndexError(f"Level {lv} out of range")
        self.read_count += 1
        level_arr = self._levels[lv]
        ds = self.ds[lv] if self.ds else 1.0
        # xy is in level-0 coordinates (OpenSlide read_region convention).
        # TRUNCATE like the production TIFF backend (tiff_wsi.py extract):
        # this backend is the geometry oracle, so the two must agree bit-
        # exactly at odd level-0 offsets on lv>0.
        x = int(xy[0] / ds)
        y = int(xy[1] / ds)
        w, h = wh
        lh, lw = level_arr.shape[:2]
        # Out-of-bounds regions are white-padded (OpenSlide pads with transparent
        # black; after RGB conversion the reference sees black. Use black to match.)
        out = np.zeros((h, w, 3), dtype=np.uint8)
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(lw, x + w), min(lh, y + h)
        if x1 > x0 and y1 > y0:
            out[y0 - y : y1 - y, x0 - x : x1 - x] = level_arr[y0:y1, x0:x1]
        if mode == "image":
            from PIL import Image

            return Image.fromarray(out)
        return out

    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        self._ensure_loaded()
        if self.dims is None or lv < 0 or lv >= len(self.dims):
            raise IndexError(f"Level {lv} out of range")
        return self.dims[lv]

    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        from PIL import Image

        self._ensure_loaded()
        img = Image.fromarray(self._levels[-1])
        img.thumbnail(max_hw, Image.Resampling.LANCZOS)
        return img.convert("RGB")

    def cleanup(self) -> None:
        self._loaded = False
