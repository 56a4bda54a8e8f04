"""Plain-image backend: one PNG/JPEG/BMP behaves as a single-level pyramid.

The whole image is decoded once into an RGB numpy array and every region read
is a zero-copy-ish slice of it (out-of-bounds regions pad black, matching
PIL's crop-beyond-boundary behavior). This favors the embedding phase, which
re-reads hundreds of patches per slide. MPP cannot be read from a plain
image, so a user-supplied value is mandatory and validated.

Behavior parity: atlas_patch/core/wsi/image_wsi.py:9-147 (mandatory MPP,
level-0-only reads, LANCZOS thumbnails, mag inferred from MPP). Pillow is
imported only inside the functions that decode or build images.
"""

from __future__ import annotations

from typing import Any, Literal, Optional, Tuple, Union

import numpy as np

from atlaspatch_tpu_torch.io.iwsi import IWSI


class ImageWSI(IWSI):
    """Single-level slide backed by a fully-decoded RGB array."""

    def __init__(self, **kwargs: Any) -> None:
        mpp = kwargs.get("mpp")
        if mpp is None:
            raise ValueError("mpp parameter is required for standard images")
        if mpp <= 0:
            raise ValueError(f"mpp must be positive, got {mpp}")
        super().__init__(**kwargs)
        self._rgb: Optional[np.ndarray] = None
        self._format: str = "unknown"
        self._mpp_value = self.validate_mpp(mpp, source="user-provided mpp")

    def _setup(self) -> None:
        try:
            self._decode()
        except FileNotFoundError as e:
            raise FileNotFoundError(f"Image not found: {self.path}") from e
        except Exception as e:
            raise RuntimeError(f"Setup failed: {e}") from e
        assert self._rgb is not None
        self.h, self.w = self._rgb.shape[:2]
        self.nlvl = 1
        self.ds = [1.0]
        self.dims = [(self.w, self.h)]
        self.meta = {"format": self._format, "mode": "RGB"}
        self.mpp = self._mpp_value
        try:
            self.mag = self._infer_mag(self.mpp)
        except ValueError:
            self.mag = None

    def _decode(self) -> None:
        if self._rgb is not None:
            return
        from PIL import Image

        with Image.open(self.path) as img:
            self._format = img.format or "unknown"
            self._rgb = np.asarray(img.convert("RGB"))

    def _require_pixels(self, lv: int) -> np.ndarray:
        self._ensure_loaded()
        if lv != 0:
            raise ValueError("Standard images only support level 0")
        if self._rgb is None:
            # cleanup() ran; re-decode on demand.
            self._decode()
        assert self._rgb is not None
        return self._rgb

    def extract(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        *,
        mode: Literal["array", "image"] = "array",
    ) -> Union[np.ndarray, "Image.Image"]:
        if mode not in ("array", "image"):
            raise ValueError(f"Invalid mode: {mode}")
        pixels = self._require_pixels(lv)
        x, y = xy
        w, h = wh

        region = np.zeros((h, w, 3), dtype=np.uint8)
        src_x0, src_y0 = max(0, x), max(0, y)
        src_x1 = min(pixels.shape[1], x + w)
        src_y1 = min(pixels.shape[0], y + h)
        if src_x1 > src_x0 and src_y1 > src_y0:
            region[src_y0 - y : src_y1 - y, src_x0 - x : src_x1 - x] = pixels[
                src_y0:src_y1, src_x0:src_x1
            ]
        if mode == "image":
            from PIL import Image

            return Image.fromarray(region)
        return region

    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        self._ensure_loaded()
        if lv != 0:
            raise ValueError("Standard images only support level 0")
        if self.w is None or self.h is None:
            raise RuntimeError("Image dimensions not set")
        return (self.w, self.h)

    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        from PIL import Image

        thumb = Image.fromarray(self._require_pixels(0))
        thumb.thumbnail(max_hw, Image.Resampling.LANCZOS)
        return thumb

    def cleanup(self) -> None:
        self._rgb = None
        self._loaded = False

    def __del__(self) -> None:
        self.cleanup()
