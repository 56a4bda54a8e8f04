"""Whole-slide-image access abstraction.

Behavioral contract matches the reference IWSI (reference:
atlas_patch/core/wsi/iwsi.py:9-395): pyramid metadata, region extraction,
thumbnails, MPP validation, magnification inference, and optimal-level
selection. All geometry here is host-side integer/float math that downstream
coordinate parity depends on; it is covered by golden tests.

Pillow and OpenCV are imported only inside the functions that need them, so
the geometry runs with numpy alone.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Literal, Mapping, Optional, Sequence, Tuple, Union

import numpy as np


def _resize_rgb(arr: np.ndarray, out_wh: tuple[int, int], interpolation: str) -> np.ndarray:
    """Host RGB resize used for thumbnail generation.

    Delegates to OpenCV (third-party native, like the reference at
    iwsi.py:305-321) because thumbnail pixels feed the segmentation model and
    must match the reference bit-for-bit. Device-side resizing for patch
    preprocessing lives in ops/resize.py.
    """
    import cv2

    interp_map = {
        "area": cv2.INTER_AREA,
        "cubic": cv2.INTER_CUBIC,
        "linear": cv2.INTER_LINEAR,
        "nearest": cv2.INTER_NEAREST,
    }
    return cv2.resize(arr, out_wh, interpolation=interp_map.get(interpolation, cv2.INTER_LINEAR))


class IWSI(ABC):
    """Base interface for whole slide image access."""

    # Valid MPP range (µm/pixel): 0.1 (~100x) to 10.0 (~1x)
    MPP_MIN = 0.1
    MPP_MAX = 10.0

    def __init__(self, path: str, mpp: Optional[float] = None):
        self.path = path
        self._mpp_manual = mpp
        self._loaded = False

        self.w: Optional[int] = None
        self.h: Optional[int] = None
        self.nlvl: Optional[int] = None
        self.ds: Optional[list[float]] = None
        self.dims: Optional[list[Tuple[int, int]]] = None
        self.meta: Optional[Dict[str, Any]] = None
        self.mpp: Optional[float] = None
        self.mag: Optional[int] = None

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._setup()
            self._loaded = True

    @abstractmethod
    def _setup(self) -> None:
        """Open the backing file and populate pyramid metadata."""

    @abstractmethod
    def extract(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        *,
        mode: Literal["array", "image"] = "array",
    ) -> Union[np.ndarray, "Image.Image"]:
        """Read a (w, h) RGB region whose top-left is at level-0 coords xy."""

    def extract_scaled(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        scale_denom: int,
    ) -> Optional[np.ndarray]:
        """Read a region decoded at 1/scale_denom, or None when unsupported.

        xy/wh in LEVEL coordinates; output is ceil(w/s) x ceil(h/s) x 3.
        Backends with cheap native downscaling (JPEG IDCT scaling in the TIFF
        decoder) override this; the base returns None so callers fall back to
        extract() + host resize.
        """
        return None

    @abstractmethod
    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        """(width, height) at a pyramid level."""

    @abstractmethod
    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        """RGB thumbnail bounded by max (width, height)."""

    @abstractmethod
    def cleanup(self) -> None:
        """Release resources."""

    # --- MPP / magnification -------------------------------------------------------
    @classmethod
    def validate_mpp(cls, mpp: float, *, source: str = "metadata") -> float:
        if mpp < cls.MPP_MIN or mpp > cls.MPP_MAX:
            raise ValueError(
                f"MPP value {mpp} from {source} is outside valid range "
                f"[{cls.MPP_MIN}, {cls.MPP_MAX}] µm/pixel. "
                f"This may indicate corrupted metadata or incorrect input. "
                f"If this value is intentional, please verify your data source."
            )
        return mpp

    def _infer_mag(self, m: float) -> int:
        """Objective power inferred from microns-per-pixel (reference: iwsi.py:360-384)."""
        thresholds = [
            (0.16, 80),
            (0.2, 60),
            (0.3, 40),
            (0.6, 20),
            (1.2, 10),
            (2.4, 5),
        ]
        for threshold, mag_val in thresholds:
            if m < threshold:
                return mag_val
        raise ValueError(f"Cannot infer magnification from mpp {m}")

    # --- metadata ------------------------------------------------------------------
    @staticmethod
    def _clean_meta_value(val: Any) -> str | None:
        if val is None:
            return None
        try:
            text = str(val).strip()
        except Exception:
            return None
        return text or None

    @classmethod
    def _find_meta_value(
        cls, meta: Mapping[str, Any], keys: Sequence[str], *, contains: Sequence[str] | None = None
    ) -> str | None:
        if not meta:
            return None
        normalized: dict[str, Any] = {}
        for key, value in meta.items():
            if value is None:
                continue
            lower = str(key).lower()
            if lower not in normalized:
                normalized[lower] = value
        for key in keys:
            text = cls._clean_meta_value(normalized.get(key.lower()))
            if text:
                return text
        if contains:
            for key in sorted(normalized):
                if any(token in key for token in contains):
                    text = cls._clean_meta_value(normalized[key])
                    if text:
                        return text
        return None

    def metadata_attrs(self) -> Dict[str, Any]:
        """Optional slide metadata stored as H5 file attrs (reference: iwsi.py:200-244)."""
        self._ensure_loaded()
        meta = self.meta or {}
        vendor = self._find_meta_value(
            meta,
            ["openslide.vendor", "tiff.make", "tiff.model", "hamamatsu.model", "leica.scanner"],
            contains=["vendor"],
        )
        institution = self._find_meta_value(
            meta,
            [
                "tiff.institution",
                "tiff.institutionname",
                "aperio.institution",
                "openslide.institution",
                "dicom.institutionname",
            ],
            contains=["institution"],
        )
        stain = self._find_meta_value(
            meta,
            [
                "aperio.stain",
                "aperio.staindescription",
                "openslide.stain",
                "hamamatsu.stain",
                "philips.stain",
            ],
            contains=["stain"],
        )

        attrs: Dict[str, Any] = {}
        if self.mpp is not None:
            attrs["mpp"] = self.mpp
        if self.mag is not None:
            attrs["magnification"] = int(self.mag)
        if vendor:
            attrs["vendor"] = vendor
        if institution:
            attrs["institution"] = institution
        if stain:
            attrs["stain"] = stain
        return attrs

    # --- pyramid geometry ----------------------------------------------------------
    def optimal_level(self, target_ds: float) -> Tuple[int, float]:
        """Best pyramid level for a target downsample (reference: iwsi.py:325-358).

        Returns (level, additional_downsample); an exact match within 0.01
        selects that level with no extra resampling. When the target sits
        between levels, the nearest level *above* full resolution is chosen so
        the extra factor is a downscale.
        """
        self._ensure_loaded()
        downsamples = self.ds or [1.0]

        for i, d in enumerate(downsamples):
            if abs(d - target_ds) < 0.01:
                return i, 1.0

        if target_ds >= downsamples[0]:
            best_i, best_d = 0, downsamples[0]
            for i, d in enumerate(downsamples):
                if d <= target_ds:
                    best_i, best_d = i, d
                else:
                    break
            return best_i, target_ds / best_d
        else:
            for i, d in enumerate(downsamples):
                if d >= target_ds:
                    return i, d / target_ds

        raise ValueError(f"No level for target downsample {target_ds}")

    def get_thumbnail_at_power(
        self,
        *,
        power: float = 1.25,
        interpolation: str = "optimise",
        scaled_decode: bool = False,
        quantize: int = 0,
        max_px: int = 0,
    ) -> "Image.Image":
        """Full-slide thumbnail at a fixed objective power (reference: iwsi.py:246-323).

        ds = base_mag / power selects the closest pyramid level; the level read
        is then resized to exactly round(W0/ds) x round(H0/ds) with AREA for
        downscale / CUBIC for upscale under the "optimise" policy.

        scaled_decode=True lets JPEG-backed pyramids decode the level directly
        at 1/2, 1/4 or 1/8 via IDCT scaling instead of full decode + AREA
        resize — ~5x fewer host cycles for the same thumbnail, at a few LSBs
        of drift vs the reference's exact decode+resize chain. Off by default;
        the segmentation service turns it on for non-float32 precisions where
        the numeric chain already departs from the reference.
        """
        self._ensure_loaded()

        if self.mag is None:
            raise ValueError(
                "WSI base magnification is unknown; cannot generate power-based thumbnail."
            )

        W0, H0 = self.get_size(lv=0)
        if W0 <= 0 or H0 <= 0:
            raise ValueError("Invalid WSI dimensions.")
        tgt_power = float(power)
        if tgt_power <= 0:
            raise ValueError("thumbnail power must be positive")

        ds_target = max(1e-6, float(self.mag) / tgt_power)
        level, _ = self.optimal_level(ds_target)
        downsamples = self.ds or [1.0]
        ds_lvl = float(downsamples[level])

        read_w = max(1, int(round(W0 / ds_lvl)))
        read_h = max(1, int(round(H0 / ds_lvl)))

        arr: Optional[np.ndarray] = None
        if scaled_decode:
            extra = ds_target / ds_lvl
            if extra >= 2.0:
                s = 8 if extra >= 8.0 else (4 if extra >= 4.0 else 2)
                arr = self.extract_scaled((0, 0), level, (read_w, read_h), s)
        if arr is None:
            arr_any = self.extract((0, 0), lv=level, wh=(read_w, read_h), mode="array")
            if not isinstance(arr_any, np.ndarray):
                raise RuntimeError("Failed to read thumbnail region as array")
            arr = arr_any

        out_w = max(1, int(round(W0 / ds_target)))
        out_h = max(1, int(round(H0 / ds_target)))

        # Static-shape serving support: fold the size cap into the single
        # resize and snap dims to multiples of `quantize`, so per-slide
        # thumbnails land in a handful of shape buckets instead of a unique
        # (h, w) each — under jit every distinct shape is a fresh multi-minute
        # SAM2 compile. Off (0/0) preserves the reference-exact chain.
        if max_px and (out_w > max_px or out_h > max_px):
            scale = min(max_px / out_w, max_px / out_h)
            out_w = max(1, int(out_w * scale))
            out_h = max(1, int(out_h * scale))
        if quantize > 0:

            def _snap(v: int) -> int:
                snapped = max(quantize, int(round(v / quantize)) * quantize)
                if max_px and snapped > max_px:
                    # never exceed the caller's bound (it sizes memory and
                    # compile shapes); floor to the largest multiple within
                    snapped = max(quantize, (max_px // quantize) * quantize)
                    snapped = min(snapped, max_px)
                return snapped

            out_w = _snap(out_w)
            out_h = _snap(out_h)

        if arr.shape[1] != out_w or arr.shape[0] != out_h:
            if interpolation == "optimise":
                interp = "area" if (out_w < arr.shape[1] or out_h < arr.shape[0]) else "cubic"
            else:
                interp = interpolation
            arr = _resize_rgb(arr, (out_w, out_h), interp)

        from PIL import Image

        return Image.fromarray(arr)

    # --- context manager / repr ------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.cleanup()

    def __repr__(self) -> str:
        if self._loaded:
            return f"<{self.__class__.__name__}: {self.w}x{self.h}>"
        return f"<{self.__class__.__name__}: loading pending>"
