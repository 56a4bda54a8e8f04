"""Pyramidal slide backend on the native TIFF/SVS decoder.

Replaces the reference's OpenSlide backend (reference:
atlas_patch/core/wsi/openslide_wsi.py:15-245) with the first-party C++
decoder (csrc/atlas_tiff.cc through io/native.py). The 4-tier MPP
extraction ladder is reproduced over our property naming:

  1. direct keys (aperio.MPP, user-provided)
  2. regex over free-text (tiff.ImageDescription), incl. OME-XML
     PhysicalSizeX[Unit] for OME-TIFFs
  3. TIFF resolution tags (XResolution + ResolutionUnit)
  4. 10 / magnification (aperio.AppMag)
"""

from __future__ import annotations

import re
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
from atlaspatch_tpu_torch.io.iwsi import IWSI


class TiffWSI(IWSI):
    """Native pyramid backend for .svs/.tif/.tiff and compatible containers."""

    _MPP_KEYS = (
        "aperio.MPP",
        "atlas.mpp",
        "hamamatsu.XResolution",
        "ventana.ScanRes",  # iScan µm/pixel (openslide.org/formats/ventana)
        "philips.PixelSpacing",  # DICOM_PIXEL_SPACING converted to µm
    )
    _MPP_TEXT_KEYS = ("tiff.ImageDescription",)
    _MAG_KEYS = (
        "aperio.AppMag",
        "atlas.objective-power",
        "hamamatsu.SourceLens",
        "leica.objective",
        "ventana.Magnification",
        "trestle.Objective Power",  # openslide.org/formats/trestle
    )

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._tiff = None

    def _setup(self) -> None:
        from atlaspatch_tpu_torch.io.native import AtlasTiffFile

        try:
            self._tiff = AtlasTiffFile(self.path)
        except FileNotFoundError as e:
            raise FileNotFoundError(f"File not found: {self.path}") from e
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(f"atlas_tiff error: {e}") from e

        self.w, self.h = self._tiff.dimensions
        self.nlvl = self._tiff.level_count
        self.ds = list(self._tiff.level_downsamples)
        self.dims = list(self._tiff.level_dimensions)
        self.meta = dict(self._tiff.properties)

        if self._mpp_manual is not None:
            self.mpp = self.validate_mpp(self._mpp_manual, source="user-provided mpp")
        else:
            extracted = self._extract_mpp()
            self.mpp = (
                self.validate_mpp(extracted, source="slide metadata")
                if extracted is not None
                else None
            )
        self.mag = self._extract_mag()

    # --- MPP ladder ----------------------------------------------------------------
    def _plausible(self, mpp: float) -> Optional[float]:
        """Round + range-gate one ladder candidate. An implausible value
        (e.g. 352.8 µm from generic 72-dpi resolution tags on a re-saved
        TIFF) means 'this tier is not really an MPP' — fall through to the
        next tier instead of poisoning the open. OpenSlide never emits MPP
        from bare resolution tags, so gating our extra tier is strictly
        parity-improving."""
        v = round(float(mpp), 4)
        return v if self.MPP_MIN <= v <= self.MPP_MAX else None

    def _extract_mpp(self) -> Optional[float]:
        meta = self.meta or {}
        for key in self._MPP_KEYS:
            if key in meta:
                try:
                    v = self._plausible(float(meta[key]))
                except (ValueError, TypeError):
                    continue
                if v is not None:
                    return v
        for key in self._MPP_TEXT_KEYS:
            parsed = self._parse_mpp_from_string(meta.get(key))
            if parsed is None:
                parsed = self._parse_ome_physical_size(meta.get(key))
            if parsed is not None:
                v = self._plausible(parsed)
                if v is not None:
                    return v
        try:
            x_res = meta.get("tiff.XResolution")
            unit = meta.get("tiff.ResolutionUnit")
            if x_res and unit:
                x_res_f = float(x_res)
                v = None
                if str(unit).lower() == "centimeter":
                    v = self._plausible(10000 / x_res_f)
                elif str(unit).lower() == "inch":
                    v = self._plausible(25400 / x_res_f)
                if v is not None:
                    return v
        except (ValueError, TypeError, ZeroDivisionError):
            pass
        for mag_key in self._MAG_KEYS:
            mag_val = meta.get(mag_key)
            if mag_val is not None:
                try:
                    mag = float(mag_val)
                except (ValueError, TypeError):
                    continue
                if mag > 0:
                    v = self._plausible(10.0 / mag)
                    if v is not None:
                        return v
        return None

    def _extract_mag(self) -> Optional[int]:
        meta = self.meta or {}
        for key in self._MAG_KEYS:
            val = meta.get(key)
            if val:
                try:
                    return int(float(val))
                except (ValueError, TypeError):
                    continue
        for key in self._MPP_TEXT_KEYS:
            mag = self._parse_ome_nominal_mag(meta.get(key))
            if mag is not None and mag > 0:
                return int(mag)
        if self.mpp is not None:
            try:
                return self._infer_mag(self.mpp)
            except ValueError:
                pass
        return None

    @staticmethod
    def _parse_mpp_from_string(val: Optional[str]) -> Optional[float]:
        if not val:
            return None
        patterns = (
            r"mpp\s*[:=]\s*([0-9]*\.?[0-9]+)",
            r"microns?\s+per\s+pixel[^0-9]*([0-9]*\.?[0-9]+)",
        )
        for pattern in patterns:
            match = re.search(pattern, val, flags=re.IGNORECASE)
            if match:
                try:
                    return float(match.group(1))
                except ValueError:
                    continue
        return None

    # --- OME-XML (OME-TIFF ImageDescription) ---------------------------------
    @staticmethod
    def _parse_ome_physical_size(val: Optional[str]) -> Optional[float]:
        """PhysicalSizeX from an OME-XML Pixels element, normalized to µm.
        OpenSlide's generic driver ignores OME metadata entirely, so this tier
        strictly widens coverage (OME-TIFFs rarely carry resolution tags)."""
        if not val or "<OME" not in val:
            return None
        m = re.search(r'PhysicalSizeX\s*=\s*["\']([0-9.eE+\-]+)["\']', val)
        if not m:
            return None
        try:
            v = float(m.group(1))
        except ValueError:
            return None
        mu = re.search(r'PhysicalSizeXUnit\s*=\s*["\']([^"\']+)["\']', val)
        unit = mu.group(1) if mu else "µm"  # OME default unit is µm
        scale = {"nm": 1e-3, "µm": 1.0, "um": 1.0, "μm": 1.0, "mm": 1e3, "cm": 1e4}.get(unit)
        return v * scale if scale is not None else None

    @staticmethod
    def _parse_ome_nominal_mag(val: Optional[str]) -> Optional[float]:
        if not val or "<OME" not in val:
            return None
        m = re.search(r'NominalMagnification\s*=\s*["\']([0-9.eE+\-]+)["\']', val)
        if not m:
            return None
        try:
            return float(m.group(1))
        except ValueError:
            return None

    # --- pixel access ---------------------------------------------------------------
    def extract(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        *,
        mode: Literal["array", "image"] = "array",
    ) -> Union[np.ndarray, "Image.Image"]:
        """Read a region; xy in LEVEL-0 coordinates (OpenSlide convention)."""
        self._ensure_loaded()
        assert self._tiff is not None
        if lv < 0 or lv >= (self.nlvl or 0):
            raise IndexError(f"Level {lv} out of range")
        ds = (self.ds or [1.0])[lv]
        x = int(xy[0] / ds)
        y = int(xy[1] / ds)
        arr = self._tiff.read_region_level(lv, x, y, int(wh[0]), int(wh[1]))
        if mode == "image":
            from PIL import Image

            return Image.fromarray(arr)
        if mode == "array":
            return arr
        raise ValueError(f"Invalid mode: {mode}")

    def extract_scaled(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        scale_denom: int,
    ) -> Optional[np.ndarray]:
        """Native scaled read (libjpeg IDCT downscaling); None ⇒ unsupported.

        xy is in LEVEL coordinates here (thumbnail path reads whole levels).
        """
        self._ensure_loaded()
        assert self._tiff is not None
        if lv < 0 or lv >= (self.nlvl or 0):
            raise IndexError(f"Level {lv} out of range")
        return self._tiff.read_region_level_scaled(
            lv, int(xy[0]), int(xy[1]), int(wh[0]), int(wh[1]), int(scale_denom)
        )

    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        self._ensure_loaded()
        if self.dims is None or lv < 0 or lv >= len(self.dims):
            raise IndexError(f"Level {lv} out of range")
        return self.dims[lv]

    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        self._ensure_loaded()
        assert self._tiff is not None
        lw, lh = self.dims[-1]
        # Corrupt headers can declare absurd dims that survive the native
        # plausibility checks (single-chunk whole-image JPEGs are exempt from
        # the chunk-coverage test); refuse the whole-level read cleanly
        # rather than allocating gigabytes. Real slides' deepest levels are
        # orders of magnitude below this.
        if lw * lh > 2**31:
            raise RuntimeError(
                f"thumbnail source level {lw}x{lh} exceeds the safety cap "
                "(corrupt header?)"
            )
        arr = self._tiff.read_region_level(self.nlvl - 1, 0, 0, lw, lh)
        from PIL import Image

        img = Image.fromarray(arr)
        img.thumbnail(max_hw, Image.Resampling.LANCZOS)
        return img.convert("RGB")

    def cleanup(self) -> None:
        if self._tiff is not None:
            try:
                self._tiff.close()
            except Exception:
                pass
            finally:
                self._tiff = None
        self._loaded = False

    def __del__(self) -> None:
        self.cleanup()
